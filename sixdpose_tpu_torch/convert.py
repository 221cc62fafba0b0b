"""The device banks: a class's match-time and refine-time arrays as tensors.

``bank_levels_from_numpy`` takes the fields of a per-level bank
(``kernels``, ``nfeat``, ``wh``, ``feats``, ``valid``, as numpy arrays) and
moves them to a device.  Both packages' ``BankLevel`` carry those fields
with the same layouts and dtypes, and both read and write the same npz
(``TemplateBank.save`` / ``load``, the templates' ``infos`` included), so a
bank built by either feeds the other.  ``refine_bank_from_numpy`` does the
same for the six arrays of a ``RefineBank``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DeviceBank:
    """Per pyramid level (level 0 first) device tensors of one class.

    kernels: (N, C, KH, KW) int8 one-hot conv kernels.
    nfeats:  (N,) int32 feature counts.
    whs:     (N, 2) int32 template (width, height).
    feats:   (N, F, 3) int32 padded (x, y, channel) feature lists.
    valids:  (N, F) bool.
    """

    kernels: Tuple[torch.Tensor, ...]
    nfeats: Tuple[torch.Tensor, ...]
    whs: Tuple[torch.Tensor, ...]
    feats: Tuple[torch.Tensor, ...]
    valids: Tuple[torch.Tensor, ...]


def _to(a, dtype: np.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a), dtype=dtype)).to(device)


def bank_levels_from_numpy(levels: Sequence, device) -> DeviceBank:
    """Device bank from per-level objects with numpy fields ``kernels``,
    ``nfeat``, ``wh``, ``feats`` and ``valid`` (a ``BankLevel`` of either
    package)."""
    return DeviceBank(
        kernels=tuple(_to(b.kernels, np.int8, device) for b in levels),
        nfeats=tuple(_to(b.nfeat, np.int32, device) for b in levels),
        whs=tuple(_to(b.wh, np.int32, device) for b in levels),
        feats=tuple(_to(b.feats, np.int32, device) for b in levels),
        valids=tuple(_to(b.valid, np.bool_, device) for b in levels),
    )


@dataclasses.dataclass(frozen=True)
class RefineBank:
    """Per-class device tensors of the fused refine stage
    (``models/pipeline.py``).

    clouds:  (N, P, 3) float32 template clouds (meters, render frame).
    valids:  (N, P) bool.
    chroma:  (N, P, 2) float32 lighting-normalized chroma, or None.
    src_c:   (N, 3) float32 cloud centroids.
    bbox_wh: (N, 2) int32 render bbox (w, h) at level 0.
    base_T:  (N, 4, 4) float32 template pose (cam_R_w2c | cam_t_w2c with
      the reference's z mm->m quirk, linemodLevelup.cpp:37).
    win:     (win_h, win_w) median window covering the largest bbox.
    """

    clouds: torch.Tensor
    valids: torch.Tensor
    chroma: Optional[torch.Tensor]
    src_c: torch.Tensor
    bbox_wh: torch.Tensor
    base_T: torch.Tensor
    win: Tuple[int, int]


def refine_bank_from_numpy(fields: Sequence, win: Tuple[int, int], device) -> RefineBank:
    """The refine bank on ``device`` from its six arrays as numpy, in the
    order of both packages' ``RefineBank`` fields: (clouds, valids, chroma
    or None, src_c, bbox_wh, base_T)."""
    clouds, valids, chroma, src_c, bbox_wh, base_T = fields
    return RefineBank(
        clouds=_to(clouds, np.float32, device),
        valids=_to(valids, np.bool_, device),
        chroma=_to(chroma, np.float32, device) if chroma is not None else None,
        src_c=_to(src_c, np.float32, device),
        bbox_wh=_to(bbox_wh, np.int32, device),
        base_T=_to(base_T, np.float32, device),
        win=(int(win[0]), int(win[1])),
    )
