"""The device bank: a class's per-level match-time arrays as tensors.

``bank_levels_from_numpy`` takes the fields of a per-level bank
(``kernels``, ``nfeat``, ``wh``, ``feats``, ``valid``, as numpy arrays) and
moves them to a device.  Both packages' ``BankLevel`` carry those fields
with the same layouts and dtypes, and both read and write the same npz
(``TemplateBank.save`` / ``load``), so a bank built by either feeds the
other.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

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
