"""Multi-scale matching: depth-histogram proposals and scaled templates.

Port of the JAX package's ``models/multiscale.py``.  The reference's final
multi-scale design (linemodLevelup/notes.md:44-63) finds about 5 candidate
depths with a histogram and 1-D NMS, scales the template features once per
depth, and matches each scaled set; its test programs load one template
file per radius (test.cpp:116, 178).  Here one frame is, on the device of
the frame,

    response pyramid -> depth proposals (``ops/scale_proposal.py``)
    -> coarse scoring of every (scale, template) pair at once
       (``coarse_sweep``: shift-bucketed matmuls over weights built per
       frame by a scatter-add) -> top-K over (scale, template, y, x)
    -> local refinement of every candidate with its own scale, one
       local-refine kernel launch per level (``pyramid_refine``)
    -> sort and box NMS

for every class of a bank in one pass (``multiscale_multiclass_core``:
per-class candidate selection over a padded index map, all C * K
candidates refined together, per-class NMS), driven for one class at a
time by ``MultiScaleDetector`` and for a whole bank by
``MultiScaleMultiClass``.  Nothing between the image upload and ``match``'s
one readback waits for the device.

The JAX package can also select the coarse weights from tables prebuilt
per depth bin while they fit a byte budget, which saves its TPU a scatter
build per frame.  On the H100 the per-frame scatter build was faster than
the table selection at one class and at fifteen (``PERF.md``), so the port
builds per frame only and its matchers take no ``table_budget_bytes``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.convert import MultiScaleBank, multiscale_arrays, multiscale_bank_from_arrays
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.models.detector import Detector, Match, _build_response_pyramid, _image, _offset, pyramid_refine
from sixdpose_tpu_torch.ops.scale_proposal import bin_centers, propose_depth_bins
from sixdpose_tpu_torch.ops.similarity import score_normalize, similarity_multiscale_matmul
from sixdpose_tpu_torch.ops.topk_nms import nms_boxes, topk_candidates
from sixdpose_tpu_torch.utils.timing import frame_entry, span, stage


@dataclasses.dataclass
class ScaleMatch(Match):
    """A detection with its proposed depth and applied template scale."""

    depth_mm: float = 0.0
    scale: float = 1.0


@stage("proposals")
def proposals(depth, bin_scales: torch.Tensor, num_scales: int, bins: Tuple[int, int, int]):
    """Depth proposals of one frame: (bin_idx (S,) int32, depths (S,)
    float32, valid (S,) bool, scales (S,) float32 = the bin's scale, 0 where
    no valid peak).  ``bins`` is (bin_mm, lo_mm, hi_mm)."""
    bin_mm, lo_mm, hi_mm = bins
    bin_idx, depths, counts = propose_depth_bins(depth, num_scales, bin_mm, lo_mm, hi_mm)
    valid = counts > 0
    scales = torch.where(valid, bin_scales[bin_idx.to(torch.int64)], torch.zeros_like(depths))
    return bin_idx, depths, valid, scales


def coarse_sweep(maps_c, bank: MultiScaleBank, t_c: int, valid, scales):
    """Normalized coarse scores of every (scale, template) pair, (S * N,
    Ho, Wo), row s * N + n; -1 for templates without an in-extent feature
    and for empty proposals (``similarity_multiscale_matmul`` with weights
    built for this frame's scales)."""
    kh_c, kw_c = bank.kdims[-1]
    raw, nfeat = similarity_multiscale_matmul(maps_c, bank.feats[-1], bank.valids[-1], scales, t_c, kh_c, kw_c)
    scores = score_normalize(raw, nfeat.clamp(min=1))
    n = bank.feats[-1].shape[0]
    ok = (nfeat > 0) & valid[:, None].expand(valid.shape[0], n).reshape(-1)
    return torch.where(ok[:, None, None], scores, -1.0)


def _boxes(x, y, wh0):
    return torch.stack([x.to(torch.float32), y.to(torch.float32), wh0[..., 0], wh0[..., 1]], dim=-1)


def multiscale_multiclass_core(
    rgb: Optional[torch.Tensor],
    depth: torch.Tensor,
    bank: MultiScaleBank,
    bin_scales: torch.Tensor,
    cfg: DetectorConfig,
    threshold: float,
    num_scales: int,
    top_k: int,
    apply_nms: bool = True,
    bins: Tuple[int, int, int] = (100, 400, 2000),
):
    """Multi-scale detection of every class of a bank in one frame.

    The whole (class x scale x template) sweep is one coarse scoring over
    the superbank's templates.  Its shift-sum grid covers the anchors where
    the largest class's window fits; the coarse maps are zero-padded
    bottom/right by ``bank.pad_kb`` blocks so that every class's own anchors
    are covered (zero responses add nothing), and each class is masked back
    to its own anchor range (``bank.cls_kb`` against the unpadded block
    counts): the result of a ``MultiScaleDetector`` per class, from one
    sweep.  Candidates are selected per class over (scale, template)
    through the (C, Nmax) pad map, all C * K refine together (one kernel
    launch per level), and each class is sorted and NMS-ed on its own.

    Args:
      rgb: (H, W, 3) uint8 or None; depth: (H, W) int32 mm (proposals need
        it whether or not the depth modality is on).
      bank: the classes' ``MultiScaleBank``; bin_scales: (NB,) float32
        feature scale of each depth bin (train_depth / bin centre).
      top_k: candidates per class.
      bins: (bin_mm, lo_mm, hi_mm) of the depth histogram.

    Returns (tid_local, x, y, score, keep, depth_mm, scale), each (C, K):
    tid_local is the template's index within its class.
    """
    t_c = cfg.t_at_level[-1]
    n = bank.feats[0].shape[0]
    c_n, nmax = bank.pad_map.shape
    pyramid = [p[0] for p in _build_response_pyramid(rgb[None] if rgb is not None else None, depth[None], cfg)]
    _, depths, valid, scales = proposals(depth, bin_scales, num_scales, bins)
    s = scales.shape[0]
    pb, qb = bank.pad_kb
    with span("coarse"):
        scores = coarse_sweep(F.pad(pyramid[-1], (0, qb * t_c, 0, pb * t_c)), bank, t_c, valid, scales)

        # Each class's rows across every scale, at (C, S * Nmax); pad rows and
        # anchors outside the class's own range score -1.
        pm = bank.pad_map.clamp(min=0).long()
        ids = (torch.arange(s, device=pm.device)[None, :, None] * n + pm[:, None, :]).reshape(c_n, s * nmax)
        cls_scores = scores[ids]  # (C, S * Nmax, Hb, Wb)
        pad_ok = (bank.pad_map >= 0).repeat(1, s)
        hb0 = -(-pyramid[-1].shape[-2] // t_c)
        wb0 = -(-pyramid[-1].shape[-1] // t_c)
        yi_g = torch.arange(cls_scores.shape[2], device=pm.device)[None, :, None]
        xi_g = torch.arange(cls_scores.shape[3], device=pm.device)[None, None, :]
        in_range = (yi_g <= hb0 - bank.cls_kb[:, 0, None, None]) & (xi_g <= wb0 - bank.cls_kb[:, 1, None, None])
        cls_scores = torch.where(pad_ok[:, :, None, None] & in_range[:, None], cls_scores, -1.0)
    with span("topk"):
        tid_sc, yi, xi, score = topk_candidates(cls_scores, threshold, top_k)  # each (C, K)
        x = xi * t_c + _offset(t_c)
        y = yi * t_c + _offset(t_c)
        scale_idx = tid_sc // nmax
        tid_l = tid_sc % nmax
        gid = torch.gather(pm, 1, tid_l.long())
        cand_scale = scales[scale_idx.long()]

    # All C * K candidates refine together, by global template id.
    _, x, y, score = pyramid_refine(
        pyramid, None, None, bank.whs, bank.feats, bank.valids, tuple(cfg.t_at_level), threshold,
        gid.reshape(-1), x.reshape(-1), y.reshape(-1), score.reshape(-1), scale=cand_scale.reshape(-1),
    )
    x, y, score = (a.reshape(c_n, top_k) for a in (x, y, score))

    with span("nms"):
        order = torch.argsort(-score, dim=1, stable=True)
        tid_l, scale_idx, x, y, score, cand_scale = (
            torch.gather(a, 1, order) for a in (tid_l, scale_idx, x, y, score, cand_scale)
        )
        if apply_nms:
            gid = torch.gather(pm, 1, tid_l.long())
            wh0 = torch.round(bank.whs[0][gid].to(torch.float32) * cand_scale[..., None])
            keep = nms_boxes(_boxes(x, y, wh0), score, cfg.nms_iou)
        else:
            keep = score >= 0
        return tid_l, x, y, score, keep, depths[scale_idx.long()], cand_scale


@stage("readback")
def _readback(arrays) -> np.ndarray:
    """The seven results in one device-to-host copy (int32, float32 and bool
    are exact in float64)."""
    return torch.stack([a.to(torch.float64) for a in arrays]).cpu().numpy()


class _Bins:
    """The depth bins and their scales for a bank trained at ``train_depth``."""

    def __init__(self, train_depth: float, num_scales: int, bin_mm: int, lo_mm: int, hi_mm: int, device):
        self.device = resolve_device(device)
        self.train_depth = float(train_depth)
        self.num_scales = num_scales
        self.bins = (bin_mm, lo_mm, hi_mm)
        self.bin_scales_np = (train_depth / bin_centers(bin_mm, lo_mm, hi_mm)).astype(np.float32)
        self.max_scale = float(self.bin_scales_np.max())
        self.bin_scales = torch.from_numpy(self.bin_scales_np).to(self.device)

    @stage("upload")
    def images(self, rgb, depth):
        return _image(rgb, torch.uint8, self.device), _image(depth, torch.int32, self.device)


class MultiScaleDetector(_Bins):
    """Depth-histogram multi-scale matching of one class at a time over a
    single-radius bank: a trained ``Detector`` whose templates were
    extracted at ``train_depth`` mm, matched at histogram-proposed depths.
    Each class's arrays are built at its first request and kept; a frame is
    ``multiscale_multiclass_core`` over that one class.

    Runs on ``device``: CUDA by default, raising when there is none; pass
    ``device="cpu"`` for the CPU.
    """

    def __init__(self, detector: Detector, train_depth: float, num_scales: int = 5, bin_mm: int = 100,
                 lo_mm: int = 400, hi_mm: int = 2000, device=None):
        super().__init__(train_depth, num_scales, bin_mm, lo_mm, hi_mm, device)
        self.det = detector
        self.cfg = detector.cfg
        self._banks: Dict[str, MultiScaleBank] = {}

    def class_bank(self, class_id: str) -> MultiScaleBank:
        """The class's ``MultiScaleBank``, built at first use."""
        if class_id not in self._banks:
            a = multiscale_arrays([self.det.bank.templates[class_id]], self.max_scale, self.cfg.t_at_level[-1])
            self._banks[class_id] = multiscale_bank_from_arrays(a, self.device)
        return self._banks[class_id]

    def match_arrays(self, rgb, depth, threshold: float, class_id: str, apply_nms: bool = True):
        """Device tensors (tid, x, y, score, keep, depth_mm, scale), each
        (K,); nothing waits for the device."""
        rgb_t, depth_t = self.images(rgb, depth)
        out = multiscale_multiclass_core(rgb_t, depth_t, self.class_bank(class_id), self.bin_scales, self.cfg,
                                         float(threshold), self.num_scales, self.cfg.top_k, apply_nms, self.bins)
        return tuple(a[0] for a in out)

    @frame_entry
    def match(self, rgb, depth, threshold: float, class_id: str, apply_nms: bool = True) -> List[ScaleMatch]:
        """Matches of one class above ``threshold``, best first; one
        readback."""
        tid, x, y, score, keep, depths, scales = _readback(self.match_arrays(rgb, depth, threshold, class_id, apply_nms))
        out = [
            ScaleMatch(x=int(x[i]), y=int(y[i]), similarity=float(score[i]), class_id=class_id,
                       template_id=int(tid[i]), depth_mm=float(depths[i]), scale=float(scales[i]))
            for i in range(len(score)) if keep[i] and score[i] >= 0
        ]
        out.sort(key=lambda m: -m.similarity)
        return out


class MultiScaleMultiClass(_Bins):
    """Multi-scale matching of every class of a bank in one pass and one
    readback.  The classes' feature arrays are one superbank
    (``MultiScaleBank``).

    Runs on ``device``: CUDA by default, raising when there is none; pass
    ``device="cpu"`` for the CPU.
    """

    def __init__(self, detector: Detector, train_depth: float, class_ids: Optional[Sequence[str]] = None,
                 num_scales: int = 5, bin_mm: int = 100, lo_mm: int = 400, hi_mm: int = 2000, device=None):
        super().__init__(train_depth, num_scales, bin_mm, lo_mm, hi_mm, device)
        self.det = detector
        self.cfg = detector.cfg
        self.class_ids = list(class_ids or detector.class_ids())
        if not self.class_ids:
            raise ValueError("no classes in bank")
        per_class = [detector.bank.templates[c] for c in self.class_ids]
        self.bank = multiscale_bank_from_arrays(multiscale_arrays(per_class, self.max_scale, self.cfg.t_at_level[-1]),
                                                self.device)

    def match_arrays(self, rgb, depth, threshold: float, apply_nms: bool = True):
        """Device tensors (tid_local, x, y, score, keep, depth_mm, scale),
        each (C, K), rows in ``class_ids`` order; nothing waits for the
        device."""
        rgb_t, depth_t = self.images(rgb, depth)
        return multiscale_multiclass_core(rgb_t, depth_t, self.bank, self.bin_scales, self.cfg, float(threshold),
                                          self.num_scales, self.cfg.top_k, apply_nms, self.bins)

    @frame_entry
    def match(self, rgb, depth, threshold: float, apply_nms: bool = True) -> List[ScaleMatch]:
        """Matches of every class above ``threshold``, best first; one
        readback."""
        tid, x, y, score, keep, depths, scales = _readback(self.match_arrays(rgb, depth, threshold, apply_nms))
        res = [
            ScaleMatch(x=int(x[ci, i]), y=int(y[ci, i]), similarity=float(score[ci, i]), class_id=cid,
                       template_id=int(tid[ci, i]), depth_mm=float(depths[ci, i]), scale=float(scales[ci, i]))
            for ci, cid in enumerate(self.class_ids) for i in range(tid.shape[1])
            if keep[ci, i] and score[ci, i] >= 0
        ]
        res.sort(key=lambda m: -m.similarity)
        return res
