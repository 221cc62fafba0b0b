"""Multi-class matching in one pass over every class.

Port of the JAX package's ``models/multiclass.py``.  The reference scores
every class inside one ``match()`` call but loops over the classes on the
CPU (linemodLevelup.cpp:1753-1769).  Here the classes' banks are one padded
superbank (``convert.multiclass_bank_from_numpy``), so a frame is

    response pyramid -> one coarse scoring of every template of every class
    -> per-class top-K (a leading class dimension over a (C, Nmax) padded
    index map) -> refinement of all C * K candidates together down the
    pyramid (one local-refine kernel launch per level) -> per-class sort
    and box NMS

on the device of the frame, and ``MultiClassMatcher.match`` reads the
result back once.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from sixdpose_tpu_torch.convert import DeviceBank, multiclass_bank_from_numpy
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.models.detector import (
    Detector,
    Match,
    _offset,
    coarse_scores,
    frame_response_pyramid,
    pyramid_refine,
)
from sixdpose_tpu_torch.ops.topk_nms import nms_boxes, topk_candidates
from sixdpose_tpu_torch.utils.timing import frame_entry, span


def match_multiclass_core(
    response_pyramid,
    bank: DeviceBank,
    pad_map: torch.Tensor,
    t_at_level: Tuple[int, ...],
    threshold: float,
    top_k: int,
    nms_iou: float,
    apply_nms: bool = True,
):
    """Score every class of one frame; per-class top-K, refinement and NMS.

    Args:
      response_pyramid: per level (C_maps, H_l, W_l) uint8 response maps of
        one frame.
      bank: the superbank (global template ids), with or without feature
        lists (``pyramid_refine``'s two routes); pad_map: (C, Nmax) int32
        global id of each class's local template, -1 = pad.
      apply_nms: per-class box NMS (else keep = score >= 0).  Matches of
        different classes never suppress each other.

    Returns (tid_local, x, y, score, keep), each (C, K): tid_local is the
    template index within its class; each class's row is sorted by score,
    descending, -1 on dead slots.
    """
    t_c = t_at_level[-1]
    with span("coarse"):
        scores = coarse_scores(response_pyramid, bank.kernels, bank.nfeats, t_at_level, bank.feats, bank.valids)
        # Each class's templates at its own row of a (C, Nmax) grid; pad rows
        # score -1 and never pass the threshold.
        safe = pad_map.clamp(min=0).long()
        padded = torch.where((pad_map >= 0)[:, :, None, None], scores[safe], -1.0)
    with span("topk"):
        tid_l, yi, xi, score = topk_candidates(padded, threshold, top_k)  # each (C, K)
        c_n = pad_map.shape[0]
        x = xi * t_c + _offset(t_c)
        y = yi * t_c + _offset(t_c)
        gid = torch.gather(safe, 1, tid_l.long())

    # All C * K candidates refine together, by global template id.
    _, x, y, score = pyramid_refine(
        response_pyramid, bank.kernels, bank.nfeats, bank.whs, bank.feats, bank.valids, t_at_level, threshold,
        gid.reshape(-1), x.reshape(-1), y.reshape(-1), score.reshape(-1),
    )
    x, y, score = (a.reshape(c_n, top_k) for a in (x, y, score))

    with span("nms"):
        order = torch.argsort(-score, dim=1, stable=True)
        tid_l, gid, x, y, score = (torch.gather(a, 1, order) for a in (tid_l, gid, x, y, score))
        if apply_nms:
            wh0 = bank.whs[0][gid]
            boxes = torch.stack([x, y, wh0[..., 0], wh0[..., 1]], dim=-1).to(torch.float32)
            keep = nms_boxes(boxes, score, nms_iou)
        else:
            keep = score >= 0
    return tid_l, x, y, score, keep


class MultiClassMatcher:
    """Matching over every class of a detector's bank in one pass and one
    readback.

    The classes' banks are uploaded once, here, as one superbank.  Runs on
    ``device``: CUDA by default, raising when there is none; pass
    ``device="cpu"`` for the CPU.
    """

    def __init__(self, detector: Detector, class_ids: Optional[Sequence[str]] = None, device=None):
        self.device = resolve_device(device)
        self.det = detector
        self.cfg = detector.cfg
        self.class_ids = list(class_ids or detector.class_ids())
        if not self.class_ids:
            raise ValueError("no classes in bank")
        mc = multiclass_bank_from_numpy([detector.bank.finalized(c) for c in self.class_ids], self.device)
        self.bank, self.pad_map, self.nmax = mc.bank, mc.pad_map, mc.nmax

    def response_pyramid(self, rgb, depth) -> List[torch.Tensor]:
        """Per-level (C_maps, H_l, W_l) response maps of one frame, on the
        matcher's device."""
        return frame_response_pyramid(rgb, depth, self.cfg, self.device)

    def match_arrays(self, rgb, depth, threshold: float):
        """Returns device tensors (tid_local, x, y, score, keep), each (C,
        K), rows in ``class_ids`` order; nothing waits for the device."""
        return match_multiclass_core(
            self.response_pyramid(rgb, depth), self.bank, self.pad_map, tuple(self.cfg.t_at_level),
            float(threshold), self.cfg.top_k, self.cfg.nms_iou,
        )

    @frame_entry
    def match(self, rgb, depth, threshold: float) -> List[Match]:
        """The reference ``Detector::match`` over every class (cpp:1753-1769
        scores the classes inside one call), plus the box NMS of its test
        script.  One readback: the five (C, K) results travel to the host
        as one float64 tensor (int32 and float32 are exact in it)."""
        arrays = self.match_arrays(rgb, depth, threshold)
        with span("readback"):
            out = torch.stack([a.to(torch.float64) for a in arrays]).cpu().numpy()
        tid, x, y, score, keep = out
        matches: List[Match] = []
        for ci, cid in enumerate(self.class_ids):
            for i in range(tid.shape[1]):
                if keep[ci, i] and score[ci, i] >= 0:
                    matches.append(Match(x=int(x[ci, i]), y=int(y[ci, i]), similarity=float(score[ci, i]),
                                         class_id=cid, template_id=int(tid[ci, i])))
        matches.sort(key=lambda m: -m.similarity)
        return matches
