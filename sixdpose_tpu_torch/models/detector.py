"""Template-matching detector: pyramid match orchestration.

Port of the JAX package's ``models/detector.py`` (reference ``Detector``,
linemodLevelup.cpp:1663-2010):

- quantize each modality per pyramid level, spread, build response maps;
- score every template of a class at every stride-T placement of the
  coarsest level (``coarse_scores``): by the feature-list scorer for a
  bank with feature lists, by one dense correlation for a bank of kernels;
- keep a fixed top-K above the threshold (cpp:1836-1852) and re-score each
  candidate over a 16x16 placement window on the way down the pyramid
  (cpp:1854-1938) with the local-refine kernel;
- dedupe with score-sorted box NMS.

Reported (x, y) is the placement times T plus the T/2 centering offset
(cpp:1845-1847); score = 100 * raw / (4 * nfeat) (cpp:1841).

Every step runs on the device of its inputs and takes a leading batch of
frames.  Nothing between the image upload and ``Detector.match``'s final
readback waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.convert import DeviceBank, bank_levels_from_numpy
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.models.templates import TemplateBank
from sixdpose_tpu_torch.ops import quantize as Q
from sixdpose_tpu_torch.ops.response_pyramid import response_pyramid_cuda
from sixdpose_tpu_torch.ops.similarity import (
    score_normalize,
    similarity_dense,
    similarity_local,
    similarity_local_sparse_auto,
    similarity_multiscale_auto,
)
from sixdpose_tpu_torch.ops.spread import compute_response_maps, spread_orientations
from sixdpose_tpu_torch.ops.topk_nms import nms_boxes, topk_candidates
from sixdpose_tpu_torch.utils.timing import frame_entry, span, stage

@dataclasses.dataclass
class Match:
    """A detection (reference Match struct, linemodLevelup.h:225-253)."""

    x: int
    y: int
    similarity: float
    class_id: str
    template_id: int


def _offset(t: int) -> int:
    """Reported-coordinate centering: T/2 + (T%2 - 1)  (cpp:1845)."""
    return t // 2 + (t % 2 - 1)


def coarse_scores(response_pyramid, bank: DeviceBank, t_at_level: Tuple[int, ...]):
    """Scoring at the coarsest level (cpp:1820-1852), by the bank's kind: a
    bank with feature lists by ``similarity_multiscale_auto`` at scale 1
    over its extent (the gather-sum kernel on the card, its plain version on
    the CPU), a bank of kernels by the dense conv (``similarity_dense``).
    Both give the same integers.

    Returns ([B,] N, hb, wb) float32 normalized scores; with feature lists,
    -1 marks templates without a feature inside the extent.
    """
    coarse = len(t_at_level) - 1
    t_c = t_at_level[coarse]
    maps = response_pyramid[coarse]
    if bank.feats is not None:
        one = torch.ones((1,), dtype=torch.float32, device=maps.device)
        raw, nf = similarity_multiscale_auto(maps, bank.feats[coarse], bank.valids[coarse], one, t_c,
                                             *bank.kdims[coarse])
        scores = score_normalize(raw, nf.clamp(min=1).expand(raw.shape[:-2]))
        return torch.where(nf[:, None, None] > 0, scores, -1.0)
    raw = similarity_dense(maps, bank.kernels[coarse], t_c)
    return score_normalize(raw, bank.nfeats[coarse].expand(raw.shape[:-2]))


@stage("refine")
def pyramid_refine(
    response_pyramid,
    kernels,
    nfeats,
    whs,
    feats,
    valids,
    t_at_level: Tuple[int, ...],
    threshold: float,
    tid,
    x,
    y,
    score,
    scale=None,
):
    """Candidate-local refinement down the pyramid (cpp:1854-1938).

    Candidate arrays are ([B,] K) with template ids into the bank arrays;
    response maps are ([B,] C, H_l, W_l).  Returns updated (tid, x, y,
    score).

    With feature lists (``feats`` and ``valids``), each level re-scores the
    candidates with the local-refine kernel
    (``similarity_local_sparse_auto``); dead candidates (score < 0) are
    passed to it as inactive and score zeros there.  Without them
    (``feats`` None, a bank of kernels only), each level re-scores every
    candidate, dead ones too, by the grouped conv of ``similarity_local``
    over ``kernels``, as the JAX package does for such a bank.

    ``scale`` (([B,] K) float32, the multi-scale matchers') scales each
    candidate's features and extent, as the JAX package's
    ``_refine_scaled_candidates`` does: the extent is round(wh * scale) (one
    float32 multiply, rounded half to even), the kernel scales the feature
    coordinates, and scores are normalized by the kernel's count of
    in-range features (at least 1) instead of the template's count.  It
    needs the feature lists: the grouped conv has no scaled form.
    """
    if scale is not None and feats is None:
        raise ValueError("pyramid_refine: per-candidate scales need the bank's feature lists")
    levels = len(t_at_level)
    tid_l = tid.long()
    for l in range(levels - 2, -1, -1):
        t = t_at_level[l]
        border = 8 * t
        h_l, w_l = response_pyramid[l].shape[-2:]
        wh_l = whs[l][tid_l]
        if scale is not None:
            wh_l = torch.round(wh_l.to(torch.float32) * scale[..., None]).to(torch.int32)
        x = (x * 2 + 1).clamp(min=border)
        y = (y * 2 + 1).clamp(min=border)
        x = torch.minimum(x, w_l - wh_l[..., 0] - border)
        y = torch.minimum(y, h_l - wh_l[..., 1] - border)

        og_x = (x // t - 8).clamp(min=0)
        og_y = (y // t - 8).clamp(min=0)
        origins = torch.stack([og_y * t, og_x * t], dim=-1).to(torch.int32)

        if feats is None:
            raw_local = similarity_local(response_pyramid[l], kernels[l][tid_l], origins, t)
            local_scores = score_normalize(raw_local, nfeats[l][tid_l])
        else:
            raw_local, nf_sel = similarity_local_sparse_auto(
                response_pyramid[l], feats[l][tid_l], valids[l][tid_l], origins, t,
                scale=scale, active=score >= 0,
            )
            local_scores = score_normalize(raw_local, nfeats[l][tid_l] if scale is None else nf_sel.clamp(min=1))
        flat = local_scores.reshape(*local_scores.shape[:-2], -1)
        best = torch.argmax(flat, dim=-1)  # first max wins, like cpp:1913-1926
        new_score = torch.gather(flat, -1, best[..., None])[..., 0]
        best = best.to(torch.int32)
        x = (og_x + best % 16) * t + _offset(t)
        y = (og_y + best // 16) * t + _offset(t)
        score = torch.where(score >= 0, new_score, torch.full_like(new_score, -1.0))
        score = torch.where(score > threshold, score, torch.full_like(score, -1.0))  # cpp:1934-1937
    return tid, x, y, score


@stage("pyramid")
def _build_response_pyramid(rgb, depth, cfg: DetectorConfig) -> List[torch.Tensor]:
    """Quantize -> spread -> response maps per level (cpp:1726-1752).

    ``rgb`` ([B,] H, W, 3) uint8 and ``depth`` ([B,] H, W) int32 (either may
    be None when its modality is off).  Returns per level ([B,] C, H_l, W_l)
    uint8, C = 8 * modalities.  CUDA tensors take the pyramid kernels
    (``ops/response_pyramid.py``, one launcher call), CPU tensors the plain
    version; both give the same bytes.
    """
    image = rgb if cfg.use_color else depth
    if image is not None and image.is_cuda:
        return response_pyramid_cuda(rgb, depth, cfg)
    return _build_response_pyramid_plain(rgb, depth, cfg)


def _build_response_pyramid_plain(rgb, depth, cfg: DetectorConfig) -> List[torch.Tensor]:
    """``_build_response_pyramid`` in plain PyTorch ops (``ops/quantize.py``,
    ``ops/spread.py``), on any device."""
    levels = cfg.pyramid_levels
    per_level: List[List[torch.Tensor]] = [[] for _ in range(levels)]
    if cfg.use_color:
        cur = rgb
        for l in range(levels):
            if l > 0:
                cur = Q.pyr_down_rgb(cur)
            q, _ = Q.quantize_color_gradient(cur, cfg.color.weak_threshold)
            per_level[l].append(q)
    if cfg.use_depth:
        qs = Q.depth_normal_pyramid(
            depth,
            levels,
            cfg.depth.distance_threshold,
            cfg.depth.difference_threshold,
            cfg.depth.focal,
            cfg.depth.lut_parity,
        )
        for l in range(levels):
            per_level[l].append(qs[l])
    pyramid = []
    for l in range(levels):
        t = cfg.t_at_level[l]
        maps = [compute_response_maps(spread_orientations(q, t), cfg.response_lut) for q in per_level[l]]
        pyramid.append(torch.cat(maps, dim=-3))
    return pyramid


def detect_frame_core(
    rgb: Optional[torch.Tensor],
    depth: Optional[torch.Tensor],
    bank: DeviceBank,
    cfg: DetectorConfig,
    threshold: float,
    apply_nms: bool = True,
):
    """One detection step: quantize -> spread -> response -> coarse
    similarity -> top-K -> pyramid refine -> sort -> NMS.

    Args:
      rgb: (H, W, 3) uint8, or (B, H, W, 3) for a batch of frames.
      depth: (H, W) or (B, H, W) int32 depth in mm.
      bank: the class's device bank, on the images' device; a bank of
        kernels takes the dense-kernel route (``coarse_scores``,
        ``pyramid_refine``).
      cfg: the detector configuration.
      threshold: similarity threshold in [0, 100].
      apply_nms: box NMS (else keep = score >= 0).

    Returns (tid, x, y, score, keep): ([B,] K) tensors; score sorted
    descending, -1 on dead slots; keep marks surviving matches.
    """
    single = rgb.dim() == 3 if rgb is not None else depth.dim() == 2
    if single:
        rgb = rgb[None] if rgb is not None else None
        depth = depth[None] if depth is not None else None
    pyramid = _build_response_pyramid(rgb, depth, cfg)
    t_c = cfg.t_at_level[-1]
    with span("coarse"):
        scores = coarse_scores(pyramid, bank, tuple(cfg.t_at_level))
    with span("topk"):
        tid, yi, xi, score = topk_candidates(scores, threshold, cfg.top_k)
        x = xi * t_c + _offset(t_c)
        y = yi * t_c + _offset(t_c)
    tid, x, y, score = pyramid_refine(
        pyramid, bank.kernels, bank.nfeats, bank.whs, bank.feats, bank.valids, tuple(cfg.t_at_level),
        threshold, tid, x, y, score,
    )
    with span("nms"):
        order = torch.argsort(-score, dim=-1, stable=True)
        tid, x, y, score = (torch.gather(a, -1, order) for a in (tid, x, y, score))
        if apply_nms:
            wh0 = bank.whs[0][tid.long()]
            boxes = torch.stack([x, y, wh0[..., 0], wh0[..., 1]], dim=-1).to(torch.float32)
            keep = nms_boxes(boxes, score, cfg.nms_iou)
        else:
            keep = score >= 0
    if single:
        return tid[0], x[0], y[0], score[0], keep[0]
    return tid, x, y, score, keep


# The JAX package's jit-compiled single-dispatch entry; eager PyTorch has
# nothing to compile, so it is the same function.
detect_frame = detect_frame_core


def frame_response_pyramid(rgb, depth, cfg: DetectorConfig, device) -> List[torch.Tensor]:
    """Per-level (C, H_l, W_l) uint8 response maps of one frame (arrays or
    tensors, either may be None when its modality is off) on ``device``."""
    with span("upload"):
        rgb_t = _image(rgb, torch.uint8, device)
        depth_t = _image(depth, torch.int32, device)
    pyr = _build_response_pyramid(
        rgb_t[None] if rgb_t is not None else None, depth_t[None] if depth_t is not None else None, cfg
    )
    return [p[0] for p in pyr]


def _image(a, dtype: torch.dtype, device: torch.device) -> Optional[torch.Tensor]:
    """An image as a tensor on ``device``; uint16 depth widens to int32 in
    numpy first (torch's uint16 supports few ops)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    np_dtype = np.uint8 if dtype == torch.uint8 else np.int32
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np_dtype))).to(device)


class Detector:
    """Multi-modality multi-level template matcher (reference pybind
    ``Detector``, linemodLevelup/pybind11.cpp:7-35): add_template, match,
    read/write (npz), num_templates, class_ids.

    ``device`` defaults to CUDA and raises when there is none; pass
    ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, cfg: Optional[DetectorConfig] = None, device=None):
        self.cfg = cfg or DetectorConfig()
        self.device = resolve_device(device)
        self.bank = TemplateBank(self.cfg)
        self._device_bank: Dict[str, DeviceBank] = {}

    def device_bank(self, class_id: str) -> DeviceBank:
        """The class's per-level bank tensors on the device, cached."""
        if class_id not in self._device_bank:
            self._device_bank[class_id] = bank_levels_from_numpy(
                self.bank.finalized(class_id), self.device
            )
        return self._device_bank[class_id]

    # -- training -----------------------------------------------------------

    def add_template(
        self,
        class_id: str,
        rgb: np.ndarray,
        depth: Optional[np.ndarray],
        mask: np.ndarray,
        info: Optional[dict] = None,
    ) -> int:
        self.invalidate(class_id)
        return self.bank.add_template(class_id, rgb, depth, mask, info, device=self.device)

    def invalidate(self, class_id: str) -> None:
        """Drop the cached device bank of a class (call after changing its
        bank out of band)."""
        self._device_bank.pop(class_id, None)

    # -- inference ----------------------------------------------------------

    def build_response_pyramid(self, rgb, depth) -> List[torch.Tensor]:
        """Per-level (C, H_l, W_l) uint8 response maps of one frame."""
        return frame_response_pyramid(rgb, depth, self.cfg, self.device)

    def match_arrays(self, rgb, depth, threshold: float, class_id: str, apply_nms: bool = True):
        """Detection of one class in one frame; returns device tensors
        (tid, x, y, score, keep), each (K,)."""
        with span("upload"):
            rgb_t = _image(rgb, torch.uint8, self.device)
            depth_t = _image(depth, torch.int32, self.device)
        return detect_frame(
            rgb_t,
            depth_t,
            self.device_bank(class_id),
            self.cfg,
            float(threshold),
            apply_nms,
        )

    def match_batch_arrays(
        self, rgb_batch, depth_batch, threshold: float, class_id: str, apply_nms: bool = True
    ):
        """Detection over a batch of frames (one kernel launch per level for
        the whole batch).  A missing depth batch is zeros.  Returns (tid, x,
        y, score, keep), each (B, K)."""
        with span("upload"):
            rgb_b = _image(rgb_batch, torch.uint8, self.device)
            dep_b = _image(depth_batch, torch.int32, self.device)
            if dep_b is None:
                dep_b = torch.zeros(rgb_b.shape[:3], dtype=torch.int32, device=self.device)
        return detect_frame(rgb_b, dep_b, self.device_bank(class_id), self.cfg, float(threshold), apply_nms)

    @frame_entry
    def match(
        self,
        rgb,
        depth,
        threshold: float,
        class_ids: Optional[Sequence[str]] = None,
        apply_nms: bool = True,
    ) -> List[Match]:
        """Detect all templates above ``threshold`` similarity (reference
        Detector::match, cpp:1702-1777, plus its test script's box NMS).
        One host readback per class."""
        cids = list(class_ids) if class_ids else self.bank.class_ids()
        out: List[Match] = []
        for cid in cids:
            if self.bank.num_templates(cid) == 0:
                continue
            arrays = self.match_arrays(rgb, depth, threshold, cid, apply_nms)
            with span("readback"):
                tid_np, x_np, y_np, s_np, k_np = (a.cpu().numpy() for a in arrays)
            for i in range(len(s_np)):
                if k_np[i] and s_np[i] >= 0:
                    out.append(
                        Match(
                            x=int(x_np[i]),
                            y=int(y_np[i]),
                            similarity=float(s_np[i]),
                            class_id=cid,
                            template_id=int(tid_np[i]),
                        )
                    )
        out.sort(key=lambda m: -m.similarity)
        return out

    # -- persistence (reference read/writeClasses, cpp:2013-2146) ------------

    def write_classes(self, path: str) -> None:
        self.bank.save(path)

    @classmethod
    def read_classes(cls, path: str, cfg: Optional[DetectorConfig] = None, device=None) -> "Detector":
        det = cls(cfg, device)
        det.bank = TemplateBank.load(path, det.cfg)
        return det

    def num_templates(self, class_id: Optional[str] = None) -> int:
        return self.bank.num_templates(class_id)

    def class_ids(self) -> List[str]:
        return self.bank.class_ids()
