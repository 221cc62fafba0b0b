"""The plain reference of the benchmark's cells: the SIXD matcher of every
class of a bank (single-scale and multi-scale), and the fused frame that
refines its hypotheses by ICP and verifies them, with the service's
published estimates.

Copies of the port's ``models/detector.py``, ``models/multiclass.py``,
``models/multiscale.py``, ``models/pipeline.py``, ``convert.py``,
``serving.py`` and ``geometry/render.py`` (the functions those paths run),
reduced to one route each: the coarse level always by the shift-bucketed
matmuls (the port's dense-conv branch gives the same integers), and the
local refinement always by the plain ``similarity_local_sparse``, never the
port's CUDA kernel.  The bank arrays are built here from the templates'
feature lists (``Bank``), the refine bank from the template infos, the
verification points from the class meshes.

Frozen at commit 354f402 as part of the benchmark's yardstick: later
changes to the port do not reach it.  Plain PyTorch and NumPy; imports
nothing of the port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import quantize as Q
from perfbench.reference.config import DetectorConfig, IcpConfig
from perfbench.reference.refine import (
    _matmul,
    _matvec,
    _scalar,
    _sin_cos,
    backproject,
    icp_batch,
    scene_chroma,
    scene_normals,
    verify_poses_multi,
)
from perfbench.reference.scale_proposal import propose_depth_bins
from perfbench.reference.similarity import score_normalize, similarity_local_sparse, similarity_multiscale_matmul
from perfbench.reference.spread import compute_response_maps, spread_orientations
from perfbench.reference.topk_nms import nms_boxes, topk_candidates


@dataclasses.dataclass(frozen=True)
class Bank:
    """Per pyramid level (level 0 first) tensors of a bank of one or more
    classes, class-major (global template ids).

    feats:   (N, F, 3) int32 (x, y, channel), padded to the largest F.
    valids:  (N, F) bool.
    nfeats:  (N,) int32 feature counts.
    whs:     (N, 2) int32 template (width, height).
    kdims:   (kh, kw) = (largest height + 1, largest width + 1): the
      extent of the port's kernels, which its coarse scorer covers.
    pad_map: (C, Nmax) int32 global id of each class's local template, -1
      past the class's count.
    """

    feats: Tuple[torch.Tensor, ...]
    valids: Tuple[torch.Tensor, ...]
    nfeats: Tuple[torch.Tensor, ...]
    whs: Tuple[torch.Tensor, ...]
    kdims: Tuple[Tuple[int, int], ...]
    pad_map: torch.Tensor


def bank_from_templates(per_class: Sequence[Sequence], device) -> Bank:
    """The ``Bank`` of each class's templates (per class, per template,
    per level objects with ``features`` (F, 3), ``width`` and ``height``)."""
    counts = [len(tmpls) for tmpls in per_class]
    flat = [t for tmpls in per_class for t in tmpls]
    fields = {"feats": [], "valids": [], "nfeats": [], "whs": [], "kdims": []}
    for l in range(len(flat[0])):
        fmax = max(len(t[l].features) for t in flat)
        fa = np.zeros((len(flat), fmax, 3), np.int32)
        va = np.zeros((len(flat), fmax), bool)
        wh = np.zeros((len(flat), 2), np.int32)
        for i, t in enumerate(flat):
            f = np.asarray(t[l].features)
            fa[i, : len(f)] = f
            va[i, : len(f)] = True
            wh[i] = (t[l].width, t[l].height)
        fields["feats"].append(torch.from_numpy(fa).to(device))
        fields["valids"].append(torch.from_numpy(va).to(device))
        fields["nfeats"].append(torch.from_numpy(va.sum(1).astype(np.int32)).to(device))
        fields["whs"].append(torch.from_numpy(wh).to(device))
        fields["kdims"].append((int(wh[:, 1].max()) + 1, int(wh[:, 0].max()) + 1))
    pad_map = np.full((len(counts), max(counts)), -1, np.int32)
    start = 0
    for ci, cnt in enumerate(counts):
        pad_map[ci, :cnt] = np.arange(start, start + cnt)
        start += cnt
    return Bank(**{k: tuple(v) for k, v in fields.items()}, pad_map=torch.from_numpy(pad_map).to(device))


def coarse_scores(response_pyramid, bank: Bank, t_at_level: Tuple[int, ...]):
    """Normalized scores of every template at every stride-T placement of
    the coarsest level, ([B,] N, hb, wb); -1 for templates without a feature
    inside the kernel extent."""
    t_c = t_at_level[-1]
    maps = response_pyramid[-1]
    one = torch.ones((1,), dtype=torch.float32, device=maps.device)
    raw, nf = similarity_multiscale_matmul(maps, bank.feats[-1], bank.valids[-1], one, t_c, *bank.kdims[-1])
    scores = score_normalize(raw, nf.clamp(min=1).expand(raw.shape[:-2]))
    return torch.where(nf[:, None, None] > 0, scores, -1.0)

def _offset(t: int) -> int:
    """Reported-coordinate centering: T/2 + (T%2 - 1)  (cpp:1845)."""
    return t // 2 + (t % 2 - 1)


def pyramid_refine(
    response_pyramid,
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

    Each level re-scores the candidates over a 16 x 16 window of
    placements by the plain ``similarity_local_sparse`` (the contract of
    the port's local-refine kernel); dead candidates (score < 0) are passed
    to it as inactive and score zeros there.

    ``scale`` (([B,] K) float32, the multi-scale matchers') scales each
    candidate's features and extent, as the JAX package's
    ``_refine_scaled_candidates`` does: the extent is round(wh * scale) (one
    float32 multiply, rounded half to even), the kernel scales the feature
    coordinates, and scores are normalized by the kernel's count of
    in-range features (at least 1) instead of the template's count.
    """
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

        raw_local, nf_sel = similarity_local_sparse(
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


def _build_response_pyramid(rgb, depth, cfg: DetectorConfig) -> List[torch.Tensor]:
    """Quantize -> spread -> response maps per level (cpp:1726-1752).

    ``rgb`` ([B,] H, W, 3) uint8 and ``depth`` ([B,] H, W) int32 (either may
    be None when its modality is off).  Returns per level ([B,] C, H_l, W_l)
    uint8, C = 8 * modalities.
    """
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


def match_multiclass_core(
    response_pyramid,
    bank: Bank,
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
      bank: the classes' ``Bank``.
      apply_nms: per-class box NMS (else keep = score >= 0).  Matches of
        different classes never suppress each other.

    Returns (tid_local, x, y, score, keep), each (C, K): tid_local is the
    template index within its class; each class's row is sorted by score,
    descending, -1 on dead slots.
    """
    t_c = t_at_level[-1]
    pad_map = bank.pad_map
    scores = coarse_scores(response_pyramid, bank, t_at_level)
    # Each class's templates at its own row of a (C, Nmax) grid; pad rows
    # score -1 and never pass the threshold.
    safe = pad_map.clamp(min=0).long()
    padded = torch.where((pad_map >= 0)[:, :, None, None], scores[safe], -1.0)
    tid_l, yi, xi, score = topk_candidates(padded, threshold, top_k)  # each (C, K)
    c_n = pad_map.shape[0]
    x = xi * t_c + _offset(t_c)
    y = yi * t_c + _offset(t_c)

    # All C * K candidates refine together, by global template id.
    gid = torch.gather(safe, 1, tid_l.long())
    _, x, y, score = pyramid_refine(
        response_pyramid, bank.nfeats, bank.whs, bank.feats, bank.valids, t_at_level, threshold,
        gid.reshape(-1), x.reshape(-1), y.reshape(-1), score.reshape(-1),
    )
    x, y, score = (a.reshape(c_n, top_k) for a in (x, y, score))

    order = torch.argsort(-score, dim=1, stable=True)
    tid_l, gid, x, y, score = (torch.gather(a, 1, order) for a in (tid_l, gid, x, y, score))
    if apply_nms:
        wh0 = bank.whs[0][gid]
        boxes = torch.stack([x, y, wh0[..., 0], wh0[..., 1]], dim=-1).to(torch.float32)
        keep = nms_boxes(boxes, score, nms_iou)
    else:
        keep = score >= 0
    return tid_l, x, y, score, keep


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
    tid_sc, yi, xi, score = topk_candidates(cls_scores, threshold, top_k)  # each (C, K)
    x = xi * t_c + _offset(t_c)
    y = yi * t_c + _offset(t_c)
    scale_idx = tid_sc // nmax
    tid_l = tid_sc % nmax
    gid = torch.gather(pm, 1, tid_l.long())
    cand_scale = scales[scale_idx.long()]

    # All C * K candidates refine together, by global template id.
    _, x, y, score = pyramid_refine(
        pyramid, None, bank.whs, bank.feats, bank.valids, tuple(cfg.t_at_level), threshold,
        gid.reshape(-1), x.reshape(-1), y.reshape(-1), score.reshape(-1), scale=cand_scale.reshape(-1),
    )
    x, y, score = (a.reshape(c_n, top_k) for a in (x, y, score))

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


def refine_bank_fields(infos: Sequence[dict], num_points: int = 512):
    """The six ``RefineBank`` arrays of a class as numpy, from the
    train-time ``icp_points`` clouds of its templates, and the median
    window: ``(fields, (win_h, win_w))``.  None when any template lacks
    them (banks imported from the reference store features only)."""
    n = len(infos)
    clouds = np.zeros((n, num_points, 3), np.float32)
    valids = np.zeros((n, num_points), bool)
    chroma = np.zeros((n, num_points, 2), np.float32)
    has_color = True
    src_c = np.zeros((n, 3), np.float32)
    bbox_wh = np.zeros((n, 2), np.int32)
    base_T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        info = infos[i]
        pts = np.asarray(info["icp_points"], np.float32)
        if len(pts) > num_points:
            sel = np.linspace(0, len(pts) - 1, num_points).astype(np.int64)
            pts_s = pts[sel]
        else:
            sel = None
            pts_s = pts
        clouds[i, : len(pts_s)] = pts_s
        valids[i, : len(pts_s)] = True
        src_c[i] = pts.mean(0)
        if "icp_colors" in info:
            col = np.asarray(info["icp_colors"], np.float32)
            col = col[sel] if sel is not None else col
            chroma[i, : len(pts_s)] = col[:, :2] / np.maximum(col.sum(-1, keepdims=True), 1e-6)
        else:
            has_color = False
        bx0, by0, bx1, by1 = np.asarray(info["render_bbox"])
        bbox_wh[i] = (int(bx1 - bx0), int(by1 - by0))
        base_T[i, :3, :3] = np.asarray(info["cam_R_w2c"], np.float32)
        base_T[i, :3, 3] = np.asarray(info["cam_t_w2c"], np.float32).ravel()
        base_T[i, 2, 3] /= 1000.0  # reference quirk: z mm -> m (cpp:37)
    win_w = int(min(-(-(bbox_wh[:, 0].max() + 1) // 16) * 16, 192))
    win_h = int(min(-(-(bbox_wh[:, 1].max() + 1) // 16) * 16, 192))
    return (clouds, valids, chroma if has_color else None, src_c, bbox_wh, base_T), (win_h, win_w)


def _masked_median(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``vals`` where ``mask`` over the last axis (the lower
    middle of an even count); 0 where the mask is empty."""
    v = torch.sort(torch.where(mask, vals, 1e9), dim=-1).values
    cnt = mask.sum(-1)
    k = (cnt - 1).clamp(min=0) // 2
    med = torch.gather(v, -1, k[..., None])[..., 0]
    return torch.where(cnt > 0, med, 0.0)


def _seed_candidates(
    depth: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    wh: torch.Tensor,
    src_c: torch.Tensor,
    K: torch.Tensor,
    win: Tuple[int, int],
) -> torch.Tensor:
    """Initial ICP transforms from the window-median scene depth at each
    candidate (a centroid shift, as poseRefine's initial guess,
    linemodLevelup.cpp:60-104).

    ``depth`` (H, W) int32 mm; ``x``, ``y`` (K,) level-0 pixel coordinates;
    ``wh`` (K, 2) render bbox; ``src_c`` (K, 3) cloud centroids (m).  Each
    candidate's (win_h, win_w) window of the zero-padded depth is one
    gather of a (K, win_h, win_w) index grid.  Returns (K, 4, 4) float32.
    """
    h, w = depth.shape
    win_h, win_w = win
    k_n = x.shape[0]
    dev = depth.device
    depth_pad = F.pad(depth.to(torch.float32), (0, win_w, 0, win_h))
    ii = torch.arange(win_h, device=dev)[:, None]
    jj = torch.arange(win_w, device=dev)[None, :]
    y0 = y.clamp(0, h - 1).to(torch.int64)[:, None, None]
    x0 = x.clamp(0, w - 1).to(torch.int64)[:, None, None]
    window = depth_pad.reshape(-1)[(y0 + ii) * (w + win_w) + (x0 + jj)]  # (K, win_h, win_w)
    mask = (ii <= wh[:, 1, None, None]) & (jj <= wh[:, 0, None, None]) & (window > 0)
    z_med = _masked_median(window.reshape(k_n, -1), mask.reshape(k_n, -1)) / _scalar(1000.0, depth)
    z_med = torch.where(z_med > 0, z_med, 0.5)
    u = x.to(torch.float32) + wh[:, 0].to(torch.float32) / 2.0
    v = y.to(torch.float32) + wh[:, 1].to(torch.float32) / 2.0
    target = torch.stack([(u - K[0, 2]) / K[0, 0] * z_med, (v - K[1, 2]) / K[1, 1] * z_med, z_med], dim=-1)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    top = torch.cat([eye[:3, :3].expand(k_n, 3, 3), (target - src_c)[..., None]], dim=-1)
    return torch.cat([top, eye[3:].expand(k_n, 1, 4)], dim=-2)


def _inplane_seed_transforms(
    init_T: torch.Tensor,
    src_c: torch.Tensor,
    seeds: int,
    step_deg: float = 18.0,
    flip: bool = False,
) -> torch.Tensor:
    """Expand each ICP seed (K, 4, 4) into ``seeds`` in-plane rotations about
    the camera ray through the candidate's seeded centroid (``src_c``
    (K, 3), model frame) -> (K * seeds, 4, 4).

    The fan is symmetric about the seed in steps of ``step_deg``; with
    ``flip`` its last slot is a 180-deg in-plane seed instead, for
    near-180-symmetric silhouettes that make template matching lock the
    wrong half of the view sphere.
    """
    if seeds == 1:
        return init_T
    dev = init_T.device
    if flip and seeds >= 2:
        offs = torch.arange(seeds - 1, dtype=torch.float32, device=dev) - (seeds - 2) / 2.0
        offs_deg = torch.cat([offs * step_deg, torch.full((1,), 180.0, dtype=torch.float32, device=dev)])
    else:
        offs = torch.arange(seeds, dtype=torch.float32, device=dev) - (seeds - 1) / 2.0
        offs_deg = offs * step_deg
    s, c = _sin_cos(torch.deg2rad(offs_deg))
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rz = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], dim=-1).reshape(seeds, 3, 3)

    k_n = init_T.shape[0]
    target = init_T[:, :3, 3] + src_c  # (K, 3) rotation centre
    rz_k = rz.expand(k_n, seeds, 3, 3)
    shift = target[:, None, :] - _matvec(rz_k, target[:, None, :].expand(k_n, seeds, 3))  # target - R target
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    seed_T = torch.cat(
        [torch.cat([rz_k, shift[..., None]], dim=-1), eye[3:].expand(k_n, seeds, 1, 4)], dim=-2
    )
    return _matmul(seed_T, init_T[:, None]).reshape(-1, 4, 4)


def _repeat(a: torch.Tensor, s: int) -> torch.Tensor:
    """Each row of ``a`` ``s`` times in a row (``jnp.repeat(a, s, 0)``)."""
    if s == 1:
        return a
    return a[:, None].expand(a.shape[0], s, *a.shape[1:]).reshape(a.shape[0] * s, *a.shape[1:])


def _select_hypotheses(tid, x, y, score, wh, max_refine: int):
    """The ``max_refine`` hypotheses of each row of candidates (the last
    axis; leading axes are classes): the top ones by raw score, deduped on
    (template, location), not the box-NMS survivors.

    Box NMS keeps one template per location, but a near-symmetric object
    scores several views at one peak within a few points, and only
    verification tells them apart, so rival views stay.  A candidate is a
    duplicate of an earlier one of the same template within half its box
    (``wh`` (..., K, 2), the candidate's box extent).  Tiered budget: every
    template's first occurrence outranks any repeat, so same-view peaks far
    apart (second instances) fill only what distinct views leave.

    Returns (order (..., R) indices into the candidates, active (..., R)).
    """
    rank = torch.where(score >= 0, score, -torch.inf)
    order0 = torch.argsort(-rank, dim=-1, stable=True)
    tid_s, rank_s, x_s, y_s = (torch.gather(a, -1, order0) for a in (tid, rank, x, y))
    wh_s = torch.gather(wh, -2, order0[..., None].expand(*order0.shape, 2))
    same = tid_s[..., :, None] == tid_s[..., None, :]
    near = ((x_s[..., :, None] - x_s[..., None, :]).abs() * 2 <= wh_s[..., None, :, 0]) & (
        (y_s[..., :, None] - y_s[..., None, :]).abs() * 2 <= wh_s[..., None, :, 1]
    )
    idx = torch.arange(tid.shape[-1], device=tid.device)
    earlier = idx[None, :] < idx[:, None]
    dup = (same & near & earlier).any(-1)
    rep = (same & earlier).any(-1)
    rank2 = torch.where(dup, -torch.inf, rank_s + torch.where(rep, 0.0, 1e4))
    order1 = torch.argsort(-rank2, dim=-1, stable=True)[..., :max_refine]
    order = torch.gather(order0, -1, order1)
    active = torch.isfinite(torch.gather(rank2, -1, order1)) & (torch.gather(score, -1, order) >= 0)
    return order, active


def _refine_hypotheses(
    rgb: Optional[torch.Tensor],
    depth: torch.Tensor,
    rb: RefineBank,
    icp: IcpConfig,
    K: torch.Tensor,
    gid: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    active: torch.Tensor,
    verify_pts: Optional[torch.Tensor],
    verify_valid: Optional[torch.Tensor],
    verify_colors: Optional[torch.Tensor],
    verify_of: Optional[torch.Tensor],
    verify_tau: float,
    verify_color_weight: float,
    icp_seeds: int,
    seed_step_deg: float,
    seed_flip: bool,
    verify_color_zscore: bool,
):
    """Seeding, the seed fan, batched ICP, pose composition and
    verification of M hypotheses of one frame.

    ``gid``, ``x``, ``y``, ``active`` (M,): refine-bank template ids,
    level-0 positions and liveness.  Hypothesis m verifies against point
    set ``verify_of[m]`` of ``verify_pts`` (V, P, 3) mm, ``verify_valid``
    (V, P) and ``verify_colors`` (V, P, 3) or None; without points the
    verify score is -1.  Each hypothesis refines from ``icp_seeds``
    in-plane seeds and keeps its best-verified one (fitness breaks ties and
    ranks without verify).

    Returns (R (M, 3, 3), t_mm (M, 3), fitness (M,), verify (M,)); inactive
    hypotheses have fitness = verify = -1.
    """
    m_n = gid.shape[0]
    # Candidate seeding: window-median depth -> centroid shift, then the
    # in-plane seed fan (M -> M * S candidates).
    init_T = _seed_candidates(depth, x, y, rb.bbox_wh[gid], rb.src_c[gid], K, rb.win)
    s_n = icp_seeds
    init_T = _inplane_seed_transforms(init_T, rb.src_c[gid], s_n, seed_step_deg, seed_flip)
    gid_e = _repeat(gid, s_n)
    act_e = _repeat(active, s_n)

    # Batched ICP against the frame's scene maps.
    sp = backproject(depth, K)
    sn = scene_normals(sp)
    use_color = rb.chroma is not None and rgb is not None and icp.color_weight > 0
    chroma_maps = scene_chroma(rgb) if use_color else None
    Ts, fits, _ = icp_batch(
        rb.clouds[gid_e],
        rb.valids[gid_e] & act_e[:, None],
        sp,
        sn,
        K,
        init_T,
        icp.corr_dist,
        icp.max_iters,
        icp.coarse_gate_mult,
        model_chroma=rb.chroma[gid_e] if use_color else None,
        chroma_maps=chroma_maps,
        color_weight=icp.color_weight,
        chroma_scale=icp.chroma_scale,
        point_weight=icp.point_weight,
        lm_damping=icp.lm_damping,
        bilinear_iters=icp.bilinear_iters,
        coarse_points=icp.coarse_points,
    )

    # Compose with the template pose, then verify every candidate with its
    # own point set.
    result = _matmul(Ts, rb.base_T[gid_e])
    R_out = result[:, :3, :3]
    t_out = result[:, :3, 3] * 1000.0  # mm
    if verify_pts is not None:
        v = _repeat(verify_of, s_n)
        vscore = verify_poses_multi(
            verify_pts[v], verify_valid[v], R_out, t_out, depth, K,
            tau_mm=verify_tau,
            model_colors=verify_colors[v] if verify_colors is not None else None,
            rgb=rgb if verify_colors is not None else None,
            color_weight=verify_color_weight,
            color_zscore=verify_color_zscore,
        )
    else:
        vscore = torch.full((m_n * s_n,), -1.0, dtype=torch.float32, device=depth.device)
    fits = torch.where(act_e, fits, -1.0)
    vscore = torch.where(act_e, vscore, -1.0)

    if s_n > 1:
        # Each hypothesis's best seed: verify-ranked, fitness as tiebreaker
        # (and as the rank when verify is off).
        seed_rank = torch.where(vscore >= 0, vscore * 100.0 + fits.clamp(min=0.0), fits).reshape(m_n, s_n)
        pick = torch.arange(m_n, device=depth.device) * s_n + torch.argmax(seed_rank, dim=1)
        R_out, t_out, fits, vscore = R_out[pick], t_out[pick], fits[pick], vscore[pick]
    return R_out, t_out, fits, vscore


def detect_refine_multiclass_core(
    rgb: Optional[torch.Tensor],
    depth: torch.Tensor,
    bank: Bank,
    cfg: DetectorConfig,
    threshold: float,
    rb: RefineBank,
    icp: IcpConfig,
    K: torch.Tensor,
    max_refine: int,
    verify_pts: torch.Tensor,
    verify_valid: torch.Tensor,
    verify_colors: Optional[torch.Tensor],
    verify_tau: float = 15.0,
    verify_color_weight: float = 0.5,
    icp_seeds: int = 1,
    seed_step_deg: float = 18.0,
    seed_flip: bool = False,
    verify_color_zscore: bool = False,
):
    """One frame of every class: the multi-class match, then the top
    ``max_refine`` hypotheses of each class (``_select_hypotheses``) refine
    together in one batched ICP of C * R * S candidates and verify together,
    each against its own class's points, and each keeps its best seed.

    Args:
      bank: the classes' ``Bank``.
      rb: the global refine bank (the bank's template order).
      verify_pts (C, P, 3) mm, verify_valid (C, P), verify_colors (C, P, 3)
        or None: each class's padded verification points
        (``multiclass_verify_points``).
      The rest as the port's ``detect_refine_core``.

    Returns (C, R) tensors (tid_local, x, y, score, R (C, R, 3, 3), t_mm
    (C, R, 3), fitness, verify, active), rows in class order.
    """
    pyramid = _build_response_pyramid(
        rgb[None] if rgb is not None else None, depth[None], cfg
    )
    # The hypotheses are not the box-NMS survivors, so the match skips NMS.
    tid_l, x, y, score, _ = match_multiclass_core(
        [p[0] for p in pyramid], bank, tuple(cfg.t_at_level), threshold, cfg.top_k, cfg.nms_iou, False
    )
    gid_all = torch.gather(bank.pad_map.clamp(min=0).long(), 1, tid_l.long())
    order, active = _select_hypotheses(tid_l, x, y, score, bank.whs[0][gid_all], max_refine)
    tid_r, gid, x_r, y_r, score_r = (torch.gather(a, 1, order) for a in (tid_l, gid_all, x, y, score))
    c_n, r_n = gid.shape
    cls = torch.arange(c_n, device=depth.device).repeat_interleave(r_n)
    R_out, t_out, fits, vscore = _refine_hypotheses(
        rgb, depth, rb, icp, K, gid.reshape(-1), x_r.reshape(-1), y_r.reshape(-1), active.reshape(-1),
        verify_pts, verify_valid, verify_colors, cls, verify_tau, verify_color_weight, icp_seeds,
        seed_step_deg, seed_flip, verify_color_zscore,
    )
    unflat = lambda a: a.reshape(c_n, r_n, *a.shape[1:])  # noqa: E731
    return tid_r, x_r, y_r, score_r, unflat(R_out), unflat(t_out), unflat(fits), unflat(vscore), active


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


def multiclass_verify_points(pts: Sequence[np.ndarray], colors: Optional[Sequence[np.ndarray]], device):
    """Each class's verification points (P_c, 3) mm and, if every class has
    them, colours (P_c, 3), padded to the largest P: (points (C, P, 3)
    float32, valid (C, P) bool, colours (C, P, 3) float32 or None) on
    ``device``."""
    p_max = max(len(p) for p in pts)
    vp = np.zeros((len(pts), p_max, 3), np.float32)
    vv = np.zeros((len(pts), p_max), bool)
    vc = np.zeros((len(pts), p_max, 3), np.float32)
    has_colors = colors is not None and all(c is not None for c in colors)
    for ci, p in enumerate(pts):
        vp[ci, : len(p)] = p
        vv[ci, : len(p)] = True
        if has_colors:
            vc[ci, : len(p)] = colors[ci]
    up = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return up(vp), up(vv), up(vc) if has_colors else None


@dataclasses.dataclass(frozen=True)
class MultiScaleBank:
    """The feature arrays of the multi-scale matcher on a device, for
    several classes (class-major, global template ids), per pyramid level:
    feats (N, F, 3) int32, valids (N, F) bool, whs (N, 2) int32, kdims the
    (kh, kw) covering every template at the largest scale; pad_map (C,
    Nmax); cls_kb (C, 2) each class's own coarse shift buckets; pad_kb the
    coarse maps' bottom/right padding in blocks."""

    feats: Tuple[torch.Tensor, ...]
    valids: Tuple[torch.Tensor, ...]
    whs: Tuple[torch.Tensor, ...]
    kdims: Tuple[Tuple[int, int], ...]
    pad_map: torch.Tensor
    cls_kb: torch.Tensor
    pad_kb: Tuple[int, int]


def multiscale_bank(per_class: Sequence[Sequence], max_scale: float, t_coarse: int, device) -> MultiScaleBank:
    """The ``MultiScaleBank`` of each class's templates on ``device``."""
    a = multiscale_arrays(per_class, max_scale, t_coarse)
    up = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return MultiScaleBank(
        feats=tuple(up(x) for x in a["feats"]), valids=tuple(up(x) for x in a["valids"]),
        whs=tuple(up(x) for x in a["whs"]), kdims=tuple(a["kdims"]), pad_map=up(a["pad_map"]),
        cls_kb=up(a["cls_kb"]), pad_kb=a["pad_kb"],
    )


def multiscale_arrays(per_class: Sequence[Sequence], max_scale: float, t_coarse: int) -> dict:
    """The numpy arrays of a ``MultiScaleBank`` from each class's templates
    (per class, per template, per level objects with ``features``,
    ``width`` and ``height``: a ``TemplateLevel`` of either package)."""
    counts = [len(tmpls) for tmpls in per_class]
    flat = [t for tmpls in per_class for t in tmpls]
    out = {"feats": [], "valids": [], "whs": [], "kdims": []}
    for l in range(len(flat[0])):
        fmax = max(len(t[l].features) for t in flat)
        fa = np.zeros((len(flat), fmax, 3), np.int32)
        va = np.zeros((len(flat), fmax), bool)
        wh = np.zeros((len(flat), 2), np.int32)
        for i, t in enumerate(flat):
            f = np.asarray(t[l].features)
            fa[i, : len(f)] = f
            va[i, : len(f)] = True
            wh[i] = (t[l].width, t[l].height)
        out["feats"].append(fa)
        out["valids"].append(va)
        out["whs"].append(wh)
        out["kdims"].append(_scaled_extent(wh, max_scale))
    pad_map = np.full((len(counts), max(counts)), -1, np.int32)
    cls_kb = np.zeros((len(counts), 2), np.int32)
    start = 0
    for ci, cnt in enumerate(counts):
        pad_map[ci, :cnt] = np.arange(start, start + cnt)
        kh, kw = _scaled_extent(out["whs"][-1][start : start + cnt], max_scale)
        cls_kb[ci] = (-(-kh // t_coarse), -(-kw // t_coarse))
        start += cnt
    kh, kw = out["kdims"][-1]
    out["pad_map"], out["cls_kb"] = pad_map, cls_kb
    out["pad_kb"] = (int(-(-kh // t_coarse) - cls_kb[:, 0].min()), int(-(-kw // t_coarse) - cls_kb[:, 1].min()))
    return out


def _scaled_extent(wh: np.ndarray, max_scale: float) -> Tuple[int, int]:
    """(kh, kw) covering templates of (width, height) ``wh`` at ``max_scale``."""
    return int(np.ceil((wh[:, 1].max() + 1) * max_scale)), int(np.ceil((wh[:, 0].max() + 1) * max_scale))


@dataclasses.dataclass
class PoseEstimate:
    class_id: str
    template_id: int
    x: int
    y: int
    similarity: float
    R: np.ndarray          # (3, 3)
    t: np.ndarray          # (3, 1) mm
    fitness: float
    verify: float = -1.0   # depth-consistency of the refined pose


def nms_norms(
    estimates: List[PoseEstimate],
    radius_mm: float = 40.0,
    key: str = "fitness",
) -> List[PoseEstimate]:
    """Greedy translation-space dedupe (linemod_ros/detect.py:41-50): keep
    the best estimate within each ``radius_mm`` ball, per class (estimates
    of different classes never suppress each other).

    ``key``: 'fitness' ranks by ICP fitness, 'similarity' by match
    similarity, 'verify' by verification (then fitness, then similarity)."""
    keys = {
        "fitness": lambda e: (-e.fitness, -e.similarity),
        "similarity": lambda e: (-e.similarity, -e.fitness),
        "verify": lambda e: (-e.verify, -e.fitness, -e.similarity),
    }
    rank = keys[key]
    kept: List[PoseEstimate] = []
    for e in sorted(estimates, key=rank):
        if all(k.class_id != e.class_id or np.linalg.norm(e.t - k.t) > radius_mm for k in kept):
            kept.append(e)
    return kept


def subdivide_mesh(
    pts: np.ndarray,
    faces: np.ndarray,
    max_edge: float,
    attrs: "Optional[np.ndarray]" = None,
):
    """Split triangles until every edge is <= max_edge (model units).

    Host-side, once per asset.  Guarantees the rasterizer's fixed tile
    covers each projected triangle when max_edge * f / z_min <= tile_px.
    ``attrs`` is an optional (V, A) per-vertex attribute array (e.g.
    colors); midpoints average their endpoints.  Returns (pts, faces) or
    (pts, faces, attrs).  A numpy copy of the JAX package's.
    """
    pts = np.asarray(pts, np.float64)
    faces = np.asarray(faces, np.int64)
    if attrs is not None:
        attrs = np.asarray(attrs, np.float64)
    while True:
        p = pts[faces]  # (m, 3, 3)
        e = np.stack(
            [
                np.linalg.norm(p[:, 0] - p[:, 1], axis=1),
                np.linalg.norm(p[:, 1] - p[:, 2], axis=1),
                np.linalg.norm(p[:, 2] - p[:, 0], axis=1),
            ],
            1,
        )
        bad = e.max(1) > max_edge
        if not bad.any():
            return (pts, faces) if attrs is None else (pts, faces, attrs)
        keep = faces[~bad]
        split = faces[bad]
        mids = (pts[split[:, [0, 1, 2]]] + pts[split[:, [1, 2, 0]]]) / 2  # (m,3,3)
        base = len(pts)
        pts = np.concatenate([pts, mids.reshape(-1, 3)], 0)
        if attrs is not None:
            amids = (attrs[split[:, [0, 1, 2]]] + attrs[split[:, [1, 2, 0]]]) / 2
            attrs = np.concatenate([attrs, amids.reshape(-1, attrs.shape[1])], 0)
        m01 = base + np.arange(len(split)) * 3 + 0
        m12 = base + np.arange(len(split)) * 3 + 1
        m20 = base + np.arange(len(split)) * 3 + 2
        a, b, c = split[:, 0], split[:, 1], split[:, 2]
        faces = np.concatenate(
            [
                keep,
                np.stack([a, m01, m20], 1),
                np.stack([m01, b, m12], 1),
                np.stack([m12, c, m20], 1),
                np.stack([m01, m12, m20], 1),
            ],
            0,
        )


def published(class_ids: Sequence[str], out, min_fitness: float = 0.5, min_verify: float = 0.0,
              radius_mm: float = 40.0, rank_key: str = "verify") -> List[PoseEstimate]:
    """The estimates the service publishes from one fused frame's (C, R)
    numpy results (tid, x, y, score, R, t_mm, fitness, verify, active): per
    class, the active hypotheses that pass the fitness and verification
    gates, deduped by ``nms_norms`` (the port's
    ``PoseEstimationService.process_frame_fused``)."""
    tid, x, y, score, R, t, fit, ver, active = out
    ests = []
    for ci, cid in enumerate(class_ids):
        for i in range(tid.shape[1]):
            if not active[ci, i] or fit[ci, i] < min_fitness:
                continue
            if ver[ci, i] >= 0 and ver[ci, i] < min_verify:
                continue
            ests.append(PoseEstimate(
                class_id=cid, template_id=int(tid[ci, i]), x=int(x[ci, i]), y=int(y[ci, i]),
                similarity=float(score[ci, i]), R=R[ci, i].astype(np.float64),
                t=t[ci, i].reshape(3, 1).astype(np.float64), fitness=float(fit[ci, i]), verify=float(ver[ci, i]),
            ))
    return nms_norms(ests, radius_mm, key=rank_key)


def verify_points_from_mesh(model: dict):
    """A mesh's (mm) verification points and their colours, as the
    service derives them (``PoseEstimationService._verify_points_np``, for
    meshes with per-vertex colours): the mesh subdivided to edges of at
    most a twelfth of its extent, its vertices and face centroids, at most
    2048 of them evenly picked."""
    pts = np.asarray(model["pts"], np.float64)
    faces = np.asarray(model["faces"], np.int64)
    attr = np.asarray(model["colors"], np.float64)
    extent = float(np.linalg.norm(pts, axis=1).max())
    pts2, faces2, attr2 = subdivide_mesh(pts, faces, max_edge=max(extent / 12, 2.0), attrs=attr)
    surf = np.concatenate([pts2, pts2[faces2].mean(1)], 0)
    attr_s = np.concatenate([attr2, attr2[faces2].mean(1)], 0)
    if len(surf) > 2048:
        sel = np.linspace(0, len(surf) - 1, 2048).astype(np.int64)
        surf, attr_s = surf[sel], attr_s[sel]
    return surf.astype(np.float32), attr_s[:, :3].astype(np.float32)
