"""Fused detect -> refine -> verify, for one class or for every class, with
no host trips.

Port of the JAX package's ``models/pipeline.py``.  The reference's serving
loop (linemod_ros/detect.py:94-150, linemod_and_levelup_test.py:324-376)
does host work between the match and every per-candidate poseRefine.  Here
everything the refine stage needs is computed per template at train time
(the ``icp_points`` cloud in the template info) and uploaded once, so a
frame is

    quantize -> spread -> response -> coarse similarity -> top-K
    -> pyramid refine -> hypothesis selection -> window-median seeding
    (+ in-plane seed fan) -> scene maps -> batched ICP
    -> pose composition -> verification

on the device of the frame, with one readback of fixed-size results by the
caller.  Nothing between the image upload and that readback waits for the
device.  ``detect_refine_core`` / ``FusedPipeline`` run one class;
``detect_refine_multiclass_core`` / ``FusedMultiClassPipeline`` run every
class of a bank in one pass (the multi-class match of
``models/multiclass.py``, then one batched ICP over every class's
hypotheses).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sixdpose_tpu_torch.config import DetectorConfig, IcpConfig
from sixdpose_tpu_torch.convert import (
    DeviceBank,
    RefineBank,
    bank_levels_from_numpy,
    multiclass_refine_bank_from_numpy,
    multiclass_verify_points,
    refine_bank_from_numpy,
)
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.models.detector import Detector, _build_response_pyramid, _image, detect_frame_core
from sixdpose_tpu_torch.models.multiclass import MultiClassMatcher, match_multiclass_core
from sixdpose_tpu_torch.models.refine import (
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
from sixdpose_tpu_torch.utils.timing import frame_entry, span


def refine_bank_fields(detector: Detector, class_id: str, num_points: int = 512):
    """The six ``RefineBank`` arrays of a class as numpy, from the
    train-time ``icp_points`` clouds of its templates, and the median
    window: ``(fields, (win_h, win_w))``.  None when any template lacks
    them (banks imported from the reference store features only)."""
    infos = detector.bank.infos.get(class_id, [])
    n = detector.bank.num_templates(class_id)
    if n == 0 or len(infos) < n:
        return None
    clouds = np.zeros((n, num_points, 3), np.float32)
    valids = np.zeros((n, num_points), bool)
    chroma = np.zeros((n, num_points, 2), np.float32)
    has_color = True
    src_c = np.zeros((n, 3), np.float32)
    bbox_wh = np.zeros((n, 2), np.int32)
    base_T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        info = infos[i]
        if "icp_points" not in info or "cam_R_w2c" not in info:
            return None
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


def build_refine_bank(
    detector: Detector, class_id: str, num_points: int = 512, device=None
) -> Optional[RefineBank]:
    """Stack the train-time ``icp_points`` clouds of a class into device
    tensors on ``device`` (CUDA by default, raising when there is none;
    ``device="cpu"`` for the CPU).  Returns None when any template lacks
    them (``refine_bank_fields``)."""
    device = resolve_device(device)
    fields = refine_bank_fields(detector, class_id, num_points)
    return refine_bank_from_numpy(*fields, device) if fields is not None else None


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
    s_n = icp_seeds
    with span("icp"):
        # Candidate seeding: window-median depth -> centroid shift, then the
        # in-plane seed fan (M -> M * S candidates).
        init_T = _seed_candidates(depth, x, y, rb.bbox_wh[gid], rb.src_c[gid], K, rb.win)
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

        # Compose with the template pose.
        result = _matmul(Ts, rb.base_T[gid_e])
        R_out = result[:, :3, :3]
        t_out = result[:, :3, 3] * 1000.0  # mm

    # Verify every candidate with its own point set.
    with span("verify"):
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


def detect_refine_core(
    rgb: Optional[torch.Tensor],
    depth: torch.Tensor,
    bank: DeviceBank,
    cfg: DetectorConfig,
    threshold: float,
    rb: RefineBank,
    icp: IcpConfig,
    K: torch.Tensor,
    max_refine: int,
    verify_pts: Optional[torch.Tensor] = None,
    verify_colors: Optional[torch.Tensor] = None,
    verify_tau: float = 15.0,
    verify_color_weight: float = 0.5,
    icp_seeds: int = 1,
    seed_step_deg: float = 18.0,
    seed_flip: bool = False,
    verify_color_zscore: bool = False,
):
    """One frame of one class: match, batched ICP and verification.

    Args:
      rgb: (H, W, 3) uint8 or None; depth: (H, W) int32 mm.
      bank: the class's ``DeviceBank``; rb: its ``RefineBank``; both on the
        images' device, as is ``K`` (3, 3) float32.
      max_refine: candidates refined (``_select_hypotheses``).
      verify_pts / verify_colors: (P, 3) model surface points (mm) and
        their colors for ``verify_poses``; without points the verify
        score is -1.
      icp_seeds, seed_step_deg, seed_flip: each candidate refines from a
        fan of in-plane seeds (``_inplane_seed_transforms``) and keeps its
        best-verified one (fitness breaks ties and ranks without verify).

    Returns tensors of length ``max_refine``: (tid, x, y, score, R (R, 3, 3),
    t_mm (R, 3), fitness, verify, active); inactive slots have
    active=False and fitness = verify = -1.
    """
    # The hypotheses are not the box-NMS survivors, so the match skips NMS.
    tid, x, y, score, _ = detect_frame_core(rgb, depth, bank, cfg, threshold, False)
    with span("select"):
        order, active = _select_hypotheses(tid, x, y, score, rb.bbox_wh[tid.long()], max_refine)
        tid_r, x_r, y_r, score_r = (a[order] for a in (tid, x, y, score))
        vp = verify_pts[None] if verify_pts is not None else None
        vv = torch.ones(vp.shape[:2], dtype=torch.bool, device=depth.device) if vp is not None else None
        vc = verify_colors[None] if verify_colors is not None else None
        of = torch.zeros_like(order)
    R_out, t_out, fits, vscore = _refine_hypotheses(
        rgb, depth, rb, icp, K, tid_r.long(), x_r, y_r, active, vp, vv, vc, of, verify_tau, verify_color_weight, icp_seeds, seed_step_deg, seed_flip,
        verify_color_zscore,
    )
    return tid_r, x_r, y_r, score_r, R_out, t_out, fits, vscore, active


def detect_refine_multiclass_core(
    rgb: Optional[torch.Tensor],
    depth: torch.Tensor,
    bank: DeviceBank,
    pad_map: torch.Tensor,
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
      bank, pad_map: the superbank of ``convert.multiclass_bank_from_numpy``.
      rb: the global refine bank (``convert.multiclass_refine_bank_from_numpy``,
        the superbank's template order).
      verify_pts (C, P, 3) mm, verify_valid (C, P), verify_colors (C, P, 3)
        or None: each class's padded verification points
        (``convert.multiclass_verify_points``).
      The rest as ``detect_refine_core``.

    Returns (C, R) tensors (tid_local, x, y, score, R (C, R, 3, 3), t_mm
    (C, R, 3), fitness, verify, active), rows in class order.
    """
    pyramid = _build_response_pyramid(
        rgb[None] if rgb is not None else None, depth[None], cfg
    )
    # The hypotheses are not the box-NMS survivors, so the match skips NMS.
    tid_l, x, y, score, _ = match_multiclass_core(
        [p[0] for p in pyramid], bank, pad_map, tuple(cfg.t_at_level), threshold, cfg.top_k, cfg.nms_iou, False
    )
    with span("select"):
        gid_all = torch.gather(pad_map.clamp(min=0).long(), 1, tid_l.long())
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


class FusedPipeline:
    """detect + refine + verify for one class as one callable.

    Runs on ``device``: CUDA by default, raising when there is none; pass
    ``device="cpu"`` for the CPU.  The detector's bank must carry the
    train-time refine infos (``icp_points``, ``cam_R_w2c``, ``cam_t_w2c``,
    ``render_bbox``, optionally ``icp_colors``); its template and refine
    banks are uploaded once, here.
    """

    def __init__(
        self,
        detector: Detector,
        class_id: str,
        K: np.ndarray,
        icp: Optional[IcpConfig] = None,
        max_refine: int = 8,
        num_points: int = 512,
        verify_pts: Optional[np.ndarray] = None,
        verify_colors: Optional[np.ndarray] = None,
        verify_tau: float = 15.0,
        verify_color_weight: float = 0.5,
        icp_seeds: int = 1,
        seed_step_deg: float = 18.0,
        seed_flip: bool = False,
        verify_color_zscore: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.det = detector
        self.class_id = class_id
        self.icp = icp or IcpConfig()
        self.max_refine = max_refine
        self.icp_seeds = int(icp_seeds)
        self.seed_step_deg = float(seed_step_deg)
        self.seed_flip = bool(seed_flip)
        self.rb = build_refine_bank(detector, class_id, num_points, self.device)
        if self.rb is None:
            raise ValueError(
                f"class {class_id!r} lacks icp_points/pose infos; train with "
                "render_train_templates or use the unfused serving path"
            )
        self.bank = bank_levels_from_numpy(detector.bank.finalized(class_id), self.device)

        def upload(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(self.device) if a is not None else None

        self.K = upload(K)
        self.verify_pts = upload(verify_pts)
        self.verify_colors = upload(verify_colors)
        self.verify_tau = float(verify_tau)
        self.verify_color_weight = float(verify_color_weight)
        self.verify_color_zscore = bool(verify_color_zscore)

    @frame_entry
    def __call__(self, rgb, depth, threshold: float):
        """Returns device tensors (tid, x, y, score, R, t_mm, fitness,
        verify, active), each of length ``max_refine``; nothing waits for
        the device after the images are uploaded."""
        with span("upload"):
            rgb_t = _image(rgb, torch.uint8, self.device)
            depth_t = _image(depth, torch.int32, self.device)
        return detect_refine_core(
            rgb_t,
            depth_t,
            self.bank,
            self.det.cfg,
            float(threshold),
            self.rb,
            self.icp,
            self.K,
            self.max_refine,
            self.verify_pts,
            self.verify_colors,
            self.verify_tau,
            self.verify_color_weight,
            self.icp_seeds,
            self.seed_step_deg,
            self.seed_flip,
            self.verify_color_zscore,
        )


class FusedMultiClassPipeline:
    """detect + refine + verify for every class of a bank as one callable.

    ``max_refine`` hypotheses are kept per class through ICP and
    verification, so the caller ranks poses by verification rather than by
    match similarity (under clutter a wrong-surface lock can beat the right
    pose on similarity and lose on verification).

    Runs on ``device``: CUDA by default, raising when there is none; pass
    ``device="cpu"`` for the CPU.  Every class's templates must carry the
    train-time refine infos (as for ``FusedPipeline``); ``verify_pts`` maps
    each class id to its (P, 3) model surface points in mm, and
    ``verify_colors`` optionally to their colours.  ``refine_bank``, a
    global ``RefineBank`` in the superbank's template order on ``device``
    (``convert.refine_bank_from_numpy``), takes the place of the one built
    from those infos.  The superbank, the global refine bank and the padded
    verification points are uploaded once, here.
    """

    def __init__(
        self,
        detector: Detector,
        K: np.ndarray,
        class_ids=None,
        icp: Optional[IcpConfig] = None,
        max_refine: int = 4,
        num_points: int = 512,
        verify_pts: Optional[Dict[str, np.ndarray]] = None,
        verify_colors: Optional[Dict[str, np.ndarray]] = None,
        verify_tau: float = 15.0,
        verify_color_weight: float = 0.5,
        icp_seeds: int = 1,
        seed_step_deg: float = 18.0,
        seed_flip: bool = False,
        verify_color_zscore: bool = False,
        refine_bank: Optional[RefineBank] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.det = detector
        self.class_ids = list(class_ids or detector.class_ids())
        self.icp = icp or IcpConfig()
        self.max_refine = max_refine
        self.icp_seeds = int(icp_seeds)
        self.seed_step_deg = float(seed_step_deg)
        self.seed_flip = bool(seed_flip)
        self.K = torch.from_numpy(np.asarray(K, np.float32)).to(self.device)
        self.mc = MultiClassMatcher(detector, self.class_ids, self.device)
        self.rb = refine_bank or self._refine_bank(num_points)
        if verify_pts is None:
            raise ValueError("verify_pts (class_id -> (P, 3) array) required")
        self.verify_pts, self.verify_valid, self.verify_colors = multiclass_verify_points(
            [np.asarray(verify_pts[c], np.float32) for c in self.class_ids],
            [verify_colors.get(c) for c in self.class_ids] if verify_colors is not None else None,
            self.device,
        )
        self.verify_tau = float(verify_tau)
        self.verify_color_weight = float(verify_color_weight)
        self.verify_color_zscore = bool(verify_color_zscore)

    def _refine_bank(self, num_points: int) -> RefineBank:
        per_class = []
        for cid in self.class_ids:
            fields = refine_bank_fields(self.det, cid, num_points)
            if fields is None:
                raise ValueError(
                    f"class {cid!r} lacks icp_points/pose infos; train with "
                    "render_train_templates or use the unfused serving path"
                )
            per_class.append(fields)
        return multiclass_refine_bank_from_numpy(per_class, self.device)

    @frame_entry
    def __call__(self, rgb, depth, threshold: float):
        """Returns (C, R) device tensors (tid_local, x, y, score, R, t_mm,
        fitness, verify, active), rows in ``class_ids`` order; nothing waits
        for the device after the images are uploaded."""
        with span("upload"):
            rgb_t = _image(rgb, torch.uint8, self.device)
            depth_t = _image(depth, torch.int32, self.device)
        return detect_refine_multiclass_core(
            rgb_t,
            depth_t,
            self.mc.bank,
            self.mc.pad_map,
            self.det.cfg,
            float(threshold),
            self.rb,
            self.icp,
            self.K,
            self.max_refine,
            self.verify_pts,
            self.verify_valid,
            self.verify_colors,
            self.verify_tau,
            self.verify_color_weight,
            self.icp_seeds,
            self.seed_step_deg,
            self.seed_flip,
            self.verify_color_zscore,
        )
