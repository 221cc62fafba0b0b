"""The plain reference of the service's multi-scale host route: one frame of
``PoseEstimationService.process_frame`` after ``enable_multiscale`` (the
camera loop of linemod_ros/detect.py at unknown distance), in plain PyTorch
and NumPy, float32 on the device and float64 on the host as the route
computes, TF32 off.

Per frame: the multi-scale match of every class with box NMS off
(``matcher.multiscale_multiclass_core``); the tiered per-class budget of
``max_refine`` hypotheses (each template's first occurrence, then the same
template's peaks at distant locations); each hypothesis's train-time cloud,
its bbox rescaled by the match's scale, and its seed moved to the median
scene depth under that bbox; the in-plane seed fan; batched ICP
(``refine.icp_batch``); each refined seed composed with its template pose and
verified (``refine.verify_poses_multi``); each hypothesis's best-verified
seed, the ``min_fitness`` and ``min_verify`` gates and the translation-space
dedupe (``matcher.nms_norms``).

Departures from the port's ``serving.py`` (none changes a number):

- The match runs the reference's one route (the coarse level by the
  shift-bucketed matmuls, the local refinement by the plain
  ``similarity_local_sparse``), where the port launches its kernels.
- The budget keeps matches by their index in the frame's list; the port
  tests membership by equality.  Equal matches share template and place, so
  the port's dedupe drops them alike.
- Only train-time clouds: every view of the benchmark's banks carries
  ``icp_points``, so the port's serve-time render is not copied.
- Every hypothesis verifies in one call, each class's points padded to the
  longest (``matcher.multiclass_verify_points``); the port calls once a
  matched class with that class's points shared.  Padded points take no
  part in any count, so each hypothesis's score is the same.

Imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import matcher as M
from perfbench.reference.config import DetectorConfig, IcpConfig
from perfbench.reference.refine import backproject, icp_batch, scene_chroma, scene_normals, verify_poses_multi
from perfbench.reference.scale_proposal import bin_centers

BINS = (100, 400, 2000)  # the service's depth histogram (bin, lo, hi mm), the matcher's default


@dataclasses.dataclass(frozen=True)
class Match:
    class_id: str
    template_id: int
    x: int
    y: int
    similarity: float
    scale: float


@dataclasses.dataclass
class Route:
    """The route's bank and settings: the classes' ``MultiScaleBank``, each
    depth bin's feature scale, the template infos (``icp_points``,
    ``icp_colors``, ``cam_R_w2c``, ``cam_t_w2c``, ``render_bbox``,
    ``anchor_depth``) and verification points of every class, and the
    service's settings at their defaults where the deployment states none."""

    class_ids: List[str]
    infos: List[List[dict]]
    bank: M.MultiScaleBank
    bin_scales: torch.Tensor
    verify: Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]
    K: np.ndarray  # (3, 3) float64
    cfg: DetectorConfig
    threshold: float
    num_scales: int
    max_refine: int
    icp: IcpConfig
    icp_seeds: int = 1
    seed_flip: bool = False
    min_fitness: float = 0.5
    min_verify: float = 0.0
    verify_tau: float = 15.0
    verify_color_weight: float = 0.5
    dedupe_radius_mm: float = 40.0
    rank_key: str = "verify"


def build_route(class_ids: Sequence[str], templates, infos, meshes: Dict[str, dict], K, train_depth_mm: float,
                cfg: DetectorConfig, threshold: float, num_scales: int, max_refine: int, icp: IcpConfig,
                icp_seeds: int, device) -> Route:
    """The ``Route`` of a bank: per class its templates (per view, per level
    ``TemplateLevel``), their infos and its mesh (mm, per-vertex colours).
    Turns TF32 off: the route computes in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bin_scales = (float(train_depth_mm) / bin_centers(*BINS)).astype(np.float32)
    bank = M.multiscale_bank(templates, float(bin_scales.max()), cfg.t_at_level[-1], device)
    vp = [M.verify_points_from_mesh(meshes[c]) for c in class_ids]
    verify = M.multiclass_verify_points([p for p, _ in vp], [c for _, c in vp], device)
    return Route(list(class_ids), infos, bank, torch.from_numpy(bin_scales).to(device), verify,
                 np.asarray(K, np.float64), cfg, float(threshold), int(num_scales), int(max_refine), icp,
                 int(icp_seeds))


def matches(route: Route, rgb_t: torch.Tensor, depth_t: torch.Tensor) -> List[Match]:
    """The frame's matches above the threshold, best first (ties in class,
    then candidate order)."""
    res = M.multiscale_multiclass_core(rgb_t, depth_t, route.bank, route.bin_scales, route.cfg, route.threshold,
                                       route.num_scales, route.cfg.top_k, False, BINS)
    tid, x, y, score, keep, _, scale = (a.to(torch.float64).cpu().numpy() for a in res)
    out = [Match(cid, int(tid[ci, i]), int(x[ci, i]), int(y[ci, i]), float(score[ci, i]), float(scale[ci, i]))
           for ci, cid in enumerate(route.class_ids) for i in range(tid.shape[1])
           if keep[ci, i] and score[ci, i] >= 0]
    out.sort(key=lambda m: -m.similarity)
    return out


def _info(route: Route, m: Match) -> dict:
    return route.infos[route.class_ids.index(m.class_id)][m.template_id]


def budget(route: Route, ms: List[Match]) -> List[Match]:
    """The hypotheses: per class up to ``max_refine`` matches, first each
    template's first occurrence, then repeats of a template farther than half
    its scaled bbox from every kept one of that template; best first."""
    kept: Dict[str, List[int]] = {}
    for i, m in enumerate(ms):
        ks = kept.setdefault(m.class_id, [])
        if len(ks) < route.max_refine and all(ms[k].template_id != m.template_id for k in ks):
            ks.append(i)
    for i, m in enumerate(ms):
        ks = kept[m.class_id]
        if len(ks) >= route.max_refine or i in ks:
            continue
        scl = m.scale or 1.0
        bx0, by0, bx1, by1 = np.asarray(_info(route, m)["render_bbox"])
        bw, bh = max(float(bx1 - bx0) * scl, 8.0), max(float(by1 - by0) * scl, 8.0)
        if not any(ms[k].template_id == m.template_id and abs(ms[k].x - m.x) * 2 <= bw
                   and abs(ms[k].y - m.y) * 2 <= bh for k in ks):
            ks.append(i)
    out = [ms[i] for ks in kept.values() for i in ks]
    out.sort(key=lambda m: -m.similarity)
    return out


def _cloud(route: Route, m: Match, depth: np.ndarray):
    """A hypothesis's ICP cloud (P, 3) m, valid mask, colours, centroid and
    seed transform (4, 4) float32: the train-time cloud moved so that its
    centroid lies on the ray through the scaled bbox's centre at the median
    scene depth under that bbox."""
    h, w = depth.shape
    npts = route.icp.num_model_points
    info = _info(route, m)
    pts = np.asarray(info["icp_points"], np.float32)
    col = np.asarray(info["icp_colors"], np.float32)
    bx0, by0, bx1, by1 = np.asarray(info["render_bbox"])
    bw, bh = int(bx1 - bx0), int(by1 - by0)
    scl = m.scale or 1.0
    if scl != 1.0:
        bw, bh = int(round(bw * scl)), int(round(bh * scl))
    src_c = pts.mean(0)
    zs = depth[min(max(m.y, 0), h - 1) : min(max(m.y + bh + 1, 1), h),
               min(max(m.x, 0), w - 1) : min(max(m.x + bw + 1, 1), w)]
    zs = zs[zs > 0]
    z = float(np.median(zs)) / 1000.0 if len(zs) else float(info["anchor_depth"]) / 1000.0
    K = route.K
    u, v = m.x + bw / 2.0, m.y + bh / 2.0
    target = np.array([(u - K[0, 2]) / K[0, 0] * z, (v - K[1, 2]) / K[1, 1] * z, z])
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = target - src_c
    if len(pts) < npts:
        pad = npts - len(pts)
        cloud = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
        valid = np.concatenate([np.ones(len(pts), bool), np.zeros(pad, bool)])
        col = np.concatenate([col, np.zeros((pad, 3), np.float32)])
    else:
        sel = np.linspace(0, len(pts) - 1, npts).astype(np.int64)
        cloud, valid, col = pts[sel], np.ones(npts, bool), col[sel]
    return cloud, valid, col, src_c.astype(np.float32), T0


def _base(info: dict) -> np.ndarray:
    """The template pose as a 4 x 4 (z mm -> m, the reference quirk at
    linemodLevelup.cpp:37)."""
    base = np.eye(4)
    base[:3, :3] = info["cam_R_w2c"]
    base[:3, 3] = np.asarray(info["cam_t_w2c"]).flatten()
    base[2, 3] /= 1000.0
    return base


def served_frame(route: Route, rgb: np.ndarray, depth: np.ndarray, device) -> dict:
    """One frame: ``slots`` (class, template, x, y, scale) and ``scores`` of
    the hypotheses sent to ICP, their best seed's ``R`` (M, 3, 3), ``t`` (M, 3)
    mm, ``fitness`` and ``verify``, and the ``published`` estimates (class,
    template, x, y)."""
    up = lambda a, dt=np.float32: torch.from_numpy(np.ascontiguousarray(np.asarray(a, dt))).to(device)  # noqa: E731
    rgb_t, depth_t = up(rgb, np.uint8), up(depth, np.int32)
    hyps = budget(route, matches(route, rgb_t, depth_t))
    out = {"slots": [(m.class_id, m.template_id, m.x, m.y, round(m.scale, 6)) for m in hyps],
           "scores": np.array([m.similarity for m in hyps]), "R": np.zeros((0, 3, 3)), "t": np.zeros((0, 3)),
           "fitness": np.zeros(0), "verify": np.zeros(0), "published": []}
    if not hyps:
        return out
    clouds, valids, cols, srcs, inits = (np.stack(a) for a in zip(*(_cloud(route, m, depth) for m in hyps)))

    s_n = max(1, route.icp_seeds)
    K_t = up(route.K)
    init_T = M._inplane_seed_transforms(up(inits), up(srcs), s_n, 18.0, route.seed_flip)
    rep = lambda a: np.repeat(a, s_n, axis=0)  # noqa: E731
    sp = backproject(depth_t, K_t)
    sn = scene_normals(sp)
    icp = route.icp
    use_color = icp.color_weight > 0.0
    chroma = cols[..., :2] / np.maximum(cols.sum(-1, keepdims=True), 1e-6)
    Ts, fits, _ = icp_batch(
        up(rep(clouds)), up(rep(valids), bool), sp, sn, K_t, init_T, icp.corr_dist, icp.max_iters,
        icp.coarse_gate_mult, model_chroma=up(rep(chroma)) if use_color else None,
        chroma_maps=scene_chroma(rgb_t) if use_color else None, color_weight=icp.color_weight,
        chroma_scale=icp.chroma_scale, point_weight=icp.point_weight, lm_damping=icp.lm_damping,
        bilinear_iters=icp.bilinear_iters, coarse_points=icp.coarse_points,
    )
    Ts = Ts.cpu().numpy().astype(np.float64)
    fits = fits.cpu().numpy()
    results = Ts @ rep(np.stack([_base(_info(route, m)) for m in hyps]))

    v_pts, v_valid, v_col = route.verify
    of = torch.from_numpy(rep(np.array([route.class_ids.index(m.class_id) for m in hyps]))).to(device)
    ver = verify_poses_multi(
        v_pts[of], v_valid[of], up(results[:, :3, :3]), up(results[:, :3, 3] * 1000.0), depth_t, K_t,
        tau_mm=route.verify_tau, model_colors=v_col[of] if v_col is not None else None,
        rgb=rgb_t if v_col is not None else None, color_weight=route.verify_color_weight,
    ).cpu().numpy().astype(np.float64)

    n = len(hyps)
    rank = np.where(ver >= 0, ver * 100.0 + np.maximum(fits, 0.0), fits)
    best = rank.reshape(n, s_n).argmax(axis=1) + np.arange(n) * s_n
    R, t, fits, ver = results[best, :3, :3], results[best, :3, 3] * 1000.0, fits[best], ver[best]
    ests = [M.PoseEstimate(m.class_id, m.template_id, m.x, m.y, m.similarity, R[i], t[i].reshape(3, 1),
                           float(fits[i]), float(ver[i]))
            for i, m in enumerate(hyps) if fits[i] >= route.min_fitness and ver[i] >= route.min_verify]
    kept = M.nms_norms(ests, route.dedupe_radius_mm, key=route.rank_key)
    out.update(R=R, t=t, fitness=fits, verify=ver,
               published=[(e.class_id, e.template_id, e.x, e.y) for e in kept])
    return out
