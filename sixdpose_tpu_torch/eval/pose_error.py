"""Pose-error metrics: VSD, ADD, ADI, COU, re, te.

Port of the JAX package's ``eval/pose_error.py`` (reference:
pysixd/pose_error.py, Hodan et al., "On Evaluation of 6D Object Pose
Estimation", ECCVW 2016):

- depth renders come from the port's rasterizer (``geometry/render.py``);
- ADI's nearest neighbour is an explicit chunked difference-square-sum-min
  (not ``torch.cdist``, whose matmul form rounds differently);
- sums run in a fixed order (``_tree_sum``), so the CPU and the card agree.

Every metric runs on ``device``: CUDA by default, raising when there is
none; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.eval.misc import depth_im_to_dist_im
from sixdpose_tpu_torch.geometry.render import render
from sixdpose_tpu_torch.models.refine import _norm, _sum_last, _tree_sum
from sixdpose_tpu_torch.ops.sqrt import sqrt32

# ---------------------------------------------------------------------------
# Visibility masks (reference: pysixd/visibility.py:6-31)
# ---------------------------------------------------------------------------


def estimate_visib_mask(d_test: torch.Tensor, d_model: torch.Tensor, delta: float):
    valid = (d_test > 0) & (d_model > 0)
    return valid & ((d_model - d_test) <= delta)


def estimate_visib_mask_gt(d_test, d_gt, delta):
    return estimate_visib_mask(d_test, d_gt, delta)


def estimate_visib_mask_est(d_test, d_est, visib_gt, delta):
    v = estimate_visib_mask(d_test, d_est, delta)
    return v | (visib_gt & (d_est > 0))


# ---------------------------------------------------------------------------
# Point metrics
# ---------------------------------------------------------------------------


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(device)


def _posed(pts: torch.Tensor, R, t, device) -> torch.Tensor:
    """(N, 3) points at pose (R, t): ``pts @ R.T + t`` with the products
    added in order."""
    R, t = _f32(R, device), _f32(t, device).reshape(1, 3)
    out = pts[:, 0:1] * R[:, 0]
    for j in (1, 2):
        out = out + pts[:, j : j + 1] * R[:, j]
    return out + t


def add(R_est, t_est, R_gt, t_gt, model, device=None) -> float:
    """Average distance of model points (pose_error.py:117-131)."""
    device = resolve_device(device)
    pts = _f32(model["pts"], device)
    d = _norm(_posed(pts, R_est, t_est, device) - _posed(pts, R_gt, t_gt, device))
    return float(_tree_sum(d, 0) / _tree_sum(torch.ones_like(d), 0))


def adi(R_est, t_est, R_gt, t_gt, model, max_pts: Optional[int] = None, device=None, chunk: int = 1024) -> float:
    """Average distance to the nearest model point (pose_error.py:133-152).

    ``max_pts`` subsamples the cloud deterministically for speed (None =
    exact, same as the reference's cKDTree query over all points).  The
    ground-truth points go in static chunks of ``chunk``, each against
    every estimated point."""
    device = resolve_device(device)
    pts_np = np.asarray(model["pts"], np.float32)
    if max_pts is not None and len(pts_np) > max_pts:
        sel = np.linspace(0, len(pts_np) - 1, max_pts).astype(np.int64)
        pts_np = pts_np[sel]
    pts = _f32(pts_np, device)
    pe = _posed(pts, R_est, t_est, device)
    pg = _posed(pts, R_gt, t_gt, device)
    dists = []
    for s in range(0, pg.shape[0], chunk):
        g = pg[s : s + chunk]
        d2 = _sum_last((g[:, None, :] - pe[None, :, :]) ** 2)
        dists.append(sqrt32(d2.amin(1)))
    n = pg.shape[0]
    return float(_tree_sum(torch.cat(dists), 0) / _tree_sum(torch.ones((n,), device=device), 0))


def re(R_est, R_gt) -> float:
    """Rotational error in degrees (pose_error.py:154-167)."""
    c = 0.5 * (np.trace(np.asarray(R_est) @ np.linalg.inv(np.asarray(R_gt))) - 1.0)
    return float(180.0 / np.pi * math.acos(min(1.0, max(-1.0, c))))


def te(t_est, t_gt) -> float:
    """Translational error (pose_error.py:169-178)."""
    return float(np.linalg.norm(np.asarray(t_gt).flatten() - np.asarray(t_est).flatten()))


# ---------------------------------------------------------------------------
# Render-based metrics
# ---------------------------------------------------------------------------


def _render(model, im_size, K, R, t, clip_near, clip_far, device):
    # The host wrapper handles adaptive mesh subdivision (+ caching) so
    # large triangles are never silently dropped by the fixed raster tile.
    return render(model, tuple(im_size), K, R, t, clip_near, clip_far, mode="depth", device=device)


def _vsd(d_test, d_est, d_gt, K, delta, tau, cost_type):
    """The VSD error of three depth images (pose_error.py:12-81) as a
    0-dim float32 tensor."""
    dist_test = depth_im_to_dist_im(d_test, K)
    dist_est = depth_im_to_dist_im(d_est, K)
    dist_gt = depth_im_to_dist_im(d_gt, K)
    visib_gt = estimate_visib_mask_gt(dist_test, dist_gt, delta)
    visib_est = estimate_visib_mask_est(dist_test, dist_est, visib_gt, delta)
    inter = visib_gt & visib_est
    union = visib_gt | visib_est
    diff = (dist_gt - dist_est).abs()
    tau_t = torch.full((), float(tau), dtype=torch.float32, device=d_test.device)
    if cost_type == "step":
        costs = (diff >= tau_t).to(torch.float32)
    elif cost_type == "tlinear":
        costs = (diff / tau_t).clamp(max=1.0)
    else:
        raise ValueError(f"unknown cost type {cost_type!r}")
    union_count = union.sum()
    inter_count = inter.sum()
    cost_sum = _tree_sum(torch.where(inter, costs, 0.0).reshape(-1), 0)
    e = (cost_sum + (union_count - inter_count).to(torch.float32)) / union_count.clamp(min=1).to(torch.float32)
    return torch.where(union_count > 0, e, 1.0)


def vsd(
    R_est,
    t_est,
    R_gt,
    t_gt,
    model,
    depth_test,
    K,
    delta: float,
    tau: float,
    cost_type: str = "tlinear",
    device=None,
) -> float:
    """Visible Surface Discrepancy (pose_error.py:12-81).

    SIXD-2017 protocol uses delta=15, tau=20, cost_type='step'
    (tools/eval_calc_errors.py:34-42)."""
    device = resolve_device(device)
    im_size = (depth_test.shape[1], depth_test.shape[0])
    d_est = _render(model, im_size, K, R_est, t_est, 100.0, 10000.0, device)
    d_gt = _render(model, im_size, K, R_gt, t_gt, 100.0, 10000.0, device)
    if isinstance(depth_test, torch.Tensor):
        d_test = depth_test.to(device=device, dtype=torch.float32)
    else:
        d_test = _f32(depth_test, device)
    return float(_vsd(d_test, d_est, d_gt, _f32(K, device), float(delta), float(tau), cost_type))


def cou(R_est, t_est, R_gt, t_gt, model, im_size, K, device=None) -> float:
    """Complement over union of rendered masks (pose_error.py:83-115)."""
    device = resolve_device(device)
    me = _render(model, im_size, K, R_est, t_est, 100.0, 10000.0, device) > 0
    mg = _render(model, im_size, K, R_gt, t_gt, 100.0, 10000.0, device) > 0
    union = float((me | mg).sum())
    if union == 0:
        return 1.0
    return 1.0 - float((me & mg).sum()) / union
