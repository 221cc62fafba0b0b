"""Batched point-to-plane ICP pose refinement and pose verification.

Port of the JAX package's ``models/refine.py``.  Reference:
``poseRefine::process`` (linemodLevelup.cpp:27-170) backprojects the
rendered model depth and a scene-depth crop to point clouds, seeds the pose
with a centroid shift and runs Open3D point-to-plane ICP (threshold
0.01 m), returning the refined R, t (mm) and the ICP fitness as
``residual``.  As in the JAX package, correspondences come by projective
data association (each transformed model point is projected with the scene
intrinsics and matched to the scene point at that pixel), scene normals
come from depth-image derivatives, and every candidate's Gauss-Newton
system is solved at once.

Here the solver is written natively batched over K candidates, with
(K, N, 3) clouds and plain tensor ops on the device of its inputs:

- the scene maps are packed into one (H*W, 7) table (points | normals |
  valid) and one (H*W, 6) chroma table, so an association tap is one row
  gather;
- the 6x6 normal equations are elementwise products summed over the
  points (no matmul, so no TF32 on the card), and are solved by
  ``_solve_spd``: ``torch.linalg.solve`` checks for singular inputs on the
  host and would wait for the device every iteration;
- the box filters of the scene maps are shifted adds in the JAX loop order
  (no convolution, which cuDNN would run in TF32);
- every divisor that the JAX code holds as an array stays a tensor (a
  Python scalar divisor becomes a multiply by its reciprocal on CUDA);
- the per-iteration scalars of the gate and colour schedules are float32
  values computed on the host, the same for every device;
- every sum has a fixed order (``_tree_sum`` over the points, in-order
  adds over short axes), sin and cos are evaluated in float64 and
  rounded, and sqrt is ``ops/sqrt.py``'s correctly rounded one, so the
  card and the CPU give the same bits.  ICP's inlier gate
  turns a one-ulp difference into millimetres wherever ICP does not
  converge, so "close" between devices is only reachable as "equal".

On the card ``icp_batch`` runs all of that as one kernel (``csrc/icp.cu``
via ``ops/icp.py``), which repeats ``icp_batch_plain``'s operations in
their order and so gives its bits; CPU tensors run ``icp_batch_plain``.

Nothing here waits for the device.  Conventions match the reference:
depths in mm, poses R (3, 3) + t mm, ``fitness`` the inlier fraction of
the valid model points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sixdpose_tpu_torch.config import IcpConfig
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.ops.icp import icp_cuda, pack_chroma, pack_scene
from sixdpose_tpu_torch.ops.sqrt import sqrt32


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 0-dim tensor on the device of ``like``.  Dividing
    by it is a true division on CUDA too."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _shifter(a: torch.Tensor, r: int):
    """``sh(dy, dx)`` = ``_shift2d(a, dy, dx)`` for |dy|, |dx| <= r, as views
    of one zero-padded copy of ``a``."""
    h, w = a.shape[0], a.shape[1]
    p = F.pad(a, (0, 0) * (a.dim() - 2) + (r, r, r, r))

    def sh(dy: int, dx: int) -> torch.Tensor:
        return p[r - dy : r - dy + h, r - dx : r - dx + w]

    return sh


def _shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift the leading two (H, W) axes by (dy, dx) with ZERO fill:
    result[y, x] = a[y - dy, x - dx], zeros outside the frame (never wraps
    opposite borders into each other)."""
    return _shifter(a, max(abs(dy), abs(dx)))(dy, dx)


def _box_sum(a: torch.Tensor, r: int) -> torch.Tensor:
    """Zero-filled (2r+1)^2 box sum over the leading (H, W) axes, the taps
    added in the JAX loop order (dy outer, dx inner)."""
    sh = _shifter(a, r)
    out = None
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out = sh(dy, dx) if out is None else out + sh(dy, dx)
    return out


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in a fixed order: zero-padded to a power of two, then
    halved by elementwise adds.  ``torch.sum`` orders its adds differently
    on each device; this gives the same bits on every device."""
    n = x.shape[dim]
    size = 1 << (n - 1).bit_length() if n > 1 else 1
    if size != n:
        pad = list(x.shape)
        pad[dim] = size - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while x.shape[dim] > 1:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
    return x.squeeze(dim)


def _sum_last(a: torch.Tensor) -> torch.Tensor:
    """Sum over a short last axis, added in order."""
    out = a[..., 0]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i]
    return out


def _norm(a: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, summed in order."""
    n = sqrt32(_sum_last(a * a))
    return n[..., None] if keepdim else n


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _skew(k: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [k]x."""
    k0, k1, k2 = k.unbind(-1)
    z = torch.zeros_like(k0)
    return torch.stack([z, -k2, k1, k2, z, -k0, -k1, k0, z], dim=-1).reshape(*k.shape[:-1], 3, 3)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched small matrix product (..., m, n) @ (..., n, p), as
    elementwise products added in order: float32 throughout (never a TF32
    matmul) and the same bits on every device."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for i in range(1, a.shape[-1]):
        out = out + a[..., :, i : i + 1] * b[..., i : i + 1, :]
    return out


def _matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., m, n) @ (..., n) -> (..., m), added in order."""
    out = a[..., :, 0] * x[..., 0:1]
    for i in range(1, a.shape[-1]):
        out = out + a[..., :, i] * x[..., i : i + 1]
    return out


def _rigid(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(K, 3, 3) rotations and (K, 3) translations applied to (K, N, 3)
    points."""
    return _matvec(R[:, None], pts) + t[:, None, :]


def _sin_cos(x: torch.Tensor):
    """float32 sin and cos, evaluated in float64 and rounded: the float32
    functions of different devices differ in the last bit."""
    x64 = x.to(torch.float64)
    return torch.sin(x64).to(torch.float32), torch.cos(x64).to(torch.float32)


def backproject(depth_mm: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(H, W) integer depth in mm -> (H, W, 3) float32 points in meters."""
    h, w = depth_mm.shape
    z = depth_mm.to(torch.float32) / _scalar(1000.0, K)
    u = torch.arange(w, dtype=torch.float32, device=K.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=K.device)[:, None]
    x = (u - K[0, 2]) / K[0, 0] * z
    y = (v - K[1, 2]) / K[1, 1] * z
    return torch.stack([x, y, z], dim=-1)


def scene_normals(points: torch.Tensor, edge_thresh: float = 0.02) -> torch.Tensor:
    """Per-pixel normals from the smoothed point map (replaces Open3D
    EstimateNormals, cpp:127): a validity-masked 3x3 box smoothing, a
    +-2 px central difference, and zero normals at depth discontinuities
    (a +-2 px neighbour more than ``edge_thresh`` m away in z).

    Normals are unit length, oriented toward the camera (n_z < 0), and
    zero where invalid.
    """
    z = points[..., 2:3]
    valid0 = (z > 0).to(torch.float32)
    num = _box_sum(points * valid0, 1)
    den = _box_sum(valid0, 1)
    sm = num / den.clamp(min=1.0)
    sm = torch.where(valid0 > 0, sm, 0.0)

    sh = _shifter(sm, 2)
    xp, xm, yp, ym = sh(0, -2), sh(0, 2), sh(-2, 0), sh(2, 0)
    n = _cross(xp - xm, yp - ym)
    norm = _norm(n, keepdim=True)
    n = n / norm.clamp(min=1e-12)
    n = n * torch.sign(-n[..., 2:3] + 1e-12)

    neigh_ok = (
        ((xp[..., 2:3] - z).abs() < edge_thresh)
        & ((xm[..., 2:3] - z).abs() < edge_thresh)
        & ((yp[..., 2:3] - z).abs() < edge_thresh)
        & ((ym[..., 2:3] - z).abs() < edge_thresh)
        & (xp[..., 2:3] > 0)
        & (xm[..., 2:3] > 0)
        & (yp[..., 2:3] > 0)
        & (ym[..., 2:3] > 0)
    )
    valid = (z > 0) & (norm > 1e-9) & neigh_ok
    return torch.where(valid, n, 0.0)


def scene_chroma(rgb: torch.Tensor, blur: int = 2):
    """(H, W, 3) uint8 -> lighting-normalized chroma (H, W, 2) float32 (r and
    g shares), validity-masked box-blurred by +-``blur`` px, plus its
    pixel-space central-difference gradients (each (H, W, 2)), zero where
    any sample of the stencil is invalid (dark)."""
    f = rgb.to(torch.float32)
    bright = f.sum(-1, keepdim=True)  # sums of three small integers: exact
    valid = (bright > 40.0).to(torch.float32)
    c = f[..., :2] / bright.clamp(min=1e-6)
    if blur > 0:
        c = _box_sum(c * valid, blur) / _box_sum(valid, blur).clamp(min=1.0)
    c = torch.where(valid > 0, c, 0.0)
    sh = _shifter(c, 1)
    du = (sh(0, -1) - sh(0, 1)) * 0.5
    dv = (sh(-1, 0) - sh(1, 0)) * 0.5
    shv = _shifter(valid, 1)
    ok = valid * shv(0, 1) * shv(0, -1) * shv(1, 0) * shv(-1, 0)
    return c, du * ok, dv * ok


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta = _norm(w, keepdim=True) + 1e-12
    kx = _skew(w / theta)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    sin, cos = _sin_cos(theta[..., None])
    return eye + sin * kx + (1.0 - cos) * _matmul(kx, kx)


def _solve_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve the batched symmetric positive definite systems H x = g,
    (K, n, n) and (K, n), by Gauss-Jordan elimination without pivoting, in
    plain tensor ops that never wait for the device."""
    n = H.shape[-1]
    A = torch.cat([H, g[..., None]], dim=-1)
    for k in range(n):
        row = A[:, k : k + 1, :] / A[:, k : k + 1, k : k + 1]
        A = A - A[:, :, k : k + 1] * row
        A[:, k : k + 1, :] = row  # A is this iteration's own tensor
    return A[:, :, n]


def sample_model_points(
    model_depth_mm: np.ndarray,
    model_K: np.ndarray,
    num_points: int,
    return_pixels: bool = False,
):
    """Host-side fixed-size sample of the rendered model cloud (meters).

    Returns (num_points, 3) points and (num_points,) validity mask (padded
    slots invalid).  Deterministic stride sampling over valid pixels.
    With ``return_pixels`` also returns the (ys, xs) pixel coordinates of
    the valid samples (e.g. to pick up their rendered colors).
    """
    ys, xs = np.nonzero(model_depth_mm > 0)
    n = len(ys)
    if n == 0:
        empty = (np.zeros((num_points, 3), np.float32), np.zeros(num_points, bool))
        return empty + ((ys, xs),) if return_pixels else empty
    if n > num_points:
        sel = np.linspace(0, n - 1, num_points).astype(np.int64)
        ys, xs = ys[sel], xs[sel]
    z = model_depth_mm[ys, xs].astype(np.float64) / 1000.0
    x = (xs - model_K[0, 2]) / model_K[0, 0] * z
    y = (ys - model_K[1, 2]) / model_K[1, 1] * z
    pts = np.stack([x, y, z], 1).astype(np.float32)
    valid = np.ones(len(pts), bool)
    if len(pts) < num_points:
        pad = num_points - len(pts)
        pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    if return_pixels:
        return pts, valid, (ys, xs)
    return pts, valid


class _SceneLookup:
    """Projective association of (K, N, 3) camera-frame points with the
    packed scene maps."""

    def __init__(self, scene_pts, scene_nrm, scene_K):
        self.h, self.w = scene_pts.shape[:2]
        # ONE packed (H*W, 7) table (points | normals | valid): a tap is one
        # row gather instead of three.
        self.packed = pack_scene(scene_pts, scene_nrm)
        self.fx, self.fy = scene_K[0, 0], scene_K[1, 1]
        self.cx, self.cy = scene_K[0, 2], scene_K[1, 2]

    def project(self, p):
        u = p[..., 0] / p[..., 2] * self.fx + self.cx
        v = p[..., 1] / p[..., 2] * self.fy + self.cy
        inb = (u >= 0) & (u <= self.w - 1) & (v >= 0) & (v <= self.h - 1) & (p[..., 2] > 1e-6)
        return u, v, inb

    def pixel(self, u, v):
        """Nearest pixel's flat index; the int cast comes before the clip,
        as in JAX, and a non-finite projection is masked by the caller."""
        ur = torch.round(u).to(torch.int32).clamp(0, self.w - 1)
        vr = torch.round(v).to(torch.int32).clamp(0, self.h - 1)
        return vr * self.w + ur

    def gather(self, table, idx):
        return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, table.shape[-1])

    def nearest(self, p):
        """One gather per point (the early, wide-gate iterations)."""
        u, v, inb = self.project(p)
        tap = self.gather(self.packed, self.pixel(u, v))
        ok = inb & (tap[..., 6] > 0.5)
        q = torch.where(ok[..., None], tap[..., :3], 0.0)
        n = torch.where(ok[..., None], tap[..., 3:6], 0.0)
        return q, n, ok

    def bilinear(self, p):
        """Validity-weighted bilinear scene point and normal at the
        projection; normals re-normalize after blending (the final
        iterations and the fitness)."""
        u, v, inb = self.project(p)
        u0 = torch.floor(u).to(torch.int32).clamp(0, self.w - 1)
        v0 = torch.floor(v).to(torch.int32).clamp(0, self.h - 1)
        u1 = (u0 + 1).clamp(max=self.w - 1)
        v1 = (v0 + 1).clamp(max=self.h - 1)
        fu = (u - u0).clamp(0.0, 1.0)
        fv = (v - v0).clamp(0.0, 1.0)
        # The four taps in the JAX order, gathered at once: (K, N, 4, 7).
        idx = torch.stack([v0 * self.w + u0, v0 * self.w + u1, v1 * self.w + u0, v1 * self.w + u1], dim=-1)
        wgt = torch.stack([(1 - fu) * (1 - fv), fu * (1 - fv), (1 - fu) * fv, fu * fv], dim=-1)
        tap = self.gather(self.packed, idx)
        wv = wgt[..., None] * tap[..., 6:7]
        # (wv q | wv n | wv valid = wv) summed over the taps in order.
        acc = _sum_last((wv * tap).transpose(-1, -2))
        qs, ns, ws = acc[..., :3], acc[..., 3:6], acc[..., 6:7]
        q = qs / ws.clamp(min=1e-9)
        nn = _norm(ns, keepdim=True)
        n = torch.where(nn > 1e-6, ns / nn.clamp(min=1e-9), 0.0)
        ok = inb & (ws[..., 0] > 0.5)
        q = torch.where(ok[..., None], q, 0.0)
        return q, n, ok


def icp_batch(
    model_pts: torch.Tensor,
    model_valid: torch.Tensor,
    scene_pts: torch.Tensor,
    scene_nrm: torch.Tensor,
    scene_K: torch.Tensor,
    init_T: torch.Tensor,
    corr_dist: float = 0.01,
    max_iters: int = 20,
    coarse_gate_mult: float = 3.0,
    model_chroma: Optional[torch.Tensor] = None,
    chroma_maps: Optional[tuple] = None,
    color_weight: float = 0.3,
    chroma_scale: float = 0.05,
    point_weight: float = 0.2,
    lm_damping: float = 1e-3,
    bilinear_iters: int = 8,
    coarse_points: int = 256,
):
    """Projective point-to-plane ICP of K candidates against one scene, all
    at once (the reference refines its top-K serially,
    linemod_and_levelup_test.py:354-376).

    Args:
      model_pts: (K, N, 3) model points (meters, render-camera frame).
      model_valid: (K, N) bool.
      scene_pts, scene_nrm: (H, W, 3) scene point and normal maps.
      scene_K: (3, 3) scene intrinsics.
      init_T: (K, 4, 4) initial model->scene transforms.
      corr_dist: final correspondence gate in meters (cpp:31); the gate
        starts at ``coarse_gate_mult * corr_dist`` and decays geometrically
        to it by the last iteration.
      max_iters: Gauss-Newton iterations; the first ``max_iters -
        bilinear_iters`` use nearest-pixel association on a strided
        ~``coarse_points`` subset of each cloud, the rest bilinear
        association on the full cloud.
      model_chroma / chroma_maps: (K, N, 2) model chroma and the scene's
        ``scene_chroma`` maps enable the colored-ICP term (an annealed
        Geman-McClure weight, ``color_weight`` ramping up with the
        iterations).
      point_weight: point-to-point blend that pins the in-plane null space
        of projective point-to-plane.
      lm_damping: Levenberg-Marquardt diagonal damping.

    Returns (T (K, 4, 4), fitness (K,), inlier rmse (K,)).  A candidate with
    fewer than 6 inliers keeps its pose in that iteration.

    CUDA tensors run the ICP kernel (``ops/icp.py``, one launch a call),
    CPU tensors ``icp_batch_plain``; both give the same bits.
    """
    if model_pts.is_cuda:
        # The kernel reads dense rows (a no-op for contiguous inputs).
        model_pts, model_valid, scene_K, init_T = (x.contiguous() for x in (model_pts, model_valid, scene_K, init_T))
        model_chroma = None if model_chroma is None else model_chroma.contiguous()
    run = icp_cuda if model_pts.is_cuda else icp_batch_plain
    return run(
        model_pts, model_valid, scene_pts, scene_nrm, scene_K, init_T, corr_dist=corr_dist, max_iters=max_iters,
        coarse_gate_mult=coarse_gate_mult, model_chroma=model_chroma, chroma_maps=chroma_maps,
        color_weight=color_weight, chroma_scale=chroma_scale, point_weight=point_weight, lm_damping=lm_damping,
        bilinear_iters=bilinear_iters, coarse_points=coarse_points,
    )


def icp_batch_plain(model_pts, model_valid, scene_pts, scene_nrm, scene_K, init_T, *, corr_dist, max_iters,
                    coarse_gate_mult, model_chroma, chroma_maps, color_weight, chroma_scale, point_weight, lm_damping,
                    bilinear_iters, coarse_points):
    """``icp_batch`` in plain tensor ops (arguments and results as there,
    which holds the defaults): the plain version of the ICP kernel
    (``csrc/icp.cu``), run for CPU tensors and on the card in tests and
    ``chip_smoke.py``."""
    scene = _SceneLookup(scene_pts, scene_nrm, scene_K)
    use_color = model_chroma is not None and chroma_maps is not None
    chr_packed = pack_chroma(chroma_maps) if use_color else None
    k_n = model_pts.shape[0]
    eye3 = torch.eye(3, dtype=torch.float32, device=model_pts.device)
    eye4 = torch.eye(4, dtype=torch.float32, device=model_pts.device)
    eye6 = torch.eye(6, dtype=torch.float32, device=model_pts.device)

    def step(i, T, lookup, pts, pvalid, pchroma):
        # The schedules in float32, as the JAX code traces them.
        frac = np.float32(i) / np.float32(max(max_iters - 1, 1))
        gate = np.float32(corr_dist) * np.float32(coarse_gate_mult) ** (np.float32(1.0) - frac)
        p = _rigid(T[:, :3, :3], T[:, :3, 3], pts)
        q, n, inb = lookup(p)
        d = p - q
        r = _sum_last(d * n)
        good = pvalid & inb & (q[..., 2] > 0) & (_norm(d) < float(gate)) & (_norm(n) > 0.5)
        wgt = good.to(torch.float32)
        # Every sum over the points is a _tree_sum, so a frame gives the same
        # bits on every device: the inlier count and centroid first, then
        # the normal equations summed per point and reduced once.
        s1 = _tree_sum(torch.cat([wgt[..., None], p * wgt[..., None]], dim=-1), dim=1)
        n_in = s1[:, 0]
        # Rotate about the inlier centroid, not the camera origin.
        c = s1[:, 1:] / n_in.clamp(min=1.0)[:, None]
        pc = p - c[:, None, :]
        a = torch.cat([_cross(pc, n), n], dim=-1)  # (K, N, 6)
        aw = a * wgt[..., None]
        h_pt = aw[..., :, None] * a[..., None, :]  # (K, N, 6, 6)
        g_pt = aw * (-r)[..., None]
        # Point-to-point blend, J = [-[pc]x | I].
        jpt = torch.cat([-_skew(pc), eye3.expand(*pc.shape[:2], 3, 3)], dim=-1)  # (K, N, 3, 6)
        jwt = (jpt * wgt[..., None, None]).transpose(-1, -2)
        h_pt = h_pt + point_weight * _matmul(jwt, jpt)
        g_pt = g_pt + point_weight * _matvec(jwt, -d)
        if use_color:
            w_col = np.float32(color_weight) * frac
            sigma = np.float32(0.5) * np.float32(0.2) ** frac
            pz = p[..., 2].clamp(min=1e-6)
            u = p[..., 0] / pz * scene.fx + scene.cx
            v = p[..., 1] / pz * scene.fy + scene.cy
            ct = scene.gather(chr_packed, scene.pixel(u, v))  # c | du | dv
            rc = (ct[..., 0:2] - pchroma) * chroma_scale
            gu = ct[..., 2:4] * chroma_scale
            gv = ct[..., 4:6] * chroma_scale
            zero = torch.zeros_like(pz)
            dudp = torch.stack([scene.fx / pz, zero, -scene.fx * p[..., 0] / (pz * pz)], dim=-1)
            dvdp = torch.stack([zero, scene.fy / pz, -scene.fy * p[..., 1] / (pz * pz)], dim=-1)
            dcdp = gu[..., :, None] * dudp[..., None, :] + gv[..., :, None] * dvdp[..., None, :]  # (K, N, 2, 3)
            jc = _matmul(dcdp, jpt)  # (K, N, 2, 6)
            cbright = _sum_last(ct[..., 0:2]) > 1e-6
            rmag = _sum_last(rc.abs()) / _scalar(float(sigma * np.float32(chroma_scale)), p)
            cw = wgt * cbright.to(torch.float32) / (1.0 + rmag * rmag)
            jcwt = (jc * cw[..., None, None]).transpose(-1, -2)
            h_pt = h_pt + float(w_col) * _matmul(jcwt, jc)
            g_pt = g_pt + float(w_col) * _matvec(jcwt, -rc)
        s2 = _tree_sum(torch.cat([h_pt.reshape(*h_pt.shape[:2], 36), g_pt], dim=-1), dim=1)
        H, g = s2[:, :36].reshape(-1, 6, 6), s2[:, 36:]
        H = H + lm_damping * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-9 * eye6
        xi = _solve_spd(H, g)
        dR = _so3_exp(xi[:, :3])
        dt = c - _matvec(dR, c) + xi[:, 3:]
        dT = torch.cat([torch.cat([dR, dt[..., None]], dim=-1), eye4[3:].expand(k_n, 1, 4)], dim=-2)
        return torch.where((n_in >= 6)[:, None, None], _matmul(dT, T), T)

    n_bi = max(0, min(int(bilinear_iters), max_iters))
    n_near = max_iters - n_bi
    stride = max(1, model_pts.shape[1] // max(coarse_points, 8))
    coarse = (
        model_pts[:, ::stride],
        model_valid[:, ::stride],
        model_chroma[:, ::stride] if use_color else None,
    )
    T = init_T
    for i in range(n_near):
        T = step(i, T, scene.nearest, *coarse)
    for i in range(n_near, max_iters):
        T = step(i, T, scene.bilinear, model_pts, model_valid, model_chroma)

    # Final fitness / rmse (reference residual = fitness, cpp:148).
    p = _rigid(T[:, :3, :3], T[:, :3, 3], model_pts)
    q, _, inb = scene.bilinear(p)
    dist = _norm(p - q)
    good = model_valid & inb & (q[..., 2] > 0) & (dist < corr_dist)
    n_good = good.sum(-1)
    fitness = n_good.to(torch.float32) / model_valid.sum(-1).clamp(min=1).to(torch.float32)
    rmse = sqrt32(_tree_sum(torch.where(good, dist * dist, 0.0), dim=1) / n_good.clamp(min=1).to(torch.float32))
    return T, fitness, rmse


def icp_point_to_plane(model_pts, model_valid, scene_pts, scene_nrm, scene_K, init_T, *args, **kwargs):
    """ICP of one candidate: (N, 3) points, (N,) validity, (4, 4) initial
    transform; the other arguments as ``icp_batch``.  Returns (T (4, 4),
    fitness, rmse) as 0-dim tensors."""
    if "model_chroma" in kwargs and kwargs["model_chroma"] is not None:
        kwargs["model_chroma"] = kwargs["model_chroma"][None]
    T, fitness, rmse = icp_batch(
        model_pts[None], model_valid[None], scene_pts, scene_nrm, scene_K, init_T[None], *args, **kwargs
    )
    return T[0], fitness[0], rmse[0]


def verify_poses(
    model_pts_mm: torch.Tensor,
    Rs: torch.Tensor,
    ts_mm: torch.Tensor,
    depth_mm: torch.Tensor,
    K: torch.Tensor,
    tau_mm: float = 15.0,
    cell: int = 4,
    model_colors: Optional[torch.Tensor] = None,
    rgb: Optional[torch.Tensor] = None,
    color_tau: float = 0.22,
    color_weight: float = 0.5,
    color_zscore: bool = False,
):
    """Depth(+color)-consistency verification of K poses of one point set
    (N, 3) model-frame mm; ``verify_poses_multi`` with the points (and
    colors) shared by every candidate.  Returns (K,) float32 in [0, 1]."""
    k_n, n = Rs.shape[0], model_pts_mm.shape[0]
    pts = model_pts_mm.expand(k_n, n, 3)
    valid = torch.ones((k_n, n), dtype=torch.bool, device=Rs.device)
    colors = model_colors.expand(k_n, n, 3) if model_colors is not None else None
    return verify_poses_multi(
        pts, valid, Rs, ts_mm, depth_mm, K, tau_mm, cell, colors, rgb, color_tau, color_weight,
        color_zscore=color_zscore,
    )


def verify_poses_multi(
    model_pts_mm: torch.Tensor,
    model_valid: torch.Tensor,
    Rs: torch.Tensor,
    ts_mm: torch.Tensor,
    depth_mm: torch.Tensor,
    K: torch.Tensor,
    tau_mm: float = 15.0,
    cell: int = 4,
    model_colors: Optional[torch.Tensor] = None,
    rgb: Optional[torch.Tensor] = None,
    color_tau: float = 0.22,
    color_weight: float = 0.5,
    color_zscore: bool = False,
):
    """Verification of K poses, each with its own padded point set.

    Project the (K, N, 3) model surface points (mm; ``model_valid`` False
    marks pad rows) at each pose (Rs (K, 3, 3), ts_mm (K, 3)), resolve
    self-occlusion with a per-candidate z-buffer over ``cell``-px bins
    (one scatter-min over a flat (K * (gh * gw + 1)) buffer), and score the
    fraction of front points whose scene depth agrees within ``tau_mm``.
    SIXD visibility masking: points the scene shows occluded leave the
    denominator, and a pose with less than 10% of its front points visible
    scores 0.  With ``model_colors`` (K, N, 3) and ``rgb`` (H, W, 3) the
    score is multiplied by (1 - w + w * color_frac), color_frac being the
    fraction of depth-agreeing bright points whose chromaticity (L1)
    matches within ``color_tau``; ``color_zscore`` weights each point's
    vote by the z-score of the model's chroma there (texture dominates,
    uniform colour collapses to the unweighted fraction).

    Returns (K,) float32 scores in [0, 1].
    """
    h, w = depth_mm.shape
    gh, gw = h // cell, w // cell
    k_n = Rs.shape[0]
    scene = depth_mm.to(torch.float32).reshape(-1)
    use_color = model_colors is not None and rgb is not None

    p = _rigid(Rs, ts_mm, model_pts_mm)
    z = p[..., 2]
    zc = z.clamp(min=1e-6)
    u = p[..., 0] / zc * K[0, 0] + K[0, 2]
    v = p[..., 1] / zc * K[1, 1] + K[1, 2]
    inb = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z > 10.0) & model_valid
    # Integer coordinates are pixel centres, so the nearest pixel is round.
    vr = torch.round(v).to(torch.int32).clamp(0, h - 1)
    ur = torch.round(u).to(torch.int32).clamp(0, w - 1)
    slots = gh * gw + 1
    offset = torch.arange(k_n, device=Rs.device, dtype=torch.int64)[:, None] * slots
    gi = torch.where(inb, (vr // cell) * gw + ur // cell, gh * gw).to(torch.int64) + offset
    inf = torch.full((), float("inf"), dtype=torch.float32, device=Rs.device)
    zbuf = torch.full((k_n * slots,), float("inf"), dtype=torch.float32, device=Rs.device)
    zbuf = zbuf.scatter_reduce(0, gi.reshape(-1), torch.where(inb, z, inf).reshape(-1), "amin", include_self=True)
    front = inb & (z <= zbuf[gi] + 2.0 * tau_mm)
    pix = vr * w + ur
    ds = scene[pix]

    measured = front & (ds > 0)
    occluded = measured & (ds - z <= -tau_mm)
    agree = measured & ((ds - z).abs() < tau_mm)
    n_front = front.sum(-1).clamp(min=1).to(torch.float32)
    n_vis = (front & ~occluded).sum(-1)
    vis_frac = n_vis.to(torch.float32) / n_front
    score = torch.where(
        vis_frac >= 0.1,
        agree.sum(-1).to(torch.float32) / n_vis.clamp(min=1).to(torch.float32),
        0.0,
    )
    if use_color:
        mc = model_colors.to(torch.float32)
        mcn = mc / _sum_last(mc)[..., None].clamp(min=1e-6)
        sc = rgb.to(torch.float32).reshape(-1, 3)[pix]
        bright = _sum_last(sc)
        scn = sc / bright[..., None].clamp(min=1e-6)
        cdist = _sum_last((scn - mcn).abs())
        considered = agree & (bright > 40.0)
        c_ok = considered & (cdist < color_tau)
        if color_zscore:
            nm = model_valid.sum(-1).clamp(min=1).to(torch.float32)[:, None]
            mu = _tree_sum(torch.where(model_valid[..., None], mcn, 0.0), dim=1) / nm
            dev = _sum_last((mcn - mu[:, None, :]).abs())
            sd = sqrt32(_tree_sum(torch.where(model_valid, dev * dev, 0.0), dim=1)[:, None] / nm)
            wgt = 0.25 + (dev / (sd + 1e-6)).clamp(0.0, 4.0)
            cfrac = _tree_sum(wgt * c_ok, dim=1) / _tree_sum(wgt * considered, dim=1).clamp(min=1e-6)
        else:
            cfrac = c_ok.sum(-1).to(torch.float32) / considered.sum(-1).clamp(min=1).to(torch.float32)
        score = score * (1.0 - color_weight + color_weight * cfrac)
    return score


def _scene_tensors(scene_depth: np.ndarray, scene_K: np.ndarray, device):
    depth = torch.from_numpy(np.asarray(scene_depth).astype(np.int32)).to(device)
    K = torch.from_numpy(np.asarray(scene_K, np.float32)).to(device)
    return depth, K


class PoseRefiner:
    """Equivalent of the reference ``poseRefine`` pybind class
    (linemodLevelup/pybind11.cpp:29-34): process(...), getR, getT,
    getResidual.  ICP runs on ``device``: CUDA by default, raising when
    there is none; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: Optional[IcpConfig] = None, device=None):
        self.cfg = cfg or IcpConfig()
        self.device = resolve_device(device)
        self.R_refined: Optional[np.ndarray] = None
        self.t_refined: Optional[np.ndarray] = None
        self.residual: float = -1.0

    def process(
        self,
        scene_depth: np.ndarray,
        model_depth: np.ndarray,
        scene_K: np.ndarray,
        model_K: np.ndarray,
        model_R: np.ndarray,
        model_t: np.ndarray,
        detect_x: int,
        detect_y: int,
    ) -> None:
        """Refine one detection (poseRefine::process, cpp:27-160): the model
        cloud comes from the render at the render position; the initial
        guess shifts it to the detected (x, y) by the centroid offset
        between the model cloud and the scene crop."""
        cfg = self.cfg
        h, w = scene_depth.shape
        ys, xs = np.nonzero(model_depth > 0)
        if len(ys) == 0:
            self.residual = -1.0
            return
        bx0, bx1 = xs.min() - cfg.dilate_px, xs.max() + cfg.dilate_px + 1
        by0, by1 = ys.min() - cfg.dilate_px, ys.max() + cfg.dilate_px + 1
        bw, bh = bx1 - bx0, by1 - by0
        if detect_x + bw >= w or detect_y + bh >= h:  # cpp:52-55
            self.residual = -1.0
            return

        model_pts, model_valid = sample_model_points(model_depth, model_K, cfg.num_model_points)

        # Initial guess: centroid(scene crop near anchor depth) -
        # centroid(model) (cpp:60-104), the crop being the model bbox
        # translated to the detected position.
        anchor = model_depth[model_depth.shape[0] // 2, model_depth.shape[1] // 2] / 1000.0
        crop = np.zeros((bh, bw), np.float64)
        sy0 = max(detect_y - cfg.dilate_px, 0)
        sx0 = max(detect_x - cfg.dilate_px, 0)
        sy1 = min(sy0 + bh, h)
        sx1 = min(sx0 + bw, w)
        crop[: sy1 - sy0, : sx1 - sx0] = scene_depth[sy0:sy1, sx0:sx1] / 1000.0
        mmask = np.zeros((bh, bw), bool)
        mmask[ys - by0, xs - bx0] = True
        sel = mmask & (np.abs(crop - anchor) < cfg.anchor_window) & (crop > 0)
        if sel.sum() < 10:
            self.residual = -1.0
            return
        cy, cx = np.nonzero(sel)
        z = crop[cy, cx]
        px = ((cx + sx0) - scene_K[0, 2]) / scene_K[0, 0] * z
        py = ((cy + sy0) - scene_K[1, 2]) / scene_K[1, 1] * z
        center_scene = np.stack([px, py, z], 1).mean(0)
        center_model = model_pts[model_valid].mean(0)
        init_T = np.eye(4, dtype=np.float32)
        init_T[:3, 3] = center_scene - center_model

        dev = self.device
        depth, K = _scene_tensors(scene_depth, scene_K, dev)
        sp = backproject(depth, K)
        T, fitness, _ = icp_point_to_plane(
            torch.from_numpy(model_pts).to(dev),
            torch.from_numpy(model_valid).to(dev),
            sp,
            scene_normals(sp),
            K,
            torch.from_numpy(init_T).to(dev),
            cfg.corr_dist,
            cfg.max_iters,
            cfg.coarse_gate_mult,
        )
        T = T.cpu().numpy().astype(np.float64)

        # Compose with the template pose (cpp:34-41, 146-154): template t_z
        # is in mm -> meters; output t back in mm.
        init_base = np.eye(4)
        init_base[:3, :3] = model_R
        init_base[:3, 3] = np.asarray(model_t).flatten()
        init_base[2, 3] /= 1000.0
        result = T @ init_base
        self.R_refined = result[:3, :3]
        self.t_refined = result[:3, 3:4] * 1000.0
        self.residual = float(fitness)

    def getR(self) -> np.ndarray:
        return self.R_refined

    def getT(self) -> np.ndarray:
        return self.t_refined

    def getResidual(self) -> float:
        return self.residual


def refine_poses(
    scene_depth: np.ndarray,
    scene_K: np.ndarray,
    model_depths: np.ndarray,
    model_K: np.ndarray,
    init_Ts: np.ndarray,
    cfg: Optional[IcpConfig] = None,
    device=None,
):
    """Batched refinement of K candidates against one scene, on ``device``
    (CUDA by default, raising when there is none; ``device="cpu"`` for the
    CPU).

    Args:
      scene_depth: (H, W) uint16 mm.
      model_depths: (K, Hm, Wm) rendered depths, one per candidate.
      init_Ts: (K, 4, 4) initial model->scene transforms (meters).

    Returns device tensors: (K, 4, 4) refined transforms, (K,) fitness,
    (K,) rmse.
    """
    cfg = cfg or IcpConfig()
    dev = resolve_device(device)
    k = model_depths.shape[0]
    pts = np.zeros((k, cfg.num_model_points, 3), np.float32)
    val = np.zeros((k, cfg.num_model_points), bool)
    for i in range(k):
        pts[i], val[i] = sample_model_points(model_depths[i], model_K, cfg.num_model_points)
    depth, K = _scene_tensors(scene_depth, scene_K, dev)
    sp = backproject(depth, K)
    return icp_batch(
        torch.from_numpy(pts).to(dev),
        torch.from_numpy(val).to(dev),
        sp,
        scene_normals(sp),
        K,
        torch.from_numpy(np.asarray(init_Ts, np.float32)).to(dev),
        cfg.corr_dist,
        cfg.max_iters,
        cfg.coarse_gate_mult,
    )
