"""Depth-Adaptive Superpixels (DASP) and convexity-based grouping.

Port of the JAX package's ``seg/dasp.py`` (reference: cxx_3d_seg/asp/ —
SuperpixelsDasp, DASP.cpp:178-244; ALIC, alic.hpp:64-130; DsapGrouping,
DASP.cpp:246-494; DaspParameters defaults, algos.hpp:96-117).

- ``pixel_stage``: back-projection, the Primesense finite differences over
  six static windows chosen per pixel, normals and density, in torch on
  the frame's device.  It computes what XLA compiles the JAX code to on the
  CPU: each constant divisor is a multiply by its folded float32
  reciprocal, constant chains are folded the way XLA folds them (read in
  the optimized HLO), and the two multiply-adds XLA contracts are formed
  with one rounding (``_fma``).  The one difference: XLA's CPU ``rsqrt``
  (the normal's ``1 / sqrt(1 + |g|^2)``) is the x86 ``rsqrtps`` estimate
  refined by two Newton steps, whose bits depend on the host's estimate
  table; the port rounds the exact reciprocal square root instead, the
  same on every device, and differs from it by one ulp on some pixels.
- ``floyd_steinberg_seeds``: the serial error-diffusion scan; a CUDA
  density runs the hand-written kernel ``csrc/floyd_steinberg.cu``, a CPU
  density the numpy scan (``ops/floyd_steinberg.py``).
- ``alic_iterate``: the assignment over each pixel's 3 x 3 cells of seed
  buckets and the update by ordered segment sums (``ops/segment_sum.py``:
  ``csrc/segment_sum.cu`` on the card), ``iterations`` times, then a final
  assignment.
- ``convex_grouping``: the two union-find passes on the host (numpy), as
  in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from sixdpose_tpu_torch.ops.floyd_steinberg import floyd_steinberg
from sixdpose_tpu_torch.ops.segment_sum import segment_sum
from sixdpose_tpu_torch.ops.sqrt import sqrt32, sqrt64


@dataclasses.dataclass(frozen=True)
class DaspConfig:
    """DaspParameters (algos.hpp:96-117)."""

    focal_px: float = 545.0
    cx: float = 320.0
    cy: float = 240.0
    depth_to_z: float = 0.001
    radius: float = 0.015           # meters
    num_superpixels: int = 0        # 0 = density-driven count
    compactness: float = 0.8
    normal_weight: float = 1.0
    iterations: int = 5
    lambda_box: float = 3.0
    cell_px: int = 32               # spatial hash cell for assignment
    seeds_per_cell: int = 12        # hash bucket capacity
    # convex grouping (DASP.cpp:246-494)
    convex_dot: float = -0.2
    center_dist_radii: float = 3.0
    plane_edge_count_scl: float = 400.0
    plane_weight_max: float = 0.02
    concave_dot: float = -0.1
    concave_max_pairs: int = 1


_GRAD_WINDOWS = (4, 6, 8, 12, 16, 24)

f32 = np.float32


def _c(v) -> float:
    """A float32 constant as the Python float torch multiplies by exactly."""
    return float(f32(v))


def _recip(v) -> float:
    """XLA's folded reciprocal of a constant divisor: float32 1 / v."""
    return float(f32(1.0) / f32(v))


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA on the CPU contracts it
    (exact float64 product, one rounding: the same bits on every device)."""
    return (a.double() * b.double() + c.double()).float()


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 1 / sqrt(x) from float64 (the same bits on every device)."""
    return (1.0 / sqrt64(x.double())).float()


def _fd_primesense(v0, v1, v2, v3, v4):
    """LocalFiniteDifferencesPrimesense (DASP.cpp:59-96)."""
    zero = torch.zeros((), dtype=v2.dtype, device=v2.device)
    left_bad = (v0 == 0) | (v1 == 0)
    right_bad = (v3 == 0) | (v4 == 0)
    # v2 + v0 - 2 * v1: the product is exact, so contraction changes nothing.
    a = torch.abs((v2 + v0) - v1 * 2.0)
    b = torch.abs((v4 + v2) - v3 * 2.0)
    s = a + b
    flat = s == 0
    denom = torch.where(flat, torch.ones_like(s), s)
    half = torch.full_like(s, 0.5)
    p = torch.where(flat, half, a / denom)
    q = torch.where(flat, half, b / denom)
    # q * (v2 - v0) + p * (v4 - v2), the first product contracted.
    smooth = _fma(q, v2 - v0, p * (v4 - v2))
    out = torch.where(
        left_bad & right_bad,
        zero,
        torch.where(left_bad, v4 - v2, torch.where(right_bad, v2 - v0, smooth)),
    )
    special = (v0 == 0) & (v4 == 0) & (v1 != 0) & (v3 != 0)
    return torch.where(special, v3 - v1, out)


def _grad_for_window(d: torch.Tensor, wpx: int):
    h, w = d.shape
    p = torch.nn.functional.pad(d, (wpx, wpx, wpx, wpx))

    def sh(dy, dx):
        return p[wpx + dy: h + wpx + dy, wpx + dx: w + wpx + dx]

    half = wpx // 2
    gx = _fd_primesense(sh(0, -wpx), sh(0, -half), d, sh(0, half), sh(0, wpx))
    gy = _fd_primesense(sh(-wpx, 0), sh(-half, 0), d, sh(half, 0), sh(wpx, 0))
    return gx, gy


def pixel_stage(rgb: torch.Tensor, depth: torch.Tensor, cfg: DaspConfig) -> Dict[str, torch.Tensor]:
    """Back-projection, depth gradient, normal, density per pixel, on the
    tensors' device.

    Args:
      rgb: (H, W, 3) uint8; depth: (H, W) integer depth (uint16 values).

    Returns dict of (H, W, ...) tensors: world (m), normal, color, density
    (float32), valid (bool).
    """
    h, w = depth.shape
    dev = depth.device
    d = depth.to(torch.int32).to(torch.float32)
    valid = depth > 0
    c_z = _c(cfg.depth_to_z)
    inv_f = _recip(cfg.focal_px)
    zf = float(f32(c_z) * f32(inv_f))  # z / f folded: d * (0.001 * (1 / f))
    z = d * c_z
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + _c(-cfg.cx)) * c_z
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + _c(-cfg.cy)) * c_z
    world = torch.stack([(d * xs[None, :]) * inv_f, (d * ys[:, None]) * inv_f, z], dim=-1)

    z_over_f = d * zf
    eps = torch.full_like(z_over_f, 1e-9)
    want = torch.full_like(z_over_f, _c(0.1 * cfg.radius)) / torch.maximum(z_over_f, eps)
    # The smallest window >= want, the first (4) when none is: JAX's argmin
    # over where(w >= want, w, 1e9), the windows ascending.
    grads = {wp: _grad_for_window(d, wp) for wp in _GRAD_WINDOWS}
    used_w = torch.full_like(d, float(_GRAD_WINDOWS[0]))
    gx, gy = grads[_GRAD_WINDOWS[0]]
    for wp in reversed(_GRAD_WINDOWS):
        fits = want <= float(wp)
        gxi, gyi = grads[wp]
        used_w = torch.where(fits, torch.full_like(d, float(wp)), used_w)
        gx, gy = torch.where(fits, gxi, gx), torch.where(fits, gyi, gy)
    scl = torch.ones_like(d) / torch.maximum(used_w * z_over_f, eps)
    k = scl * c_z
    g0, g1 = gx * k, gy * k
    gg = _fma(g1, g1, g0 * g0)

    # NormalFromGradient (DASP.cpp:142-160).
    gn = _rsqrt(gg + 1.0)
    normal = torch.stack([gn * g0, gn * g1, -gn], dim=-1)
    facing = normal * (-world)
    flip = torch.sign((facing[..., 0] + facing[..., 1]) + facing[..., 2])
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    normal = normal * flip[..., None]
    down = torch.zeros(3, dtype=torch.float32, device=dev)
    down[2] = -1.0
    normal = torch.where(valid[..., None], normal, down)

    # Density (DASP.cpp:167-171): q * q / 3.1415 * sqrt(|g|^2 + 1).
    q = d * float(f32(c_z) * f32(_recip(f32(cfg.radius * cfg.focal_px))))
    density = ((q * q) * _recip(3.1415)) * sqrt32(gg + 1.0)
    density = torch.where(valid, density, torch.zeros_like(density))

    color = rgb.to(torch.float32) * _recip(255.0)
    return {
        "world": torch.where(valid[..., None], world, torch.zeros_like(world)),
        "normal": normal,
        "color": color,
        "density": density,
        "valid": valid,
    }


def floyd_steinberg_seeds(density: torch.Tensor) -> torch.Tensor:
    """Density error-diffusion seed placement (FloydSteinberg.cpp:35-138).

    Returns (S, 2) float32 (x, y) seed positions in scan order, on the
    density's device: the hand-written kernel for a CUDA density, the numpy
    scan for a CPU one (``ops/floyd_steinberg.py``).
    """
    return floyd_steinberg(density)


# Elements (pixels x candidates) per band of cell rows in the assignment:
# about 40 MB per float32 temporary.
_ASSIGN_BLOCK = 1 << 23
# The superpixel fields in the order of their columns in the packed table
# and in the update's segment sums.
_FIELDS = (("position", 2), ("world", 3), ("normal", 3), ("color", 3), ("density", 1))


def cell_candidates(position, seed_valid, h, w, cell_px, cap):
    """The seeds of each hash cell (at most ``cap``, lowest index first) and
    each cell's candidates: the buckets of its 3 x 3 cells, clipped at the
    border, in the JAX package's order.  Returns (GH, GW, 9 * cap) int64
    seed ids, -1 for an empty slot."""
    dev = position.device
    s = position.shape[0]
    gh, gw = -(-h // cell_px), -(-w // cell_px)
    cx = torch.clamp(torch.div(position[:, 0].to(torch.int32), cell_px, rounding_mode="floor"), 0, gw - 1)
    cy = torch.clamp(torch.div(position[:, 1].to(torch.int32), cell_px, rounding_mode="floor"), 0, gh - 1)
    cell = (cy * gw + cx).to(torch.int64)
    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order]
    # Rank within the cell: position in the sorted run of equal cells.
    pos = torch.arange(s, device=dev)
    first = torch.ones(s, dtype=torch.bool, device=dev)
    first[1:] = cell_sorted[1:] != cell_sorted[:-1]
    run_start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    rank = pos - run_start
    slot_ok = (rank < cap) & seed_valid[order]
    # Invalid and overflowing seeds write -1 to a sentinel slot.
    sentinel = gh * gw * cap
    slot_idx = cell_sorted * cap + torch.clamp(rank, max=cap - 1)
    bucket = torch.full((sentinel + 1,), -1, dtype=torch.int64, device=dev)
    bucket[torch.where(slot_ok, slot_idx, torch.full_like(slot_idx, sentinel))] = torch.where(
        slot_ok, order, torch.full_like(order, -1))
    bucket = bucket[:sentinel].reshape(gh, gw, cap)
    gy = torch.arange(gh, device=dev)
    gx = torch.arange(gw, device=dev)
    cands = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            by = torch.clamp(gy + dy, 0, gh - 1)
            bx = torch.clamp(gx + dx, 0, gw - 1)
            cands.append(bucket[by[:, None], bx[None, :]])
    return torch.cat(cands, dim=-1)


def _to_cells(t: torch.Tensor, cell: int, gh: int, gw: int) -> torch.Tensor:
    """(H, W, C) -> (GH, GW, cell * cell, C): each cell's pixels in row
    order, the frame padded with zeros to whole cells."""
    h, w, c = t.shape
    t = torch.nn.functional.pad(t, (0, 0, 0, gw * cell - w, 0, gh * cell - h))
    return t.reshape(gh, cell, gw, cell, c).permute(0, 2, 1, 3, 4).reshape(gh, gw, cell * cell, c)


def _from_cells(t: torch.Tensor, cell: int, h: int, w: int) -> torch.Tensor:
    gh, gw = t.shape[:2]
    return t.reshape(gh, gw, cell, cell).permute(0, 2, 1, 3).reshape(gh * cell, gw * cell)[:h, :w]


def assign_cells(fields: dict, valid: torch.Tensor, table: torch.Tensor, cand: torch.Tensor, cell: int,
                 dist) -> torch.Tensor:
    """Each pixel's nearest candidate superpixel (the first among equal
    distances): (H, W) int64, -1 where none is valid and in its box.

    The pixels of a hash cell share its candidates, so the work runs on
    (cells, pixels of a cell, candidates) blocks that read each candidate's
    row of ``table`` once per cell.  ``dist(pix, g, x, y, exact)`` returns
    (distance, slack, in_box) of pixel fields ``pix`` (name -> (..., 1, C)),
    candidate rows ``g`` (..., K, T) and pixel coordinates (..., 1); the
    plain float32 distance with its slack where ``exact`` is false, the
    contracted one otherwise (``pick_nearest``).
    """
    h, w = valid.shape
    gh, gw, k = cand.shape
    dev = valid.device
    p = cell * cell
    blocks = {n: _to_cells(f, cell, gh, gw) for n, f in fields.items()}
    vb = _to_cells(valid[..., None].to(torch.uint8), cell, gh, gw)[..., 0] > 0
    ys, xs = torch.meshgrid(torch.arange(gh * cell, dtype=torch.float32, device=dev),
                            torch.arange(gw * cell, dtype=torch.float32, device=dev), indexing="ij")
    xs = _to_cells(xs[..., None], cell, gh, gw)[..., 0]
    ys = _to_cells(ys[..., None], cell, gh, gw)[..., 0]
    g_all = table[torch.clamp(cand, min=0)]  # (GH, GW, K, T)
    band = max(1, _ASSIGN_BLOCK // max(1, gw * p * k))
    out = []
    for b0 in range(0, gh, band):
        b1 = min(gh, b0 + band)
        cd = cand[b0:b1, :, None, :].expand(b1 - b0, gw, p, k)
        pix = {n: v[b0:b1, :, :, None, :] for n, v in blocks.items()}
        approx, tol, inbox = dist(pix, g_all[b0:b1, :, None], xs[b0:b1, ..., None], ys[b0:b1, ..., None], False)
        ok = (cd >= 0) & inbox & vb[b0:b1, :, :, None]

        def exact(sel, b0=b0, b1=b1):
            pix = {n: v[b0:b1][sel][:, None, :] for n, v in blocks.items()}
            g = g_all[b0:b1][sel[0], sel[1]]
            return dist(pix, g, xs[b0:b1][sel][:, None], ys[b0:b1][sel][:, None], True)[0]

        out.append(pick_nearest(cd, ok, approx, tol, exact))
    return _from_cells(torch.cat(out, dim=0), cell, h, w)


def _sum3_sq(d):
    """d0*d0 + d1*d1 + d2*d2 as XLA's reduce contracts it."""
    return _fma(d[..., 2], d[..., 2], _fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))


def _sum3_dot(a, b):
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _plain3(a, b):
    """a0*b0 + a1*b1 + a2*b2 in plain float32 (each step rounded)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


# Relative slack between a distance in plain float32 and its contracted
# form: a few float32 ulps are 2^-21; this is 8 times that.
_SLACK = 2.0**-18


def pick_nearest(cand: torch.Tensor, ok: torch.Tensor, approx: torch.Tensor, tol: torch.Tensor, exact) -> torch.Tensor:
    """The candidate of least exact distance (the first among equal ones),
    from distances in plain float32: (...,) int64 ids, -1 where none is ok.

    ``approx`` is within ``tol`` of the exact distance that ``exact(sel)``
    computes for the rows ``sel`` (a tuple of index tensors over the leading
    axes; (n, K) float32).  Where every candidate that can still be the
    nearest is one and the same seed, the approximate argmin is the exact
    one; the rest of the rows are decided by ``exact``.
    """
    inf = torch.full_like(approx, float("inf"))
    da = torch.where(ok, approx, inf)
    bound = torch.where(ok, da + tol, inf).amin(dim=-1, keepdim=True)
    near = ok & (da - tol <= bound)
    lo_id = torch.where(near, cand, torch.full_like(cand, torch.iinfo(torch.int64).max)).amin(dim=-1)
    hi_id = torch.where(near, cand, torch.full_like(cand, -1)).amax(dim=-1)
    best = torch.argmin(da, dim=-1, keepdim=True)
    idx = torch.gather(cand, -1, best)[..., 0]
    idx = torch.where(torch.isfinite(torch.gather(da, -1, best)[..., 0]), idx, torch.full_like(idx, -1))
    sel = torch.nonzero(near.any(dim=-1) & (lo_id != hi_id), as_tuple=True)
    if sel[0].numel():
        de = torch.where(ok[sel], exact(sel), inf[sel])
        idx[sel] = torch.gather(cand[sel], -1, torch.argmin(de, dim=-1, keepdim=True))[:, 0]
    return idx


def _assign(px, sp_table, cand, cfg: DaspConfig):
    """Each pixel's best superpixel among its candidates (alic.hpp:87-110):
    (H, W) int64, -1 where no candidate is valid and in its box.  The
    distance is the one XLA compiles, its multiply-adds contracted."""
    # Per superpixel: the box half-width lambda * r, r = 1 / sqrt(pi * density).
    sp_rad = _rsqrt(torch.maximum(sp_table[:, 11] * _c(3.1415), torch.full_like(sp_table[:, 11], 1e-9)))
    table = torch.cat([sp_table, (sp_rad * _c(cfg.lambda_box))[:, None]], dim=1)
    c_world = _c(f32(cfg.compactness) * (f32(1.0) / f32(cfg.radius * cfg.radius)))
    c_rest = _c(1.0 - cfg.compactness)
    c_color = _c(1.0 - cfg.normal_weight)
    c_normal = _c(cfg.normal_weight)

    def dist(pix, g, x, y, exact):
        box = g[..., 12]
        inbox = (torch.abs(x - g[..., 0]) <= box) & (torch.abs(y - g[..., 1]) <= box)
        dw = pix["world"] - g[..., 2:5]
        if exact:
            dw2, n_dot = _sum3_sq(dw), _sum3_dot(pix["normal"], g[..., 5:8])
        else:
            dw2, n_dot = _plain3(dw, dw), _plain3(pix["normal"], g[..., 5:8])
        rest = (1.0 - n_dot) * c_normal
        if c_color != 0.0:  # 0 * |dc|^2 adds +0 to every distance
            dc = pix["color"] - g[..., 8:11]
            dc2 = _sum3_sq(dc) if exact else _plain3(dc, dc)
            rest = dc2 * c_color + rest
        rest = rest * c_rest
        if exact:
            return _fma(dw2, torch.full_like(dw2, c_world), rest), None, inbox
        d = dw2 * c_world + rest
        slack = (torch.abs(dw2 * c_world) + (abs(c_color) * 12.0 + 2.0 * abs(c_normal)) + torch.abs(d)) * _SLACK
        return d, slack, inbox

    fields = {"world": px["world"], "normal": px["normal"], "color": px["color"]}
    return assign_cells(fields, px["valid"], table, cand, cfg.cell_px, dist)


def _pack(sp: dict) -> torch.Tensor:
    """(S, 12) float32 table: position, world, normal, color, density."""
    return torch.cat([sp[n].reshape(sp[n].shape[0], -1) for n, _ in _FIELDS], dim=1)


def alic_pixel_table(px: dict) -> torch.Tensor:
    """(H * W, 13) float32: each pixel's x, y, world, normal, color, density
    (the packed table's columns) and a count column of ones, the values
    the update's segment sums add."""
    h, w = px["density"].shape
    dev = px["density"].device
    gx, gy = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=dev),
                            torch.arange(h, dtype=torch.float32, device=dev), indexing="xy")
    return torch.cat([gx[..., None], gy[..., None], px["world"], px["normal"], px["color"], px["density"][..., None],
                      torch.ones((h, w, 1), dtype=torch.float32, device=dev)], dim=-1).reshape(h * w, -1)


def alic_iterate(px: dict, seed_xy: torch.Tensor, seed_valid: torch.Tensor, cfg: DaspConfig, num_seeds_pad: int):
    """ALIC iterations (alic.hpp:64-130) with hash-grid assignment, on the
    tensors' device, then a final assignment.

    Args:
      px: ``pixel_stage`` output.
      seed_xy: (S, 2) float32 (x, y), padded to ``num_seeds_pad``.
      seed_valid: (S,) bool.

    Returns (indices (H, W) int32 [-1 = unassigned], superpixel dict with
    per-superpixel mean position/world/normal/color/density and num).
    """
    h, w = px["density"].shape
    dev = px["density"].device
    s = num_seeds_pad
    sx = torch.clamp(seed_xy[:, 0].to(torch.int32), 0, w - 1).to(torch.int64)
    sy = torch.clamp(seed_xy[:, 1].to(torch.int32), 0, h - 1).to(torch.int64)
    sp = {
        "position": seed_xy.to(torch.float32),
        "world": px["world"][sy, sx],
        "normal": px["normal"][sy, sx],
        "color": px["color"][sy, sx],
        "density": px["density"][sy, sx],
        "num": torch.ones((s,), dtype=torch.float32, device=dev),
    }
    pix = alic_pixel_table(px)

    def assign(sp):
        cand = cell_candidates(sp["position"], seed_valid, h, w, cfg.cell_px, cfg.seeds_per_cell)
        return _assign(px, _pack(sp), cand, cfg)

    for _ in range(cfg.iterations):
        indices = assign(sp)
        # Update: segment means (alic.hpp:113-128), the sums in pixel order.
        acc = segment_sum(pix, indices.reshape(-1), s)
        cnt = acc[:, 12]
        mean = acc[:, :12] / torch.clamp(cnt, min=1e-6)[:, None]
        dead = cnt < 0.5
        new_sp, col = {"num": cnt}, 0
        for name, width in _FIELDS:
            m = mean[:, col: col + width]
            m = m if width > 1 else m[:, 0]
            keep = dead[:, None] if width > 1 else dead
            new_sp[name] = torch.where(keep, sp[name], m)
            col += width
        sp = new_sp
    return assign(sp).to(torch.int32), sp


class UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, i: int) -> int:
        while self.parent[i] != i:
            self.parent[i] = self.parent[self.parent[i]]
            i = self.parent[i]
        return i

    def union_into(self, child: int, parent: int):
        self.parent[self.find(child)] = self.find(parent)


def convex_grouping(
    indices: np.ndarray,
    sp_world: np.ndarray,
    sp_normal: np.ndarray,
    sp_num: np.ndarray,
    cfg: DaspConfig,
) -> np.ndarray:
    """Merge superpixels into convex segments (DsapGrouping, DASP.cpp:246-494),
    on the host; a numpy copy of the JAX package's, labels equal.

    Pass 1: sort convex edges by weight (1 - |n1.n2|); union when the
    shared border is long (count > radius*400) and the surfaces are
    coplanar (weight < 0.02) — stop at the first non-coplanar strong edge.
    Pass 2: merge adjacent groups over strong borders unless more than
    ``concave_max_pairs`` member pairs are concave.  For each member c it
    visits only the x with a strong border to c, listed when c's turn comes
    (the JAX loop tests every present x; a visit zeroes only its own
    adj[x, c] and adj[c, x], so the visits are the same).
    Returns (H, W) int64 segment ids, ordered by descending pixel count
    (-1 = unassigned).
    """
    h, w = indices.shape
    s = len(sp_world)

    # Adjacency counts from right/down neighbors (DASP.cpp:304-326).
    adj = np.zeros((s, s), np.int64)
    a = indices[:, :-1].reshape(-1)
    b = indices[:, 1:].reshape(-1)
    m = (a >= 0) & (b >= 0) & (a != b)
    np.add.at(adj, (a[m], b[m]), 1)
    np.add.at(adj, (b[m], a[m]), 1)
    a = indices[:-1, :].reshape(-1)
    b = indices[1:, :].reshape(-1)
    m = (a >= 0) & (b >= 0) & (a != b)
    np.add.at(adj, (a[m], b[m]), 1)
    np.add.at(adj, (b[m], a[m]), 1)

    present = np.unique(indices[indices >= 0])

    # Edges with convexity filter (DASP.cpp:330-363).
    edges = []
    ii, jj = np.nonzero(np.triu(adj, 1))
    for i, j in zip(ii, jj):
        c12 = sp_world[i] - sp_world[j]
        norm = np.linalg.norm(c12)
        if norm < 1e-12:
            continue
        u = c12 / norm
        if u @ sp_normal[i] < cfg.convex_dot or -(u @ sp_normal[j]) < cfg.convex_dot:
            continue
        if norm / cfg.radius > cfg.center_dist_radii:
            continue
        weight = 1.0 - abs(sp_normal[i] @ sp_normal[j])
        edges.append((weight, int(adj[i, j]), int(i), int(j)))
    edges.sort()

    uf = UnionFind(s)
    members = {int(i): [int(i)] for i in present}
    count = {int(i): float(sp_num[i]) for i in present}
    strong = cfg.radius * cfg.plane_edge_count_scl

    # Pass 1: plane merging (DASP.cpp:365-404).
    for weight, cnt, i, j in edges:
        p1, p2 = uf.find(i), uf.find(j)
        if p1 == p2:
            continue
        if count.get(p1, 0) > count.get(p2, 0):
            p1, p2 = p2, p1
        if cnt > strong:
            if weight < cfg.plane_weight_max:
                uf.union_into(p1, p2)
                members[p2] = members.get(p2, []) + members.get(p1, [])
                count[p2] = count.get(p2, 0) + count.get(p1, 0)
                adj[i, j] = adj[j, i] = 0
            else:
                break

    # Pass 2: concavity-limited group merging (DASP.cpp:406-470).
    roots = sorted(
        {uf.find(int(i)) for i in present},
        key=lambda r: -count.get(r, 0),
    )
    for p2 in roots:
        if uf.find(p2) != p2:
            continue
        for c in list(members.get(p2, [])):
            col = adj[present, c]
            for x in present[(col > strong) & (present != c)]:
                x = int(x)
                p1 = uf.find(x)
                if p1 != uf.find(p2):
                    concave = 0
                    stop = False
                    for m1 in members.get(p1, []):
                        for m2 in members.get(p2, []):
                            d = sp_world[m2] - sp_world[m1]
                            nn = np.linalg.norm(d)
                            if nn < 1e-12:
                                continue
                            u = d / nn
                            if (
                                u @ sp_normal[m2] < cfg.concave_dot
                                or -(u @ sp_normal[m1]) < cfg.concave_dot
                            ):
                                concave += 1
                                if concave > cfg.concave_max_pairs:
                                    stop = True
                                    break
                        if stop:
                            break
                    if concave <= cfg.concave_max_pairs:
                        tgt = uf.find(p2)
                        uf.union_into(p1, tgt)
                        members[tgt] = members.get(tgt, []) + members.get(p1, [])
                        count[tgt] = count.get(tgt, 0) + count.get(p1, 0)
                adj[x, c] = adj[c, x] = 0

    # Relabel segments by descending pixel count (DASP.cpp:472-493).
    root_of = np.full(s, -1, np.int64)
    for i in present:
        root_of[int(i)] = uf.find(int(i))
    roots, root_counts = [], []
    for r in np.unique(root_of[root_of >= 0]):
        roots.append(r)
        root_counts.append(sum(sp_num[m] for m in members.get(int(r), [int(r)])))
    order = np.argsort(-np.asarray(root_counts))
    rank = {int(roots[o]): i for i, o in enumerate(order)}
    seg_rank = np.array(
        [rank.get(int(r), -1) if r >= 0 else -1 for r in root_of], np.int64
    )
    out = np.full((h, w), -1, np.int64)
    ok = indices >= 0
    out[ok] = seg_rank[indices[ok]]
    return out
