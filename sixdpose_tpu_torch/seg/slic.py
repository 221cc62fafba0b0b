"""SLIC / ASP color superpixels (reference asp/src/libasp/algos/{SLIC,ASP}.cpp).

Port of the JAX package's ``seg/slic.py``: the two color-only variants of
the ALIC clustering next to DASP.

- ``superpixels_slic`` (SLIC.cpp:8-38): constant density
  num_superpixels / (W*H), grid seeds, distance
  compactness * |dpos|^2 / r^2 + (1-compactness) * |dcolor|^2 with
  colors scaled to [0, 1] (default compactness 0.15, algos.hpp:71-78).
- ``superpixels_asp`` (ASP.cpp:8-40): the same distance over a
  user-supplied density image, Floyd-Steinberg seeds.

Seeds on the host (grid) or by the seeding kernel (ASP), then the ALIC
iterations on the device with the ordered segment sums of
``ops/segment_sum.py``.  The distance is what XLA compiles the JAX code to
on the CPU: ``/ r2`` with r2 = 1 / m becomes ``* m``, and the first product
of each sum is contracted into a multiply-add.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.ops.segment_sum import segment_sum
from sixdpose_tpu_torch.ops.sqrt import sqrt32
from sixdpose_tpu_torch.seg.dasp import (
    _SLACK,
    _c,
    _fma,
    _plain3,
    _sum3_sq,
    assign_cells,
    cell_candidates,
    floyd_steinberg_seeds,
)


@dataclasses.dataclass(frozen=True)
class SlicConfig:
    """SLIC/ASP knobs (SlicParameters/AspParameters, algos.hpp:71-88)."""

    compactness: float = 0.15
    iterations: int = 5
    cell_px: int = 16
    seeds_per_cell: int = 8
    lambda_box: float = 2.0


def grid_seeds(h: int, w: int, num_superpixels: int) -> np.ndarray:
    """Regular-lattice seeds (PoissonDiskSamplingMethod::Grid): spacing
    sqrt(W*H / num), offset half a step."""
    step = float(np.sqrt(h * w / max(num_superpixels, 1)))
    ys = np.arange(step / 2.0, h, step)
    xs = np.arange(step / 2.0, w, step)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def _assign2d(color, table, cand, cfg: SlicConfig):
    """Each pixel's best superpixel among its candidates, (H, W) int64
    (-1 where none is valid and in its box).  ``table``: (S, 6) position,
    color, density."""
    h, w = color.shape[:2]
    c_pos, c_col, lam = _c(cfg.compactness), _c(1.0 - cfg.compactness), _c(cfg.lambda_box)

    def dist(pix, g, x, y, exact):
        dx, dy = x - g[..., 0], y - g[..., 1]
        m = torch.maximum(g[..., 5] * _c(np.pi), torch.full_like(g[..., 5], 1e-9))
        box = sqrt32(torch.ones_like(m) / m) * lam
        inbox = (torch.abs(dx) <= box) & (torch.abs(dy) <= box)
        dc = pix["color"] - g[..., 2:5]
        if exact:
            return _fma(_fma(dx, dx, dy * dy) * c_pos, m, _sum3_sq(dc) * c_col), None, inbox
        d = ((dx * dx + dy * dy) * c_pos) * m + _plain3(dc, dc) * c_col
        return d, torch.abs(d) * _SLACK, inbox

    valid = torch.ones((h, w), dtype=torch.bool, device=color.device)
    return assign_cells({"color": color}, valid, table, cand, cfg.cell_px, dist)


def _alic2d(color, density, seed_xy, seed_valid, cfg: SlicConfig, num_seeds_pad: int):
    """ALIC iterations over (position, color) pixels, then a final
    assignment (SLIC.cpp:31-34): (indices (H, W) int32, superpixel dict)."""
    h, w = density.shape
    dev = density.device
    s = num_seeds_pad
    sx = torch.clamp(seed_xy[:, 0].to(torch.int32), 0, w - 1).to(torch.int64)
    sy = torch.clamp(seed_xy[:, 1].to(torch.int32), 0, h - 1).to(torch.int64)
    sp = {"position": seed_xy, "color": color[sy, sx], "density": density[sy, sx],
          "num": torch.ones((s,), dtype=torch.float32, device=dev)}
    gx, gy = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=dev),
                            torch.arange(h, dtype=torch.float32, device=dev), indexing="xy")
    pix = torch.cat([gx[..., None], gy[..., None], color, density[..., None],
                     torch.ones((h, w, 1), dtype=torch.float32, device=dev)], dim=-1).reshape(h * w, -1)

    def assign(sp):
        cand = cell_candidates(sp["position"], seed_valid, h, w, cfg.cell_px, cfg.seeds_per_cell)
        table = torch.cat([sp["position"], sp["color"], sp["density"][:, None]], dim=1)
        return _assign2d(color, table, cand, cfg)

    for _ in range(cfg.iterations):
        indices = assign(sp)
        acc = segment_sum(pix, indices.reshape(-1), s)
        cnt = acc[:, 6]
        mean = acc[:, :6] / torch.maximum(cnt, torch.full_like(cnt, 1e-6))[:, None]
        dead = cnt < 0.5
        sp = {
            "position": torch.where(dead[:, None], sp["position"], mean[:, 0:2]),
            "color": torch.where(dead[:, None], sp["color"], mean[:, 2:5]),
            "density": torch.where(dead, sp["density"], mean[:, 5]),
            "num": cnt,
        }
    return assign(sp).to(torch.int32), sp


def _run(rgb: np.ndarray, density: torch.Tensor, seeds: torch.Tensor, cfg: SlicConfig):
    dev = density.device
    s = seeds.shape[0]
    pad = max(1 << int(np.ceil(np.log2(max(s, 1)))), 8)
    seed_xy = torch.zeros((pad, 2), dtype=torch.float32, device=dev)
    seed_xy[:s] = seeds
    valid = torch.arange(pad, device=dev) < s
    # Colors scaled on the host, a float32 division as in the JAX package.
    color = torch.from_numpy(np.asarray(rgb).astype(np.float32) / 255.0).to(dev)
    indices, sp = _alic2d(color, density, seed_xy, valid, cfg, pad)
    return indices.cpu().numpy(), {k: v.cpu().numpy()[:s] for k, v in sp.items()}


def superpixels_slic(
    rgb: np.ndarray,
    num_superpixels: int = 1000,
    compactness: float = 0.15,
    device=None,
) -> Tuple[np.ndarray, dict]:
    """SLIC over an (H, W, 3) uint8 image (SuperpixelsSlic, SLIC.cpp:8-38),
    on ``device`` (the card unless ``"cpu"``).

    Returns numpy (indices (H, W) int32 [-1 = unassigned], superpixel dict).
    """
    dev = resolve_device(device)
    h, w = rgb.shape[:2]
    density = torch.full((h, w), float(np.float32(num_superpixels / float(h * w))), dtype=torch.float32, device=dev)
    seeds = torch.from_numpy(grid_seeds(h, w, num_superpixels).astype(np.float32)).to(dev)
    return _run(rgb, density, seeds, SlicConfig(compactness=compactness))


def superpixels_asp(
    rgb: np.ndarray,
    density: np.ndarray,
    compactness: float = 0.15,
    device=None,
) -> Tuple[np.ndarray, dict]:
    """ASP with a user density image (SuperpixelsAsp, ASP.cpp:8-40), on
    ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    density_t = torch.from_numpy(np.ascontiguousarray(density, np.float32)).to(dev)
    seeds = floyd_steinberg_seeds(density_t)
    return _run(rgb, density_t, seeds, SlicConfig(compactness=compactness))
