"""Synthetic workloads, made from numpy seeds.

- ``bench_bank``: the JAX package's ``bench.py`` workload
  (``_synthetic_bank``, bench.py:76-103): one class of 89 templates with 254
  features at level 0 and 127 at level 1, and a VGA RGB-D frame, drawn from
  the same seed in the same order, so both packages see identical data.
- ``bench_refine_bank``: the refine stage bench.py adds to that workload
  for its detect+refine measurement (bench.py:229-270).
- ``training_view`` / ``planted_scene``: a VGA scene with a textured
  object on a depth dome pasted at a known place, and the views that
  train its templates.  ``tools/torch_port_golden.py`` records what the
  JAX package detects and refines in it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sixdpose_tpu_torch.config import IcpConfig
from sixdpose_tpu_torch.models.templates import TemplateLevel

VGA = (480, 640)
OBJECT_SIZE = 112
# bench.py's camera (K_cam, bench.py:258-267), also the planted scene's.
BENCH_K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]], np.float32)


def bench_bank(num_templates: int = 89, seed: int = 0):
    """(class_id, templates, rgb (480, 640, 3) uint8, depth (480, 640)
    uint16) of bench.py's synthetic workload."""
    rng = np.random.default_rng(seed)
    templates: List[List[TemplateLevel]] = []
    for _ in range(num_templates):
        levels = []
        for l, size in ((0, 80), (1, 40)):
            f = 254 // (l + 1)
            feats = np.stack(
                [rng.integers(0, size, f), rng.integers(0, size, f), rng.integers(0, 16, f)], 1
            )
            levels.append(TemplateLevel(features=feats, width=size, height=size, pyramid_level=l))
        templates.append(levels)
    rgb = rng.integers(0, 255, (480, 640, 3), np.uint8)
    dep = (900 + 60 * rng.standard_normal((480, 640))).astype(np.uint16)
    return "synthetic", templates, rgb, dep


def bench_refine_bank(whs0: np.ndarray, seed: int = 0) -> dict:
    """The refine stage of bench.py's detect+refine workload (bench.py:229-270),
    drawn from the same seed in the same order, for the templates whose
    level-0 (width, height) are ``whs0`` (N, 2).

    Returns ``fields``: the six ``RefineBank`` arrays (box-surface clouds of
    512 points about 10 cm across, all valid, chroma, centroids, bbox =
    the template size, identity base poses); ``win``: the median window
    (not capped at 192, as bench.py builds it); ``K``: the camera;
    ``icp``: ``IcpConfig(max_iters=16)``; ``max_refine``: 8; and
    ``verify_pts`` (mm) / ``verify_colors``: the first cloud and random
    colors.
    """
    rng = np.random.default_rng(seed)
    whs0 = np.asarray(whs0)
    n_tmpl, n_pts = len(whs0), 512
    face = rng.integers(0, 3, (n_tmpl, n_pts))
    sgn = rng.choice([-1.0, 1.0], (n_tmpl, n_pts))
    cl = rng.uniform(-0.05, 0.05, (n_tmpl, n_pts, 3)).astype(np.float32)
    for ax in range(3):
        m = face == ax
        cl[..., ax] = np.where(m, 0.05 * sgn, cl[..., ax]).astype(np.float32)
    chroma = rng.uniform(0.2, 0.4, (n_tmpl, n_pts, 2)).astype(np.float32)
    fields = (
        cl,
        np.ones((n_tmpl, n_pts), bool),
        chroma,
        cl.mean(1),
        whs0.astype(np.int32),
        np.tile(np.eye(4, dtype=np.float32), (n_tmpl, 1, 1)),
    )
    win = (int(-(-(whs0[:, 1].max() + 1) // 16) * 16), int(-(-(whs0[:, 0].max() + 1) // 16) * 16))
    return {
        "fields": fields,
        "win": win,
        "K": BENCH_K.copy(),
        "icp": IcpConfig(max_iters=16),
        "max_refine": 8,
        "verify_pts": (cl[0] * 1000.0).astype(np.float32),
        "verify_colors": rng.integers(60, 220, (n_pts, 3)).astype(np.float32),
    }


def planted_object(shape_id: int, size: int = OBJECT_SIZE, seed: int = 5):
    """A textured object: (rgb (size, size, 3) uint8, height (size, size)
    int32 mm above its base, mask (size, size) bool).  Shapes: 0 disc,
    1 ellipse, 2 rounded square; each a dome up to 60 mm high."""
    rng = np.random.default_rng(seed + shape_id)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    c = (size - 1) / 2.0
    u, v = (xx - c) / (size / 2 - 6), (yy - c) / (size / 2 - 6)
    if shape_id == 0:
        r2 = u * u + v * v
    elif shape_id == 1:
        r2 = u * u + (v / 0.7) ** 2
    else:
        r2 = np.maximum(np.abs(u), np.abs(v)) ** 6 + 0.2 * (u * u + v * v)
    mask = r2 < 1.0
    rgb = np.zeros((size, size, 3), np.uint8)
    rgb[mask] = (60, 170, 230)
    rgb[mask & (xx > c)] = (230, 90, 30)
    rgb[mask & (yy > c) & (xx <= c)] = (120, 230, 60)
    rgb[mask & (yy < c / 2)] = (240, 240, 90)
    noise = rng.integers(0, 20, (size, size, 3), np.uint8)
    rgb = np.where(mask[..., None], np.clip(rgb.astype(np.int32) + noise, 0, 255), 0).astype(np.uint8)
    height = np.where(mask, 60.0 * np.sqrt(np.clip(1.0 - r2, 0.0, 1.0)), 0.0).astype(np.int32)
    return rgb, height, mask


def _paste(rgb, depth, shape_id: int, x: int, y: int, base_mm: int) -> np.ndarray:
    """Paste object ``shape_id`` with its top-left at (x, y); returns its
    mask in frame coordinates."""
    obj, height, m = planted_object(shape_id)
    s = obj.shape[0]
    rgb[y : y + s, x : x + s][m] = obj[m]
    depth[y : y + s, x : x + s][m] = (base_mm - height[m]).astype(depth.dtype)
    mask = np.zeros(depth.shape, bool)
    mask[y : y + s, x : x + s] = m
    return mask


def training_view(shape_id: int, at: Tuple[int, int] = (264, 184)):
    """(rgb, depth uint16, mask uint8) of object ``shape_id`` with its
    top-left at ``at`` = (x, y) on a black VGA canvas, a plane at 900 mm."""
    rgb = np.zeros(VGA + (3,), np.uint8)
    depth = np.full(VGA, 900, np.uint16)
    mask = _paste(rgb, depth, shape_id, at[0], at[1], 850)
    return rgb, depth, mask.astype(np.uint8) * 255


def planted_scene(x: int, y: int, seed: int = 11):
    """(rgb, depth uint16) of a cluttered VGA scene with object 0 pasted at
    top-left (x, y): low-contrast noise on a noisy plane at 900 mm."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(30, 70, VGA + (3,), np.uint8)
    depth = (900 + rng.integers(-2, 3, VGA)).astype(np.uint16)
    _paste(rgb, depth, 0, x, y, 850)
    return rgb, depth
