"""Geometry helpers for evaluation (reference: pysixd/misc.py).

Port of the JAX package's ``eval/misc.py``: ``depth_im_to_dist_im`` is a
tensor function (the JAX one is jitted); the rest are numpy copies.
"""

from __future__ import annotations

import numpy as np
import torch

from sixdpose_tpu_torch.geometry.render import _dot3
from sixdpose_tpu_torch.ops.sqrt import sqrt32


def project_pts(pts, K, R, t):
    """(n, 3) model pts -> (n, 2) image pts (misc.py:27)."""
    p = np.asarray(pts) @ np.asarray(R).T + np.asarray(t).reshape(1, 3)
    u = p[:, 0] / p[:, 2] * K[0, 0] + K[0, 2]
    v = p[:, 1] / p[:, 2] * K[1, 1] + K[1, 2]
    return np.stack([u, v], 1)


def depth_im_to_dist_im(depth_im: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Depth (z) image -> euclidean distance image (misc.py:43-64), on the
    device of ``depth_im``; ``K`` is a float32 tensor there.  The sum of
    squares contracts as XLA on the CPU does (``geometry.render._fma``)."""
    h, w = depth_im.shape
    xs = torch.arange(w, dtype=torch.float32, device=depth_im.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=depth_im.device)[:, None]
    d = depth_im.to(torch.float32)
    X = (xs - K[0, 2]) * d / K[0, 0]
    Y = (ys - K[1, 2]) * d / K[1, 1]
    return sqrt32(_dot3(X, X, Y, Y, d, d))


def rgbd_to_point_cloud(K, depth, rgb=None):
    """Backproject nonzero depth to a cloud (misc.py:64-80)."""
    vs, us = np.nonzero(np.asarray(depth))
    zs = np.asarray(depth)[vs, us].astype(np.float64)
    xs = (us - K[0, 2]) * zs / K[0, 0]
    ys = (vs - K[1, 2]) * zs / K[1, 1]
    pts = np.stack([xs, ys, zs], 1)
    colors = np.asarray(rgb)[vs, us] if rgb is not None else None
    return pts, colors, np.stack([us, vs], 1)


def calc_2d_bbox(xs, ys, im_size=None, clip=False):
    """[x, y, w, h] bbox of 2-D points (misc.py:82-90)."""
    tl = [int(np.min(xs)), int(np.min(ys))]
    br = [int(np.max(xs)), int(np.max(ys))]
    if clip:
        assert im_size is not None
        tl = [min(max(tl[0], 0), im_size[0] - 1), min(max(tl[1], 0), im_size[1] - 1)]
        br = [min(max(br[0], 0), im_size[0] - 1), min(max(br[1], 0), im_size[1] - 1)]
    return [tl[0], tl[1], br[0] - tl[0], br[1] - tl[1]]


def calc_pose_2d_bbox(model, im_size, K, R_m2c, t_m2c):
    p = np.round(project_pts(model["pts"], K, R_m2c, t_m2c)).astype(np.int64)
    return calc_2d_bbox(p[:, 0], p[:, 1], im_size)


def model_diameter(pts: np.ndarray, chunk: int = 2048) -> float:
    """Max pairwise distance (reference computes it per model for the
    ADD/ADI 0.1d threshold, misc.py:142-171)."""
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    best = 0.0
    for i in range(0, n, chunk):
        a = pts[i : i + chunk]
        d2 = ((a[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        best = max(best, float(d2.max()))
    return float(np.sqrt(best))


def transform_pts_Rt(pts, R, t):
    return np.asarray(pts) @ np.asarray(R).T + np.asarray(t).reshape(1, 3)


def norm_depth(depth, valid_start: float = 0.2, valid_end: float = 1.0):
    """Normalize nonzero depth into [valid_start, valid_end] for display
    (misc.py:35-42)."""
    d = np.asarray(depth, np.float64).copy()
    m = d > 0
    if m.any():
        d[m] -= d[m].min()
        mx = d[m].max()
        if mx > 0:
            d[m] *= (valid_end - valid_start) / mx
        d[m] += valid_start
    return d


def crop_im(im, roi):
    """Crop [x, y, w, h] (inclusive like the reference, misc.py:97-106)."""
    im = np.asarray(im)
    y0, y1 = max(roi[1], 0), min(roi[1] + roi[3] + 1, im.shape[0])
    x0, x1 = max(roi[0], 0), min(roi[0] + roi[2] + 1, im.shape[1])
    return im[y0:y1, x0:x1]


def paste_im(src, trg, pos):
    """Paste src into trg at (x, y) with clipping (misc.py paste_im)."""
    x, y = pos
    h = min(src.shape[0], trg.shape[0] - y)
    w = min(src.shape[1], trg.shape[1] - x)
    trg[y : y + h, x : x + w] = src[:h, :w]
    return trg
