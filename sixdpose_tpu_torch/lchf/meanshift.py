"""Mean-shift mode clustering for leaf pose labels.

Reference: cxxLCHF/meanshift/MeanShift.cpp:27-123 (gaussian kernel,
CLUSTER_EPSILON 0.5) used by lchf_helper::cluster (forest.cpp:200-228) on
6-D (rpy interleaved with t) vectors with bandwidth 1.  Vectorized numpy; a
copy of the JAX package's ``lchf/meanshift.py``.
"""

from __future__ import annotations

from typing import List

import numpy as np

CLUSTER_EPSILON = 0.5
_SHIFT_EPSILON = 1e-5


def mean_shift(points: np.ndarray, bandwidth: float = 1.0, max_iters: int = 100) -> np.ndarray:
    """Shift every point to its density mode (gaussian kernel)."""
    pts = np.asarray(points, np.float64)
    shifted = pts.copy()
    active = np.ones(len(pts), bool)
    for _ in range(max_iters):
        if not active.any():
            break
        cur = shifted[active]
        d2 = ((cur[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        w = np.exp(-0.5 * d2 / (bandwidth * bandwidth))
        new = (w[:, :, None] * pts[None, :, :]).sum(1) / w.sum(1)[:, None]
        move2 = ((new - cur) ** 2).sum(-1)
        shifted[active] = new
        idx = np.nonzero(active)[0]
        active[idx[move2 <= _SHIFT_EPSILON**2]] = False
    return shifted


def cluster_modes(points: np.ndarray, bandwidth: float = 1.0):
    """Group shifted points into clusters (MeanShift::cluster,
    MeanShift.cpp:96-123).  Returns (modes (C, D), labels (N,))."""
    shifted = mean_shift(points, bandwidth)
    modes: List[np.ndarray] = []
    labels = np.zeros(len(shifted), np.int64)
    for i, p in enumerate(shifted):
        for ci, m in enumerate(modes):
            if np.linalg.norm(p - m) <= CLUSTER_EPSILON:
                labels[i] = ci
                break
        else:
            labels[i] = len(modes)
            modes.append(p)
    return np.array(modes), labels


def cluster_leaf_infos(rpy: np.ndarray, t: np.ndarray, bandwidth: float = 1.0):
    """Cluster 6-D (rpy, t) pose labels of one leaf and return mode poses
    (lchf_helper::cluster, forest.cpp:200-228: interleaves rpy/t)."""
    pts = np.concatenate([rpy, t], axis=1)
    modes, labels = cluster_modes(pts, bandwidth)
    return modes[:, :3], modes[:, 3:], labels
