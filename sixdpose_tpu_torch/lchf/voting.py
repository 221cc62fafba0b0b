"""Hough voting and scene ROI handling for LCHF.

Port of the JAX package's ``lchf/voting.py``.  Reference: LCHF_test.py:260-425
— dense ROIs at stride 5 with a 5x5 mean patch depth, forest leaf
prediction per ROI, then votes into a 5-D (x/10, y/10, theta0, theta1,
theta2) tensor with depth-ratio-scaled translation offsets; top-10 bins
are the pose hypotheses.

The votes accumulate on the device in a fixed order: each bin's votes are
added one after another in input order, as XLA's scatter-add on the CPU
adds them, so the vote tensor has the same bits on every device.  The bins
are computed as XLA compiles the JAX expressions: a division by a constant
becomes a multiplication by its float32 reciprocal, and
``rpy / 2.0 / 3.14 * bins`` one multiplication by a folded constant.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.lchf.feature import mean_depth_5x5


def dense_rois(
    depth: np.ndarray,
    stride: int = 5,
    width: int = 50,
    height: int = 50,
    dep_off: Tuple[int, int] = (10, 10),
    device=None,
) -> np.ndarray:
    """(M, 5) rois [x, y, w, h, patch_depth] (LCHF_test.py:303-334);
    patch depth = 5x5 mean of nonzero depth at (x+10, y+10); rois with no
    valid depth are dropped."""
    rows, cols = depth.shape
    zavg = mean_depth_5x5(depth, device)  # window centered; reference anchors top-left
    xs = np.arange(0, cols - width - 2 * stride, stride)
    ys = np.arange(0, rows - height - 2 * stride, stride)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    # reference averages depth[y+10 : y+15, x+10 : x+15] (top-left anchored);
    # our zavg is centered, so sample at +12.
    dz = zavg[np.clip(gy + dep_off[1] + 2, 0, rows - 1), np.clip(gx + dep_off[0] + 2, 0, cols - 1)]
    ok = dz > 0
    rois = np.stack(
        [gx[ok], gy[ok], np.full(ok.sum(), width), np.full(ok.sum(), height), dz[ok].astype(np.int64)],
        axis=1,
    )
    return rois.astype(np.int64)


def angle_bin_factor(num_angle_bins: int) -> np.float32:
    """The one float32 factor XLA folds ``rpy / 2.0 / 3.14 * num_angle_bins``
    into."""
    return np.float32(np.float32(0.5) * (np.float32(1.0) / np.float32(3.14))) * np.float32(num_angle_bins)


def _f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _coords(a, device) -> torch.Tensor:
    """float32 of host coordinates as JAX stages them: integers through
    int32, floats rounded to float32."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.float32))).to(device)


def accumulate_votes(
    roi_xy,          # (V, 2) roi x, y per vote
    roi_depth,       # (V,) patch depth per vote
    offsets,         # (V, 3) training-sample t (x, y, z offset)
    rpys,            # (V, 3) training-sample rpy
    weights,         # (V,) vote weight
    train_radius: float,
    vote_shape: Tuple[int, int, int, int, int],
    steps: int = 10,
    num_angle_bins: int = 10,
    device=None,
) -> torch.Tensor:
    """Sum all votes into the 5-D float32 tensor (LCHF_test.py:343-390), on
    ``device``.  Each bin's votes are added in input order."""
    device = resolve_device(device)
    nx, ny, na = vote_shape[0], vote_shape[1], vote_shape[2]
    xy = _coords(roi_xy, device)
    d = _coords(roi_depth, device)
    off = _f32(offsets, device)
    rpy = _f32(rpys, device)
    w = _f32(weights, device)
    one = torch.ones_like(d)
    scale = torch.full_like(d, float(np.float32(train_radius))) / torch.maximum(d, one)
    inv_steps = float(np.float32(1.0) / np.float32(steps))
    bx = ((xy[:, 0] - off[:, 0] * scale) * inv_steps).to(torch.int32)
    by = ((xy[:, 1] - off[:, 1] * scale) * inv_steps).to(torch.int32)
    th = (rpy * float(angle_bin_factor(num_angle_bins))).to(torch.int32)
    ok = (
        (bx >= 0) & (bx < nx) & (by >= 0) & (by < ny)
        & ((th >= -num_angle_bins) & (th < num_angle_bins)).all(dim=1)
    )
    th = (th % num_angle_bins).to(torch.int64)
    flat = (((bx.to(torch.int64) * ny + by) * na + th[:, 0]) * na + th[:, 1]) * na + th[:, 2]
    votes = torch.zeros(int(np.prod(vote_shape)), dtype=torch.float32, device=device)
    # A vote out of range adds 0.0 in the JAX code, which changes no sum.
    flat, w = flat[ok], w[ok]
    if flat.numel():
        order = torch.argsort(flat, stable=True)
        flat, w = flat[order], w[order]
        bins, counts = torch.unique_consecutive(flat, return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        seg = torch.repeat_interleave(torch.arange(bins.numel(), device=device), counts)
        rank = torch.arange(flat.numel(), device=device) - starts[seg]
        table = torch.zeros((bins.numel(), int(counts.max())), dtype=torch.float32, device=device)
        table[seg, rank] = w
        acc = torch.zeros((bins.numel(),), dtype=torch.float32, device=device)
        # One column at a time: every bin's running sum in input order (the
        # zero padding adds nothing).
        for r in range(table.shape[1]):
            acc = acc + table[:, r]
        votes[bins] = acc
    return votes.reshape(vote_shape)


def leaf_mode_map(model, bandwidth: float = 1.0):
    """Mean-shift mode clustering of every leaf's pose labels.

    The reference makes this reduction available at forest.cpp:200-228
    (lchf_helper::cluster over interleaved 6-D (rpy, t) leaf vectors) but
    its Python driver votes with raw samples; here both are first-class.
    Returns [tree] -> {leaf_id: (rpy_modes (C,3), t_modes (C,3),
    weights (C,))} with weights = cluster size / leaf size, so each leaf
    still contributes total weight 1 per tree.
    """
    from sixdpose_tpu_torch.lchf.meanshift import cluster_leaf_infos

    out = []
    for tree_leaves in model.leaf_feats_map():
        modes = {}
        for leaf, ids in tree_leaves.items():
            ids = np.asarray(ids)
            if len(ids) == 0:
                continue
            rpy_m, t_m, labels = cluster_leaf_infos(
                model.rpy[ids], model.t[ids], bandwidth
            )
            counts = np.bincount(labels, minlength=len(rpy_m)).astype(np.float64)
            modes[int(leaf)] = (rpy_m, t_m, counts / len(ids))
        out.append(modes)
    return out


def assemble_votes(
    leaf_per_tree_per_roi: Sequence[Sequence[int]],
    leaf_map,
    rois: np.ndarray,
    infos_rpy: np.ndarray,
    infos_t: np.ndarray,
    leaf_modes=None,
):
    """Expand (roi, tree) leaf predictions into flat vote arrays
    (roi_xy (V, 2), roi_depth (V,), offsets (V, 3), rpys (V, 3),
    weights (V,)) — the shared front half of voting and pose decoding."""
    roi_xy, roi_d, off, rpy, wgt = [], [], [], [], []
    num_trees = len(leaf_map)
    for ri, leaves in enumerate(leaf_per_tree_per_roi):
        for ti, leaf in enumerate(leaves):
            if leaf_modes is not None:
                entry = leaf_modes[ti].get(int(leaf))
                if entry is None:
                    continue
                rpy_m, t_m, wm = entry
                for ci in range(len(wm)):
                    roi_xy.append(rois[ri, :2])
                    roi_d.append(rois[ri, 4])
                    off.append(t_m[ci])
                    rpy.append(rpy_m[ci])
                    wgt.append(wm[ci] / num_trees)
                continue
            ids = leaf_map[ti].get(int(leaf))
            if ids is None or len(ids) == 0:
                continue
            wv = 1.0 / len(ids) / num_trees
            for sid in np.asarray(ids):
                roi_xy.append(rois[ri, :2])
                roi_d.append(rois[ri, 4])
                off.append(infos_t[sid])
                rpy.append(infos_rpy[sid])
                wgt.append(wv)
    if not roi_xy:
        z = np.zeros
        return (z((0, 2)), z((0,)), z((0, 3), np.float32),
                z((0, 3), np.float32), z((0,), np.float32))
    return (
        np.array(roi_xy),
        np.array(roi_d),
        np.array(off, np.float32),
        np.array(rpy, np.float32),
        np.array(wgt, np.float32),
    )


def top_bins(votes: np.ndarray, top_k: int):
    """The ``top_k`` highest bins of a host vote tensor, with numpy's
    default (unstable) argsort as the JAX code ranks them: (bins (k, 5),
    scores (k,))."""
    flat = votes.reshape(-1)
    k = min(top_k, flat.size)
    top = np.argsort(-flat)[:k]
    return np.stack(np.unravel_index(top, votes.shape), axis=1), flat[top]


def hough_vote(
    leaf_per_tree_per_roi: Sequence[Sequence[int]],
    leaf_map,
    rois: np.ndarray,
    infos_rpy: np.ndarray,
    infos_t: np.ndarray,
    im_size: Tuple[int, int],
    train_radius: float,
    steps: int = 10,
    num_angle_bins: int = 10,
    top_k: int = 10,
    leaf_modes=None,
    device=None,
):
    """Full voting pass: expand leaves to votes, accumulate, rank bins.

    Args:
      leaf_per_tree_per_roi: [roi][tree] -> leaf id.
      leaf_map: Forest.leaf_feats_map() output.
      infos_rpy / infos_t: (N_train, 3) labels.
      im_size: (W, H).
      leaf_modes: optional ``leaf_mode_map`` output — votes are then cast
        from each leaf's mean-shift modes (weight = cluster fraction)
        instead of every raw training sample.

    Returns (top bins (top_k, 5) int, top scores (top_k,), votes tensor),
    all numpy.
    """
    w, h = im_size
    vote_shape = (w // steps, h // steps, num_angle_bins, num_angle_bins, num_angle_bins)

    roi_xy, roi_d, off, rpy, wgt = assemble_votes(
        leaf_per_tree_per_roi, leaf_map, rois, infos_rpy, infos_t, leaf_modes
    )
    if len(roi_xy) == 0:
        empty = np.zeros(vote_shape, np.float32)
        return np.zeros((0, 5), np.int64), np.zeros(0, np.float32), empty

    votes = accumulate_votes(
        roi_xy, roi_d, off, rpy, wgt, float(train_radius), vote_shape, steps, num_angle_bins, device
    ).cpu().numpy()
    bins, scores = top_bins(votes, top_k)
    return bins, scores, votes
