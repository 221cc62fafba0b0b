"""3-D convex segmentation and global registration (reference: cxx_3d_seg/).

Port of the JAX package's ``seg/``.  API mirrors cxx_3d_seg.h:19-29:
``convex_cloud_seg(rgb, depth, K)`` -> segment indices + world/normal
maps; ``pose_estimation(cloud, model)`` -> 4x4 transform accepted by LCP
score.  Both run on the card unless ``device="cpu"``.  The path has no
learned parameters: model clouds are numpy arrays in both packages.
"""

from typing import Tuple

import numpy as np
import torch

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.seg.dasp import (
    DaspConfig,
    alic_iterate,
    convex_grouping,
    floyd_steinberg_seeds,
    pixel_stage,
)
from sixdpose_tpu_torch.seg.registration import pose_estimation
from sixdpose_tpu_torch.seg.slic import superpixels_asp, superpixels_slic

__all__ = [
    "DaspConfig",
    "pixel_stage",
    "floyd_steinberg_seeds",
    "alic_iterate",
    "convex_grouping",
    "convex_cloud_seg",
    "superpixel_stage",
    "pose_estimation",
    "superpixels_slic",
    "superpixels_asp",
]


def frame_tensors(rgb, depth, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W, 3) uint8 and (H, W) depth (numpy or tensors) on ``device``, the
    depth as int32 (uint16 values)."""
    if not isinstance(rgb, torch.Tensor):
        rgb = torch.from_numpy(np.ascontiguousarray(rgb, np.uint8))
    if not isinstance(depth, torch.Tensor):
        depth = torch.from_numpy(np.ascontiguousarray(depth).astype(np.int32))
    return rgb.to(device), depth.to(device=device, dtype=torch.int32)


def superpixel_stage(rgb, depth, cfg: DaspConfig, seed_pad: int = 128, device=None):
    """The device part of ``convex_cloud_seg``: pixel stage, seeds and ALIC.

    Returns (px, seeds (S, 2) float32, indices (H, W) int32 or None when
    there is no seed, superpixel dict or None), tensors on ``device``.
    """
    dev = resolve_device(device)
    rgb_t, depth_t = frame_tensors(rgb, depth, dev)
    px = pixel_stage(rgb_t, depth_t, cfg)
    seeds = floyd_steinberg_seeds(px["density"])
    n = seeds.shape[0]
    if n == 0:
        return px, seeds, None, None
    # Pad the seed count to a bucket, as the JAX package does for its
    # compiled shapes (the padding decides the buckets' seed order).
    s_pad = -(-n // seed_pad) * seed_pad
    seed_xy = torch.zeros((s_pad, 2), dtype=torch.float32, device=dev)
    seed_xy[:n] = seeds
    seed_valid = torch.arange(s_pad, device=dev) < n
    indices, sp = alic_iterate(px, seed_xy, seed_valid, cfg, s_pad)
    return px, seeds, indices, sp


def convex_cloud_seg(
    rgb: np.ndarray,
    depth: np.ndarray,
    K: np.ndarray,
    cfg: DaspConfig = None,
    seed_pad: int = 128,
    device=None,
):
    """Segment an RGB-D frame into convex parts, on ``device`` (the card
    unless ``"cpu"``); the grouping runs on the host.

    Reference: cxx_3d_seg::convex_cloud_seg (cxx_3d_seg.cpp:3-50) —
    DASP superpixels then convexity grouping.  Returns numpy
    (indices (H, W) int64 [-1 invalid], world (H, W, 3) float32 meters,
    normal (H, W, 3) float32).
    """
    K = np.asarray(K, np.float64)
    if cfg is None:
        cfg = DaspConfig(focal_px=float(K[0, 0]), cx=float(K[0, 2]), cy=float(K[1, 2]))
    px, _, indices, sp = superpixel_stage(rgb, depth, cfg, seed_pad, device)
    world = px["world"].cpu().numpy()
    normal = px["normal"].cpu().numpy()
    if indices is None:
        h, w = world.shape[:2]
        return np.full((h, w), -1, np.int64), world, normal
    table = torch.cat([sp["world"], sp["normal"], sp["num"][:, None]], dim=1).cpu().numpy()
    # Contiguous copies: numpy's small dot products may round differently
    # on strided views.
    sp_world, sp_normal, sp_num = (np.ascontiguousarray(table[:, a:b]) for a, b in ((0, 3), (3, 6), (6, 7)))
    segments = convex_grouping(indices.cpu().numpy(), sp_world, sp_normal, sp_num[:, 0], cfg)
    return segments, world, normal
