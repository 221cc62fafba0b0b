"""Render-based template training.

Port of the JAX package's ``models/train.py``.  Reference flow
(linemod_and_levelup_test.py:263-272 'render_train' mode and
linemod_ros/train.py:21-128): sample camera views on a sphere around the
object, render RGB-D at each view, and add a template per view with the
render's depth>0 mask; per-template pose info (cam_K, cam_R_w2c, cam_t_w2c)
is stored alongside (inout.save_info), with the train-time ICP artifacts the
fused pipelines read.

The renders and their quantization run on the device in batches of 16 views
and are read back once per batch; the greedy feature extraction then runs
per view on the host, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.geometry.render import render_rgb_depth, render_textured, subdivide_mesh
from sixdpose_tpu_torch.geometry.view_sampler import sample_views
from sixdpose_tpu_torch.models.detector import Detector
from sixdpose_tpu_torch.models.refine import sample_model_points
from sixdpose_tpu_torch.models.templates import extract_template_from_quantized
from sixdpose_tpu_torch.ops import quantize as Q

BATCH = 16  # views rendered and quantized per device step


def _quantize(rgb: torch.Tensor, dep: torch.Tensor, cfg):
    """Per-level quantizations of a batch of renders, as
    ``extract_template_from_quantized`` takes them: colour (quantized,
    magnitude) per level and depth normals per level, each (B, ...)."""
    color = []
    if cfg.use_color:
        cur = rgb
        for l in range(cfg.pyramid_levels):
            if l > 0:
                cur = Q.pyr_down_rgb(cur)
            color.append(Q.quantize_color_gradient(cur, cfg.color.weak_threshold))
    depth = []
    if cfg.use_depth:
        depth = Q.depth_normal_pyramid(
            dep,
            cfg.pyramid_levels,
            cfg.depth.distance_threshold,
            cfg.depth.difference_threshold,
            cfg.depth.focal,
            cfg.depth.lut_parity,
        )
    return color, depth


def _add_views(
    detector: Detector,
    class_id: str,
    views: Sequence[dict],
    rgb: torch.Tensor,
    dep: torch.Tensor,
    K: np.ndarray,
    radius: float,
    view_id: int,
) -> Tuple[int, int]:
    """Quantize one batch of renders of ``views`` (rgb (B, H, W, 3) uint8,
    dep (B, H, W) float32 mm, B >= len(views), on any device), read it back
    once, and add a template per view to ``detector``'s bank, numbering the
    views from ``view_id``.  Returns (added, failed)."""
    cfg = detector.cfg
    levels = cfg.pyramid_levels
    # The float render crosses into the detector as uint16 (truncated), held
    # in int32.
    color_b, depth_b = _quantize(rgb, dep.to(torch.int32), cfg)
    rgb_np, dep_np = rgb.cpu().numpy(), dep.cpu().numpy()
    color_np = [(q.cpu().numpy(), m.cpu().numpy()) for q, m in color_b]
    depth_np = [d.cpu().numpy() for d in depth_b]

    added = failed = 0
    for j, view in enumerate(views):
        vi = view_id + j
        depth_mm = dep_np[j]
        mask = (depth_mm > 0).astype(np.uint8) * 255
        if mask.sum() == 0:
            failed += 1
            continue
        color_levels = [(color_np[l][0][j], color_np[l][1][j]) for l in range(levels)] if cfg.use_color else None
        depth_levels = [depth_np[l][j] for l in range(levels)] if cfg.use_depth else None
        tl = extract_template_from_quantized(color_levels, depth_levels, mask, cfg)
        if tl is None:
            failed += 1
            continue
        # Train-time ICP artifacts: the visible-surface cloud, render bbox,
        # and anchor depth, so serving never has to re-render templates.
        icp_pts, icp_valid, (pys, pxs) = sample_model_points(
            depth_mm.astype(np.uint16), np.asarray(K), 512, return_pixels=True
        )
        icp_colors = rgb_np[j][pys, pxs].astype(np.uint8)
        ys_r, xs_r = np.nonzero(depth_mm > 0)
        info = {
            "cam_K": np.asarray(K, np.float64),
            "cam_R_w2c": np.asarray(view["R"], np.float64),
            "cam_t_w2c": np.asarray(view["t"], np.float64).reshape(3, 1),
            "radius": float(radius),
            "view_id": vi,
            "icp_points": icp_pts[icp_valid].astype(np.float32),
            "icp_colors": icp_colors,
            "render_bbox": np.array([xs_r.min(), ys_r.min(), xs_r.max(), ys_r.max()]),
            "anchor_depth": float(np.median(depth_mm[depth_mm > 0])),
        }
        detector.bank.add_template_levels(class_id, tl, info=info)
        detector.invalidate(class_id)
        added += 1
    return added, failed


def training_mesh(model: dict, K: np.ndarray, radius: float):
    """The mesh as training renders it at view radius ``radius`` mm:
    subdivided once so that the batched renderer's fixed tile covers every
    projected triangle.  Returns (pts (V, 3), faces (F, 3), colors (V, 3)
    0-255, uv (V, 2) or None), numpy float64 and int64; ``uv`` is carried
    through the subdivision for texture-mapped models (reference
    renderer.py:316-321)."""
    pts_np = np.asarray(model["pts"], np.float64)
    faces_np = np.asarray(model["faces"], np.int64)
    colors_np = (
        np.asarray(model.get("colors"), np.float64)
        if model.get("colors") is not None
        else np.full((len(pts_np), 3), 127.0)
    )
    use_texture = model.get("texture") is not None and "texture_uv" in model
    if use_texture:
        colors_np = np.concatenate([colors_np, np.asarray(model["texture_uv"], np.float64)], 1)
    extent = float(np.linalg.norm(pts_np, axis=1).max())
    z_min = max(float(radius) - extent, 50.0)
    ppm = max(K[0][0], K[1][1]) / z_min
    tri = pts_np[faces_np]
    edge_max = float(
        max(
            np.linalg.norm(tri[:, 0] - tri[:, 1], axis=1).max(),
            np.linalg.norm(tri[:, 1] - tri[:, 2], axis=1).max(),
            np.linalg.norm(tri[:, 2] - tri[:, 0], axis=1).max(),
        )
    )
    if edge_max * ppm > 14:
        pts_np, faces_np, colors_np = subdivide_mesh(pts_np, faces_np, max_edge=14.0 / ppm, attrs=colors_np)
    return pts_np, faces_np, colors_np[:, :3], (colors_np[:, 3:5] if use_texture else None)


def render_train_templates(
    detector: Detector,
    class_id: str,
    model: dict,
    K: np.ndarray,
    radii: Sequence[float],
    min_n_views: int = 100,
    im_size: Tuple[int, int] = (640, 480),
    azimuth_range: Tuple[float, float] = (0.0, 2 * math.pi),
    elev_range: Tuple[float, float] = (0.0, 0.5 * math.pi),
    tilt_range: Tuple[float, float] = (-0.5 * math.pi, 0.5 * math.pi),
    tilt_step: float = 0.2 * math.pi,
    verbose: bool = False,
    device=None,
) -> Dict[str, int]:
    """Train a template bank from rendered views.

    Args:
      detector: target detector (templates are added to its bank).
      model: mesh dict with 'pts' (mm), 'faces', optional 'colors'
        (texture-mapped with 'texture' and 'texture_uv').
      K: (3, 3) camera intrinsics used for the renders.
      radii: view-sphere radii in mm; each radius is a scale variant
        (reference renders radii like [600] or [800, 1000],
        linemod_ros/train.py:32).
      device: where the views render and quantize: CUDA by default, raising
        when there is none; ``device="cpu"`` for the CPU.

    Returns stats: {'added': n_ok, 'failed': n_fail} (the reference skips
    views whose extraction fails, linemod_and_levelup_test.py:155).
    """
    device = resolve_device(device)
    added = failed = 0
    for radius in radii:
        views, _levels = sample_views(
            min_n_views,
            radius=float(radius),
            azimuth_range=azimuth_range,
            elev_range=elev_range,
            tilt_range=tilt_range,
            tilt_step=tilt_step,
        )

        pts_np, faces_np, colors_np, uv_np = training_mesh(model, K, float(radius))

        def up(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype))).to(device)

        pts, faces, Kt = up(pts_np), up(faces_np, np.int64), up(K)
        if uv_np is not None:
            tex_np = np.asarray(model["texture"], np.float32)
            if tex_np.max() > 1.0:
                tex_np = tex_np / 255.0
            uv, tex = up(uv_np), up(tex_np[..., :3])

            def batch_render(Rs, ts):
                return render_textured(pts, faces, uv, tex, Kt, Rs, ts, tuple(im_size))
        else:
            col = up(colors_np / 255.0)

            def batch_render(Rs, ts):
                return render_rgb_depth(pts, faces, col, Kt, Rs, ts, tuple(im_size))

        vi = 0
        for b0 in range(0, len(views), BATCH):
            vs = views[b0 : b0 + BATCH]
            # Short batches repeat their last view, as the JAX package pads.
            Rs = np.stack([v["R"] for v in vs] + [vs[-1]["R"]] * (BATCH - len(vs))).astype(np.float32)
            ts = np.stack([v["t"].flatten() for v in vs] + [vs[-1]["t"].flatten()] * (BATCH - len(vs)))
            rgb_b, dep_b = batch_render(up(Rs), up(ts))
            a, f = _add_views(detector, class_id, vs, rgb_b, dep_b, K, float(radius), vi)
            added, failed, vi = added + a, failed + f, vi + len(vs)
            if verbose and (b0 // BATCH) % 4 == 0:
                print(f"radius {radius}: view {vi}/{len(views)} added={added}")
    return {"added": added, "failed": failed}


def template_pose(detector: Detector, class_id: str, template_id: int):
    """(K, R, t) recorded for a template (for ICP seeding, reference
    linemod_and_levelup_test.py:345-376 reads the saved info YAML)."""
    info = detector.bank.infos[class_id][template_id]
    return info["cam_K"], info["cam_R_w2c"], info["cam_t_w2c"]
