"""Render T-LESS ground-truth poses into test or train images for visual
checking: for every ``--im-step``-th image of each scene (test) or object
(train), an RGB overlay of the models rendered at their ground-truth poses
(a flat color per object id, the ground-truth boxes drawn), and for sensors
with depth a captured-minus-rendered depth-difference map (mm) as a signed
color PNG.

Twin of the JAX package's ``tools/check_poses_tless.py``
(t_less_toolkit/check_poses_test_imgs.py and check_poses_train_imgs.py, one
tool for both splits, PNG outputs instead of matplotlib windows).  The
renders run on ``--torch-device``, the card unless ``cpu``; ``--device`` is
the T-LESS sensor, as in the JAX tool.

Example:
  python -m sixdpose_tpu_torch.tools.check_poses_tless --base-path t-less_v2 \\
      --split test --device primesense --scenes 1 2 3 --im-step 100 \\
      --out vis_check/
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import numpy as np

from sixdpose_tpu_torch.data import inout
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.geometry.render import render

RGB_EXT = {"primesense": "png", "kinect": "png", "canon": "jpg"}
DEPTH_UNIT_MM = 0.1  # T-LESS stores depth in 0.1 mm


def _object_color(obj_id: int, table=None):
    """Color for an object id: row from a load_colors table when given,
    else a deterministic golden-angle hue (the toolkit ships a fixed
    obj_rgb.txt; without the dataset an equivalent is synthesized)."""
    if table is not None and 0 < obj_id <= len(table):
        return tuple(table[obj_id - 1])
    h = (obj_id * 0.61803398875) % 1.0
    i = int(h * 6.0)
    f = h * 6.0 - i
    v, p, q, tt = 1.0, 0.25, 1.0 - 0.75 * f, 0.25 + 0.75 * f
    rgb = [(v, tt, p), (q, v, p), (p, v, tt), (p, q, v), (tt, p, v), (v, p, q)]
    return rgb[i % 6]


def _draw_rect(im: np.ndarray, rect, color=(255, 255, 255)) -> np.ndarray:
    """Rectangle outline, rect = [x, y, w, h] (pytless/misc.py draw_rect)."""
    from PIL import Image, ImageDraw

    pil = Image.fromarray(im)
    d = ImageDraw.Draw(pil)
    d.rectangle((rect[0], rect[1], rect[0] + rect[2], rect[1] + rect[3]), outline=tuple(int(c) for c in color))
    return np.array(pil)


def _depth_diff_png(diff: np.ndarray, limit: float = 50.0) -> np.ndarray:
    """Signed depth difference (mm) -> red (negative) / blue (positive) uint8 image."""
    x = np.clip(diff / limit, -1.0, 1.0)
    img = np.full(diff.shape + (3,), 255, np.uint8)
    img[..., 1] = (255 * (1.0 - np.abs(x))).astype(np.uint8)
    img[..., 0] = np.where(x > 0, img[..., 1], 255)
    img[..., 2] = np.where(x > 0, 255, img[..., 1])
    img[diff == 0] = 0
    return img


def gt_overlay(rgb: np.ndarray, gts_im: List[dict], models: Dict[int, dict], K: np.ndarray, colors=None,
               device=None):
    """(overlay uint8, rendered depth float64 mm) of one image: each
    ground-truth pose's model rendered in its object's flat color, its box
    drawn, the renders summed at 0.7 and blended 0.6 / 0.4 over ``rgb``; the
    depth keeps the nearest rendered surface.  Renders run on ``device``
    (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    h, w = rgb.shape[:2]
    vis = np.zeros(rgb.shape, np.float64)
    ren_depth = np.zeros((h, w), np.float64)
    for gt in gts_im:
        oid = gt["obj_id"]
        ren_rgb, d = render(models[oid], (w, h), K, gt["cam_R_m2c"], gt["cam_t_m2c"], mode="rgb+depth",
                            surf_color=_object_color(oid, colors), device=dev)
        ren_rgb = ren_rgb.cpu().numpy()
        if "obj_bb" in gt:
            ren_rgb = _draw_rect(ren_rgb, gt["obj_bb"])
        vis += 0.7 * ren_rgb.astype(np.float64)
        d = d.cpu().numpy().astype(np.float64)
        closer = (ren_depth == 0) | ((d > 0) & (d < ren_depth))
        ren_depth = np.where((d > 0) & closer, d, ren_depth)
    return np.clip(0.6 * vis + 0.4 * rgb, 0, 255).astype(np.uint8), ren_depth


def depth_diff(depth_raw: np.ndarray, ren_depth: np.ndarray) -> np.ndarray:
    """The depth-difference PNG of a captured T-LESS depth (0.1 mm units)
    against a rendered one (mm): ``_depth_diff_png`` of captured minus
    rendered where both are present."""
    depth = depth_raw.astype(np.float64) * DEPTH_UNIT_MM
    valid = (depth > 0) & (ren_depth > 0)
    return _depth_diff_png(np.where(valid, depth - ren_depth, 0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--base-path", required=True)
    ap.add_argument("--split", choices=["test", "train"], default="test")
    ap.add_argument("--device", default="primesense", choices=["primesense", "kinect", "canon"],
                    help="the T-LESS sensor")
    ap.add_argument("--model-type", default="cad", choices=["cad", "reconst"])
    ap.add_argument("--scenes", type=int, nargs="+", default=list(range(1, 21)),
                    help="scene ids (test) or object ids (train)")
    ap.add_argument("--im-step", type=int, default=100)
    ap.add_argument("--obj-colors", default=None, help="optional obj_rgb.txt color table")
    ap.add_argument("--out", required=True)
    ap.add_argument("--torch-device", default=None, help="cuda (default) or cpu: where the renders run")
    args = ap.parse_args(argv)

    split_dir = f"{args.split}_{args.device}"
    model_mask = os.path.join(args.base_path, f"models_{args.model_type}", "obj_{:02d}.ply")
    os.makedirs(args.out, exist_ok=True)
    colors = inout.load_colors(args.obj_colors) if args.obj_colors else None

    models: Dict[int, dict] = {}
    for scene_id in args.scenes:
        scene_dir = os.path.join(args.base_path, split_dir, f"{scene_id:02d}")
        info = inout.load_info(os.path.join(scene_dir, "info.yml"))
        gts = inout.load_gt(os.path.join(scene_dir, "gt.yml"))
        for gt_list in gts.values():
            for gt in gt_list:
                if gt["obj_id"] not in models:
                    models[gt["obj_id"]] = inout.load_ply(model_mask.format(gt["obj_id"]))
        for im_id in sorted(info.keys()):
            if im_id % args.im_step != 0:
                continue
            rgb = inout.load_im(os.path.join(scene_dir, "rgb", f"{im_id:04d}.{RGB_EXT[args.device]}"))
            vis, ren_depth = gt_overlay(rgb, gts[im_id], models, info[im_id]["cam_K"], colors, args.torch_device)
            stem = f"{scene_id:02d}_{args.device}_{args.model_type}_{im_id:04d}"
            inout.save_im(os.path.join(args.out, stem + "_rgb.png"), vis)

            depth_path = os.path.join(scene_dir, "depth", f"{im_id:04d}.png")
            if args.device != "canon" and os.path.exists(depth_path):
                inout.save_im(os.path.join(args.out, stem + "_depth_diff.png"),
                              depth_diff(inout.load_depth(depth_path), ren_depth))
            print(f"scene {scene_id} im {im_id}: wrote {stem}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
