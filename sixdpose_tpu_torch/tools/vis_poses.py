"""Visualize estimated or ground-truth poses as render overlays: each
pose's model is rendered in depth mode and its silhouette blended green
over the test image, one PNG per image.

Twin of the JAX package's ``tools/vis_poses.py`` (reference:
tools/vis_sixd_poses.py / vis_gt_poses.py, writing PNGs instead of imshow
windows).

Example:
  python -m sixdpose_tpu_torch.tools.vis_poses --dataset hinterstoisser \
      --scene 6 --results results/sixdpose --out vis/
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
from typing import Dict, List, Tuple

import numpy as np

from sixdpose_tpu_torch.data import get_dataset_params, inout
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.geometry.render import render

GREEN = np.array([0, 255, 0], np.float32)


def overlay(rgb: np.ndarray, poses: List[Tuple[int, np.ndarray, np.ndarray]], models: Dict[int, dict],
            K: np.ndarray, alpha: float = 0.5, device=None) -> np.ndarray:
    """``rgb`` (H, W, 3) uint8 with the silhouette of each (obj_id, R, t)
    pose blended green in turn, in float32 and truncated to uint8.  The
    depth renders run on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    vis = rgb.astype(np.float32)
    for oid, R, t in poses:
        d = render(models[oid], (rgb.shape[1], rgb.shape[0]), K, R, t, mode="depth", device=dev).cpu().numpy()
        mask = d > 0
        vis[mask] = (1 - alpha) * vis[mask] + alpha * GREEN
    return vis.astype(np.uint8)


def image_poses(gts_im: List[dict], results: str, scene: int, im_id: int) -> list:
    """(obj_id, R, t) of every estimate in the SIXD-2017 result files of one
    image under ``results``, or of its ground truth when ``results`` is
    empty."""
    poses = []
    if results:
        for p in glob.glob(os.path.join(results, f"{scene:02d}", f"{im_id:04d}_*.yml")):
            m = re.match(r"\d+_(\d+)\.yml", os.path.basename(p))
            for e in inout.load_results_sixd17(p)["ests"]:
                poses.append((int(m.group(1)), e["R"], e["t"]))
    else:
        for g in gts_im:
            poses.append((g["obj_id"], g["cam_R_m2c"], g["cam_t_m2c"]))
    return poses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="hinterstoisser")
    ap.add_argument("--base-path", default=None)
    ap.add_argument("--scene", type=int, required=True)
    ap.add_argument("--results", default=None, help="omit to draw GT poses")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dp = get_dataset_params(args.dataset, base_path=args.base_path)
    scene_info = inout.load_info(dp["scene_info_mpath"].format(args.scene))
    gts = inout.load_gt(dp["scene_gt_mpath"].format(args.scene))
    os.makedirs(args.out, exist_ok=True)
    models = {}
    for im_id in sorted(scene_info.keys()):
        rgb = inout.load_im(dp["test_rgb_mpath"].format(args.scene, im_id))
        poses = image_poses(gts.get(im_id, []), args.results, args.scene, im_id)
        for oid, _, _ in poses:
            if oid not in models:
                models[oid] = inout.load_ply(dp["model_mpath"].format(oid))
        out = os.path.join(args.out, f"{args.scene:02d}_{im_id:04d}.png")
        inout.save_im(out, overlay(rgb, poses, models, scene_info[im_id]["cam_K"], args.alpha, args.device))
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
