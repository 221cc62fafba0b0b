"""Ground-truth visibility statistics: per ground-truth pose, render the
model, estimate its visible mask against the test depth, and record
``visib_fract``.

Twin of the JAX package's ``tools/calc_gt_stats.py`` (reference:
tools/calc_gt_stats.py).

Example:
  python -m sixdpose_tpu_torch.tools.calc_gt_stats --dataset hinterstoisser \
      --scenes 6 --delta 15 --out stats/
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.eval.misc import depth_im_to_dist_im
from sixdpose_tpu_torch.eval.pose_error import estimate_visib_mask_gt
from sixdpose_tpu_torch.geometry.render import render


def visib_stats(depth: np.ndarray, K: np.ndarray, gts_im: List[dict], models: Dict[int, dict], delta: float,
                device=None) -> List[dict]:
    """``{"visib_fract", "px_count_all"}`` of each ground-truth pose of one
    test image (``depth`` in mm), in order."""
    dev = resolve_device(device)
    Kt = torch.from_numpy(np.asarray(K, np.float32)).to(dev)
    dist_test = depth_im_to_dist_im(torch.from_numpy(depth.astype(np.float32)).to(dev), Kt)
    entries = []
    for gt in gts_im:
        d = render(models[gt["obj_id"]], (depth.shape[1], depth.shape[0]), K, gt["cam_R_m2c"], gt["cam_t_m2c"],
                   mode="depth", device=dev)
        visib = estimate_visib_mask_gt(dist_test, depth_im_to_dist_im(d, Kt), delta)
        full = int((d > 0).sum())
        entries.append({"visib_fract": float(int(visib.sum())) / max(full, 1), "px_count_all": full})
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="hinterstoisser")
    ap.add_argument("--base-path", default=None)
    ap.add_argument("--scenes", type=int, nargs="*", default=None)
    ap.add_argument("--delta", type=float, default=15.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import yaml

    from sixdpose_tpu_torch.data import get_dataset_params, inout

    dp = get_dataset_params(args.dataset, base_path=args.base_path)
    scenes = args.scenes or range(1, dp["scene_count"] + 1)
    os.makedirs(args.out, exist_ok=True)
    models = {}
    for scene_id in scenes:
        gts = inout.load_gt(dp["scene_gt_mpath"].format(scene_id))
        scene_info = inout.load_info(dp["scene_info_mpath"].format(scene_id))
        stats = {}
        for im_id, gts_im in sorted(gts.items()):
            for gt in gts_im:
                if gt["obj_id"] not in models:
                    models[gt["obj_id"]] = inout.load_ply(dp["model_mpath"].format(gt["obj_id"]))
            depth = inout.load_depth(dp["test_depth_mpath"].format(scene_id, im_id))
            stats[int(im_id)] = visib_stats(depth, scene_info[im_id]["cam_K"], gts_im, models, args.delta, args.device)
        out_path = os.path.join(args.out, f"{scene_id:02d}_delta={args.delta:g}.yml")
        with open(out_path, "w") as f:
            yaml.dump(stats, f, default_flow_style=None)
        print(f"scene {scene_id} -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
