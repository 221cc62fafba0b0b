"""Calculate per-estimate pose errors for SIXD result files.

Twin of the JAX package's ``tools/eval_calc_errors.py`` (reference:
tools/eval_calc_errors.py, protocol at :34-42: n_top=1, VSD delta=15
tau=20 cost=step).

Example:
  python -m sixdpose_tpu_torch.tools.eval_calc_errors --dataset hinterstoisser \
      --results results/sixdpose --error vsd --out eval/sixdpose
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
from typing import List, Optional

import numpy as np

from sixdpose_tpu_torch.eval.loc import calc_errors


def error_sign(error: str, n_top: int, vsd_delta: float, vsd_tau: float, vsd_cost: str) -> str:
    """The name of the errors' directory, as the reference names it."""
    sign = f"error={error}_ntop={n_top}"
    if error == "vsd":
        sign += f"_delta={vsd_delta:g}_tau={vsd_tau:g}_cost={vsd_cost}"
    return sign


def image_errors(im_id: int, obj_id: int, ests: List[dict], gts_im: List[dict], model: dict,
                 depth: Optional[np.ndarray], K: np.ndarray, error: str = "vsd", n_top: int = 1,
                 vsd_delta: float = 15.0, vsd_tau: float = 20.0, vsd_cost: str = "step", device=None) -> List[dict]:
    """The error entries of one image's estimates of one object against its
    ground-truth poses of that object, as the errors file holds them."""
    errs = calc_errors(ests, gts_im, model, depth, K, error_type=error, n_top=n_top, vsd_delta=vsd_delta,
                       vsd_tau=vsd_tau, vsd_cost=vsd_cost, device=device)
    return [
        {"im_id": im_id, "obj_id": obj_id, "est_id": e["est_id"], "score": float(e["score"]),
         "errors": {int(k): float(v) for k, v in e["errors"].items()}}
        for e in errs
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="hinterstoisser")
    ap.add_argument("--base-path", default=None)
    ap.add_argument("--results", required=True)
    ap.add_argument("--error", default="vsd", choices=["vsd", "add", "adi", "cou", "re", "te"])
    ap.add_argument("--n-top", type=int, default=1)
    ap.add_argument("--vsd-delta", type=float, default=15)
    ap.add_argument("--vsd-tau", type=float, default=20)
    ap.add_argument("--vsd-cost", default="step")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from sixdpose_tpu_torch.data import get_dataset_params, inout

    dp = get_dataset_params(args.dataset, base_path=args.base_path)
    sign = error_sign(args.error, args.n_top, args.vsd_delta, args.vsd_tau, args.vsd_cost)
    models = {}
    for scene_dir in sorted(glob.glob(os.path.join(args.results, "[0-9][0-9]"))):
        scene_id = int(os.path.basename(scene_dir))
        gts = inout.load_gt(dp["scene_gt_mpath"].format(scene_id))
        scene_info = inout.load_info(dp["scene_info_mpath"].format(scene_id))
        errors = []
        for res_path in sorted(glob.glob(os.path.join(scene_dir, "*.yml"))):
            m = re.match(r"(\d+)_(\d+)\.yml", os.path.basename(res_path))
            if not m:
                continue
            im_id, obj_id = int(m.group(1)), int(m.group(2))
            gts_im = [g for g in gts.get(im_id, []) if g["obj_id"] == obj_id]
            if not gts_im:
                continue
            if obj_id not in models:
                models[obj_id] = inout.load_ply(dp["model_mpath"].format(obj_id))
            depth = (inout.load_depth(dp["test_depth_mpath"].format(scene_id, im_id))
                     if args.error in ("vsd", "cou") else None)
            errors += image_errors(im_id, obj_id, inout.load_results_sixd17(res_path)["ests"], gts_im,
                                   models[obj_id], depth, scene_info[im_id]["cam_K"], args.error, args.n_top,
                                   args.vsd_delta, args.vsd_tau, args.vsd_cost, args.device)
        out_dir = os.path.join(args.out, sign)
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"errors_{scene_id:02d}.yml")
        inout.save_errors(out_path, errors)
        print(f"scene {scene_id}: {len(errors)} error entries -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
