"""Run detection + refinement over SIXD test scenes and write SIXD-2017
result files.

Twin of the JAX package's ``tools/detect_sixd.py`` (reference: the 'test'
mode of linemod_and_levelup_test.py:278-394 and
inout.save_results_sixd17).

Example:
  python -m sixdpose_tpu_torch.tools.detect_sixd --dataset hinterstoisser \
      --scenes 6 --banks banks/ --out results/sixdpose_hinterstoisser
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.models.detector import Detector
from sixdpose_tpu_torch.serving import PoseEstimationService


def detect_image(det: Detector, model: dict, rgb: np.ndarray, depth: np.ndarray, K: np.ndarray,
                 threshold: float = 75.0, max_refine: int = 8, device=None):
    """One test image through ``PoseEstimationService`` (a service per
    image, for the image's camera); returns (the SIXD-2017 result dict
    ``{"ests": [{"score", "R", "t"}]}``, seconds)."""
    cid = det.class_ids()[0]
    svc = PoseEstimationService(det, {cid: model}, K, threshold=threshold, max_refine=max_refine, device=device)
    t0 = time.time()
    ests = svc.process_frame(rgb, depth)
    run_time = time.time() - t0
    return {"ests": [{"score": e.similarity / 100.0, "R": e.R, "t": e.t} for e in ests]}, run_time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="hinterstoisser")
    ap.add_argument("--base-path", default=None)
    ap.add_argument("--scenes", type=int, nargs="*", default=None)
    ap.add_argument("--banks", default="banks")
    ap.add_argument("--threshold", type=float, default=75.0)
    ap.add_argument("--max-refine", type=int, default=8)
    ap.add_argument("--out", default="results/sixdpose")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from sixdpose_tpu_torch.data import get_dataset_params, inout

    dp = get_dataset_params(args.dataset, base_path=args.base_path)
    scenes = args.scenes or range(1, dp["scene_count"] + 1)
    for scene_id in scenes:
        obj_id = scene_id  # SIXD: scene k contains object k (and others)
        bank_path = os.path.join(args.banks, f"obj_{obj_id:02d}.npz")
        model_path = dp["model_mpath"].format(obj_id)
        if not (os.path.exists(bank_path) and os.path.exists(model_path)):
            print(f"scene {scene_id}: bank or model missing; skipping")
            continue
        det = Detector.read_classes(bank_path, DetectorConfig(), device=args.device)
        model = inout.load_ply(model_path)
        scene_info = inout.load_info(dp["scene_info_mpath"].format(scene_id))
        out_dir = os.path.join(args.out, f"{scene_id:02d}")
        os.makedirs(out_dir, exist_ok=True)
        for im_id in sorted(scene_info.keys()):
            res, run_time = detect_image(
                det, model,
                inout.load_im(dp["test_rgb_mpath"].format(scene_id, im_id)),
                inout.load_depth(dp["test_depth_mpath"].format(scene_id, im_id)),
                scene_info[im_id]["cam_K"], args.threshold, args.max_refine, args.device,
            )
            inout.save_results_sixd17(os.path.join(out_dir, f"{im_id:04d}_{obj_id:02d}.yml"), res, run_time)
            print(f"scene {scene_id} im {im_id}: {len(res['ests'])} ests {run_time:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
