"""Train template banks for SIXD dataset objects by rendering view spheres.

Twin of the JAX package's ``tools/train_templates.py`` (reference:
tools/render_train_imgs.py, per-dataset radii :29-81, and the
'render_train' mode of linemod_and_levelup_test.py:164-272).

Example:
  python -m sixdpose_tpu_torch.tools.train_templates --dataset hinterstoisser \
      --objects 6 --radii 600 --min-views 100 --out banks/
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Sequence, Tuple

import numpy as np

from sixdpose_tpu_torch.config import ColorGradientConfig, DepthNormalConfig, DetectorConfig
from sixdpose_tpu_torch.models.detector import Detector
from sixdpose_tpu_torch.models.train import render_train_templates

# Per-dataset view-sphere radii (reference render_train_imgs.py:29-81).
DEFAULT_RADII = {
    "hinterstoisser": [600],
    "tless": [650],
    "tudlight": [850],
    "rutgers": [590],
    "tejani": [720],
    "doumanoglou": [455],
    "toyotalight": [600],
}
DEFAULT_K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]])


def detector_config(max_feats: int = 63, t_levels: Sequence[int] = (4, 8)) -> DetectorConfig:
    return DetectorConfig(
        t_at_level=tuple(t_levels),
        color=ColorGradientConfig(num_features=max_feats),
        depth=DepthNormalConfig(num_features=max_feats),
    )


def train_object(model: dict, K: np.ndarray, class_id: str, radii: Sequence[float], min_views: int,
                 im_size: Tuple[int, int], cfg: DetectorConfig, device=None, verbose: bool = False):
    """A detector holding one class trained from ``model``'s rendered view
    spheres; returns (detector, stats)."""
    det = Detector(cfg, device)
    stats = render_train_templates(det, class_id, model, K, radii=radii, min_n_views=min_views,
                                   im_size=tuple(im_size), verbose=verbose, device=device)
    return det, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="hinterstoisser")
    ap.add_argument("--base-path", default=None, help="SIXD datasets root")
    ap.add_argument("--objects", type=int, nargs="*", default=None)
    ap.add_argument("--radii", type=float, nargs="*", default=None)
    ap.add_argument("--min-views", type=int, default=100)
    ap.add_argument("--max-feats", type=int, default=63)
    ap.add_argument("--t-levels", type=int, nargs="*", default=[4, 8])
    ap.add_argument("--im-size", type=int, nargs=2, default=None, help="override render size (W H)")
    ap.add_argument("--out", default="banks")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from sixdpose_tpu_torch.data import get_dataset_params, inout

    dp = get_dataset_params(args.dataset, base_path=args.base_path)
    K = dp["cam"]["K"] if dp.get("cam") else DEFAULT_K
    radii = args.radii or DEFAULT_RADII.get(args.dataset, [600])
    objects = args.objects or range(1, dp["obj_count"] + 1)
    os.makedirs(args.out, exist_ok=True)
    cfg = detector_config(args.max_feats, args.t_levels)
    for obj_id in objects:
        model_path = dp["model_mpath"].format(obj_id)
        if not os.path.exists(model_path):
            print(f"obj {obj_id}: model missing at {model_path}; skipping")
            continue
        det, stats = train_object(inout.load_ply(model_path), K, f"obj_{obj_id:02d}", radii, args.min_views,
                                  tuple(args.im_size) if args.im_size else dp["train_im_size"], cfg, args.device,
                                  verbose=True)
        out = os.path.join(args.out, f"obj_{obj_id:02d}.npz")
        det.write_classes(out)
        print(f"obj {obj_id}: {stats} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
