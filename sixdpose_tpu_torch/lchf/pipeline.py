"""LCHF end-to-end pipeline driver (reference LCHF_test.py analog).

The twin of the JAX package's ``tools/lchf_pipeline.py``, with the same
modes, flags and defaults, on the GPU unless ``--cpu``:

  render_train : render views of the box mesh (320 x 240, f = 280, radius
                 500), crop 50-px patches at stride 10, build features
                 (image ops on the device), train the forest (host
                 similarities, as the JAX tool), save it (npz, the JAX
                 package's layout).
  test         : dense scene ROIs -> whole-scene response crops -> forest
                 prediction (the walk on the device) -> hough voting ->
                 top-K pose-bin hypotheses.
  demo         : both, on a synthetic scene (no dataset needed).
  eval         : vote-bin recall over held-out views, with and without
                 mean-shift leaf-mode voting.
  pose_eval    : vote bins decoded to 6D poses, batched ICP, ADD-S@0.1d.

Example:
  python -m sixdpose_tpu_torch.lchf.pipeline demo --views 20
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

IM_SIZE = (320, 240)
RADIUS = 500.0


def build_demo_assets(views: int, seed: int = 0):
    """(K, the box mesh, ``views`` sampled at 500 mm)."""
    from sixdpose_tpu_torch.benchmark import make_models
    from sixdpose_tpu_torch.geometry.view_sampler import sample_views

    K = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1]])
    model = make_models()["box"]
    vs, _ = sample_views(views, radius=RADIUS)
    return K, model, vs


def render_view(model, K, view, device):
    """(rgb uint8, depth uint16) numpy render of one view."""
    from sixdpose_tpu_torch.geometry.render import render

    rgb, depth = render(model, IM_SIZE, K, view["R"], view["t"], mode="rgb+depth", device=device)
    return rgb.cpu().numpy(), depth.cpu().numpy().astype(np.uint16)


def training_patches(model, K, views, cfg, device, patch: int = 50, stride: int = 10):
    """Every view's labeled training patches: (patches, rpys, ts)."""
    from sixdpose_tpu_torch.lchf.model import make_training_patches

    patches, rpys, ts = [], [], []
    for view in views:
        rgb, depth = render_view(model, K, view, device)
        mask = (depth > 0).astype(np.uint8) * 255
        p, r, t = make_training_patches(rgb, depth, mask, view["R"], cfg, patch, stride, device=device)
        patches.extend(p)
        rpys.extend(r)
        ts.extend(t)
    return patches, rpys, ts


def render_train(args) -> int:
    from sixdpose_tpu_torch.lchf.feature import LchfConfig
    from sixdpose_tpu_torch.lchf.model import train_forest

    K, model, views = build_demo_assets(args.views, args.seed)
    cfg = LchfConfig()
    t0 = time.time()
    patches, rpys, ts = training_patches(model, K, views, cfg, args.device)
    print(f"{len(patches)} patches from {len(views)} views ({time.time()-t0:.1f}s)")
    model_l = train_forest(patches, np.asarray(rpys, np.float32), np.asarray(ts, np.float32), cfg)
    model_l.save(args.out)
    print(f"forest saved to {args.out}*")
    return 0


def test(args) -> int:
    from sixdpose_tpu_torch.lchf.feature import LchfConfig
    from sixdpose_tpu_torch.lchf.model import LchfModel, predict_scene, scene_roi_set
    from sixdpose_tpu_torch.lchf.voting import dense_rois, hough_vote

    cfg = LchfConfig()
    model_l = LchfModel.load(args.out)
    K, model, views = build_demo_assets(2, args.seed + 1)
    rgb, depth = render_view(model, K, views[0], args.device)

    t0 = time.time()
    rois = dense_rois(depth, stride=args.stride, device=args.device)
    roi_set = scene_roi_set(rgb, depth, rois, cfg, args.device)
    leaves = predict_scene(model_l, roi_set, cfg, on_device=True, device=args.device)
    bins, scores, _votes = hough_vote(
        leaves, model_l.leaf_feats_map(), rois, model_l.rpy, model_l.t, IM_SIZE,
        train_radius=RADIUS, top_k=args.top_k, device=args.device,
    )
    print(f"{len(rois)} rois -> top-{args.top_k} vote bins ({time.time()-t0:.1f}s):")
    for b, s in zip(np.asarray(bins), np.asarray(scores)):
        print(json.dumps({"bin": b.tolist(), "score": round(float(s), 3)}))
    return 0


def evaluate(args) -> int:
    """Quantitative recall over held-out rendered views, with and without
    mean-shift leaf-mode voting (lchf/eval.py)."""
    from sixdpose_tpu_torch.geometry.view_sampler import sample_views
    from sixdpose_tpu_torch.lchf.eval import evaluate_recall
    from sixdpose_tpu_torch.lchf.feature import LchfConfig
    from sixdpose_tpu_torch.lchf.model import LchfModel

    cfg = LchfConfig()
    model_l = LchfModel.load(args.out)
    K, model, _ = build_demo_assets(2, args.seed)
    test_views, _ = sample_views(args.eval_views, radius=RADIUS)

    for use_modes in (False, True):
        t0 = time.time()
        r = evaluate_recall(
            model_l, model, K, IM_SIZE, test_views, train_radius=RADIUS, cfg=cfg, stride=args.stride,
            top_k=args.top_k, leaf_modes=use_modes, device=args.device,
        )
        name = "leaf_modes" if use_modes else "raw_samples"
        print(json.dumps({name: {
            "recall": round(r["recall"], 3),
            "top1_recall": round(r["top1_recall"], 3),
            "mean_center_err_px": (
                round(r["mean_center_err_px"], 1) if r["mean_center_err_px"] is not None else None
            ),
            "n_views": r["n_views"],
            "time_s": round(time.time() - t0, 1),
        }}))
    return 0


def pose_eval(args) -> int:
    """LCHF all the way to 6D poses + batched ICP, scored ADD-S@0.1d
    (lchf/pose.py)."""
    from sixdpose_tpu_torch.geometry.view_sampler import sample_views
    from sixdpose_tpu_torch.lchf.feature import LchfConfig
    from sixdpose_tpu_torch.lchf.model import LchfModel
    from sixdpose_tpu_torch.lchf.pose import evaluate_pose_recall

    cfg = LchfConfig()
    model_l = LchfModel.load(args.out)
    K, model, train_views = build_demo_assets(args.views, args.seed)
    if args.in_sample:
        test_views = train_views[: args.eval_views]
    else:
        test_views, _ = sample_views(args.eval_views, radius=RADIUS)

    leaf_modes = None
    if args.leaf_modes:
        from sixdpose_tpu_torch.lchf.voting import leaf_mode_map

        leaf_modes = leaf_mode_map(model_l)

    t0 = time.time()
    r = evaluate_pose_recall(
        model_l, model, K, IM_SIZE, test_views, train_radius=RADIUS, cfg=cfg, stride=args.stride,
        top_k=args.top_k, icp_seeds=args.icp_seeds, leaf_modes=leaf_modes, device=args.device,
    )
    record = {
        "recall_add_s": round(r["recall"], 3),
        "n_views": r["n_views"],
        "diameter_mm": round(r["diameter_mm"], 1),
        "threshold_mm": round(r["threshold_mm"], 2),
        "metric": r["metric"],
        "time_s": round(time.time() - t0, 1),
        "records": r["records"],
    }
    print(json.dumps(record))
    if args.artifact:
        from sixdpose_tpu_torch.utils.artifacts import write_artifact

        write_artifact(args.artifact, record, config=vars(args), device=args.device)
        print(f"wrote {args.artifact}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=["render_train", "test", "demo", "eval", "pose_eval"])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "lchf_model"),
                    help="model prefix (<out>.forest.npz, <out>.patches.npz)")
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--eval-views", type=int, default=12)
    ap.add_argument("--stride", type=int, default=10)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--artifact", default=None,
                    help="pose_eval: write the stamped JSON record here")
    ap.add_argument("--leaf-modes", action="store_true",
                    help="pose_eval: vote with mean-shift leaf MODES "
                         "(lchf/meanshift.py) instead of raw leaf samples")
    ap.add_argument("--icp-seeds", type=int, default=5,
                    help="pose_eval: in-plane ICP seed fan per hypothesis")
    ap.add_argument("--in-sample", action="store_true",
                    help="pose_eval: evaluate on the TRAINING view poses "
                         "(default: a fresh view sampling = held out)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU, which must be present)")
    args = ap.parse_args(argv)
    from sixdpose_tpu_torch.device import resolve_device

    args.device = str(resolve_device("cpu" if args.cpu else None))
    if args.mode in ("render_train", "demo"):
        rc = render_train(args)
        if rc:
            return rc
    if args.mode in ("test", "demo"):
        return test(args)
    if args.mode == "eval":
        return evaluate(args)
    if args.mode == "pose_eval":
        return pose_eval(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
