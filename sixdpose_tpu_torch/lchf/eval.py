"""Quantitative LCHF evaluation: vote-based pose-hypothesis recall.

Port of the JAX package's ``lchf/eval.py``.  The reference never scores
its Hough forest — LCHF_test.py:343-405 prints the top-10 vote bins and
the author abandoned tuning (README.md:12).  This harness closes that gap:
render held-out test views, run the full dense-ROI -> forest -> Hough-vote
pipeline, and measure how often the top-K vote bin lands on the true
object center and view angles.

A hypothesis from vote bin (bx, by, t0, t1, t2) decodes to
  center  = ((bx + 0.5) * steps, (by + 0.5) * steps)  [px]
  angles  = bin centers of the wrapped rpy bins       [rad]
and counts as a hit when the center is within ``tol_px`` of the rendered
object centroid AND every angle bin is within ``tol_bins`` (circularly)
of the ground-truth view rpy's bin.  Recall is reported for raw-sample
voting and optionally mean-shift leaf-mode voting (forest.cpp:200-228).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.geometry.transform import euler_from_matrix
from sixdpose_tpu_torch.lchf.feature import LchfConfig
from sixdpose_tpu_torch.lchf.model import LchfModel, predict_scene, scene_roi_set
from sixdpose_tpu_torch.lchf.voting import dense_rois, hough_vote, leaf_mode_map


def _angle_bin(a: float, num_bins: int) -> int:
    """Reference binning: int(rpy / 2 / 3.14 * nbins) mod nbins
    (LCHF_test.py:363-371 truncates toward zero, then wraps)."""
    return int(np.trunc(a / 2.0 / 3.14 * num_bins)) % num_bins


def _bin_dist(a: int, b: int, n: int) -> int:
    d = abs(a - b) % n
    return min(d, n - d)


def evaluate_recall(
    model_l: LchfModel,
    mesh_model: dict,
    K: np.ndarray,
    im_size,
    views: Sequence[dict],
    train_radius: float,
    cfg: LchfConfig = LchfConfig(),
    stride: int = 5,
    steps: int = 10,
    num_angle_bins: int = 10,
    top_k: int = 5,
    tol_px: float = 20.0,
    tol_bins: int = 1,
    leaf_modes: bool = False,
    on_device: bool = True,
    verbose: bool = False,
    device=None,
) -> Dict[str, object]:
    """Run the vote pipeline over ``views`` and score top-K hypotheses;
    ``on_device`` chooses the forest walk's route, ``device`` where the
    renders, image ops and the device route run.

    Returns a dict with ``recall`` (fraction of views with a hit in the
    top-K bins), ``top1_recall``, ``mean_center_err_px`` (over top-1
    hypotheses), and per-view records.
    """
    from sixdpose_tpu_torch.geometry.render import render

    device = resolve_device(device)
    modes = (
        leaf_mode_map(model_l) if leaf_modes else None
    )
    w, h = im_size
    records = []
    hits = top1_hits = 0
    center_errs = []
    for view in views:
        rgb, depth = render(
            mesh_model, im_size, K, view["R"], view["t"], mode="rgb+depth", device=device
        )
        rgb = rgb.cpu().numpy()
        depth = depth.cpu().numpy().astype(np.uint16)
        ys, xs = np.nonzero(depth > 0)
        if len(ys) == 0:
            continue
        # t labels are offsets from the rendered-mask centroid
        # (model.make_training_patches), so that is the vote target.
        gt_cx, gt_cy = float(xs.mean()), float(ys.mean())
        gt_rpy = np.asarray(euler_from_matrix(view["R"]), np.float64)
        gt_bins = [_angle_bin(a, num_angle_bins) for a in gt_rpy]

        rois = dense_rois(depth, stride=stride, device=device)
        if len(rois) == 0:
            records.append({"hit": False, "reason": "no rois"})
            continue
        roi_set = scene_roi_set(rgb, depth, rois, cfg, device)
        leaves = predict_scene(model_l, roi_set, cfg, on_device=on_device, device=device)
        bins, scores, _ = hough_vote(
            leaves,
            model_l.leaf_feats_map(),
            rois,
            model_l.rpy,
            model_l.t,
            im_size,
            train_radius=train_radius,
            steps=steps,
            num_angle_bins=num_angle_bins,
            top_k=top_k,
            leaf_modes=modes,
            device=device,
        )
        view_hit = False
        top1_err = None
        for rank, b in enumerate(np.asarray(bins)):
            cx = (b[0] + 0.5) * steps
            cy = (b[1] + 0.5) * steps
            err = float(np.hypot(cx - gt_cx, cy - gt_cy))
            if rank == 0:
                top1_err = err
            ang_ok = all(
                _bin_dist(int(b[2 + i]), gt_bins[i], num_angle_bins) <= tol_bins
                for i in range(3)
            )
            if err <= tol_px and ang_ok:
                view_hit = True
                if rank == 0:
                    top1_hits += 1
                break
        hits += view_hit
        if top1_err is not None:
            center_errs.append(top1_err)
        records.append(
            {"hit": bool(view_hit), "top1_center_err_px": top1_err,
             "gt_bins": gt_bins, "n_rois": int(len(rois))}
        )
        if verbose:
            print(f"view: hit={view_hit} top1_err={top1_err:.1f}px")

    n = len(records)
    return {
        "recall": hits / max(n, 1),
        "top1_recall": top1_hits / max(n, 1),
        "mean_center_err_px": float(np.mean(center_errs)) if center_errs else None,
        "n_views": n,
        "leaf_modes": bool(leaf_modes),
        "records": records,
    }
