"""Record the JAX package's LCHF path at a cut size, as the golden the
PyTorch port is held to.

The configuration is that of ``tests/test_lchf.py::test_lchf_6d_pose_recall``:
the box mesh, 160 x 120, f = 200, the views of ``sample_views(8, radius=420)``
(120 poses), ``LchfConfig(num_features=6, extract_threshold=1,
strong_threshold=30)``, 40-px patches at stride 12, 2 trees with
``size_thresh=2`` and seed 1, then ``evaluate_pose_recall`` on the first
three views (dense ROIs at stride 8, top 5 bins, 5 ICP seeds).  The script
runs it on the CPU and writes ``sixdpose_tpu_torch/testdata/lchf_golden.npz``
(under 1 MB):

- the patch features of every training patch (features, relative depths,
  center depths, shapes), their labels, a checksum of every patch's
  response maps and mean depths, and the maps themselves for the first
  ``FULL_PATCHES``;
- the jit-route similarity matrix: every row's float64 sum, and the first
  ``FULL_ROWS`` rows whole;
- the forests of both routes (host numpy and jit): node tables,
  thresholds and each leaf's training samples;
- per evaluated view: the ROIs, the leaves of both prediction routes, the
  vote tensor (sparse), the top bins, the decoded hypotheses, the refined
  poses (and the refine stage at ``STEP_ITERS`` ICP iterations) and the
  error; and the recall;
- ``evaluate_recall`` (vote-bin recall, raw samples and leaf modes) on the
  first two views.

Run from the repository root on the CPU (about two minutes):

    JAX_PLATFORMS=cpu python tools/torch_port_lchf_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sixdpose_tpu.benchmark import make_models  # noqa: E402
from sixdpose_tpu.config import IcpConfig  # noqa: E402
from sixdpose_tpu.eval import pose_error  # noqa: E402
from sixdpose_tpu.geometry.render import render  # noqa: E402
from sixdpose_tpu.geometry.view_sampler import sample_views  # noqa: E402
from sixdpose_tpu.lchf import (  # noqa: E402
    LchfConfig,
    PatchSet,
    accumulate_votes,
    assemble_votes,
    decode_bin_poses,
    dense_rois,
    evaluate_pose_recall,
    evaluate_recall,
    make_training_patches,
    predict_scene,
    refine_lchf_poses,
    scene_roi_set,
    train_forest,
)
from sixdpose_tpu.lchf.device import similarity_matrix_device  # noqa: E402

OUT = os.path.join(ROOT, "sixdpose_tpu_torch", "testdata", "lchf_golden.npz")
IM_SIZE = (160, 120)
K = np.array([[200.0, 0, 80.0], [0, 200.0, 60.0], [0, 0, 1]])
RADIUS = 420.0
CFG = dict(num_features=6, extract_threshold=1, strong_threshold=30.0)
PATCH, STRIDE = 40, 12
FOREST = dict(num_trees=2, size_thresh=2, seed=1)
EVAL_VIEWS, ROI_STRIDE, TOP_K, ICP_SEEDS = 3, 8, 5, 5
STEPS, ANGLE_BINS = 10, 10
FULL_PATCHES, FULL_ROWS = 16, 32
RECALL_VIEWS = 2
# ICP iterations of the refine stage's short run: the two packages' float32
# ICP differ in the last bits, which 20 iterations from the far LCHF
# hypotheses amplify; two keep them within the tolerance.
STEP_ITERS = 2


def forest_arrays(prefix: str, forest, out: dict) -> None:
    """Node tables, thresholds and the leaves' training samples of a
    forest (the leaves' samples let a model be rebuilt without training)."""
    for ti, t in enumerate(forest.trees):
        out[f"{prefix}{ti}_nodes"] = np.array(
            [[int(nd.issplit), nd.pnode, nd.depth, nd.cnodes[0], nd.cnodes[1], int(nd.isleafnode), nd.split_feat_idx]
             for nd in t.nodes], np.int64)
        out[f"{prefix}{ti}_thresh"] = np.array([nd.simi_thresh for nd in t.nodes], np.float32)
        out[f"{prefix}{ti}_leaf_count"] = np.array([len(t.nodes[i].ind_feats) for i in t.id_leafnodes], np.int64)
        out[f"{prefix}{ti}_leaf_ids"] = np.concatenate([t.nodes[i].ind_feats for i in t.id_leafnodes]).astype(np.int64)


def view_record(model_l, mesh, view, cfg, depth_offset: float, vi: int, out: dict) -> None:
    """One view of evaluate_pose_recall, step by step (host route, as the
    test runs it), plus the jit route's leaves."""
    rgb, depth = render(mesh, IM_SIZE, K, view["R"], view["t"], mode="rgb+depth")
    rgb, depth = np.asarray(rgb), np.asarray(depth).astype(np.uint16)
    rois = dense_rois(depth, stride=ROI_STRIDE)
    roi_set = scene_roi_set(rgb, depth, rois, cfg)
    leaves = predict_scene(model_l, roi_set, cfg, device=False)
    leaves_jit = predict_scene(model_l, roi_set, cfg, device=True)
    arrays = assemble_votes(leaves, model_l.leaf_feats_map(), rois, model_l.rpy, model_l.t)
    h, w = depth.shape
    vote_shape = (w // STEPS, h // STEPS, ANGLE_BINS, ANGLE_BINS, ANGLE_BINS)
    votes = np.asarray(accumulate_votes(*(jnp.asarray(a) for a in arrays), RADIUS, vote_shape, STEPS, ANGLE_BINS))
    flat = votes.reshape(-1)
    top = np.argsort(-flat)[:TOP_K]
    top = top[flat[top] > 0]
    bins = np.stack(np.unravel_index(top, votes.shape), axis=1)
    hyps = decode_bin_poses(bins, *arrays, K, RADIUS, STEPS, ANGLE_BINS, depth_offset=depth_offset)
    R_r, t_r, fits, vscore = refine_lchf_poses(hyps, mesh, depth, K, None, icp_seeds=ICP_SEEDS)
    step = refine_lchf_poses(hyps, mesh, depth, K, IcpConfig(max_iters=STEP_ITERS), icp_seeds=ICP_SEEDS)
    best = int(np.argmax(vscore * 100.0 + np.maximum(fits, 0.0)))
    err = float(pose_error.adi(R_r[best], t_r[best].reshape(3, 1), np.asarray(view["R"]),
                               np.asarray(view["t"]).reshape(3, 1), mesh, max_pts=1024))
    nz = np.nonzero(flat)[0]
    out.update({
        f"v{vi}_rgb": rgb, f"v{vi}_depth": depth, f"v{vi}_rois": rois,
        f"v{vi}_leaves": np.asarray(leaves, np.int64), f"v{vi}_leaves_jit": np.asarray(leaves_jit, np.int64),
        f"v{vi}_votes_idx": nz.astype(np.int32), f"v{vi}_votes_val": flat[nz],
        f"v{vi}_bins": bins, f"v{vi}_scores": flat[top],
        f"v{vi}_hyp_R": np.array([hh["R"] for hh in hyps]), f"v{vi}_hyp_t": np.array([hh["t"] for hh in hyps]),
        f"v{vi}_hyp_weight": np.array([hh["weight"] for hh in hyps]),
        f"v{vi}_hyp_center": np.array([hh["center_px"] for hh in hyps]),
        f"v{vi}_R": R_r, f"v{vi}_t": t_r, f"v{vi}_fitness": fits, f"v{vi}_verify": vscore,
        f"v{vi}_best": np.int64(best), f"v{vi}_err": np.float64(err),
        **{f"v{vi}_step_{k}": a for k, a in zip(("R", "t", "fitness", "verify"), step)},
    })


def main() -> int:
    mesh = make_models()["box"]
    views, _ = sample_views(8, radius=RADIUS)
    cfg = LchfConfig(**CFG)
    feats, rpys, ts, per_view = [], [], [], []
    for v in views:
        rgb, depth = render(mesh, IM_SIZE, K, v["R"], v["t"], mode="rgb+depth")
        rgb, depth = np.asarray(rgb), np.asarray(depth).astype(np.uint16)
        mask = (depth > 0).astype(np.uint8) * 255
        p, r, t = make_training_patches(rgb, depth, mask, v["R"], cfg, patch=PATCH, stride=STRIDE)
        per_view.append(len(p))
        feats.extend(p)
        rpys.extend(r)
        ts.extend(t)
    rpys, ts = np.array(rpys), np.array(ts)
    out = {
        "patches_per_view": np.array(per_view, np.int64),
        "feat_count": np.array([len(f.features) for f in feats], np.int64),
        "features": np.concatenate([f.features for f in feats]).astype(np.int64),
        "z_rel": np.concatenate([f.z_rel for f in feats]),
        "center_dep": np.array([f.center_dep for f in feats], np.float64),
        "shape": np.array([f.shape for f in feats], np.int64),
        "resp_sum": np.array([f.responses.astype(np.int64).sum() for f in feats], np.int64),
        "zavg_sum": np.array([f.z_avg.astype(np.float64).sum() for f in feats], np.float64),
        "responses_head": np.stack([f.responses for f in feats[:FULL_PATCHES]]),
        "zavg_head": np.stack([f.z_avg for f in feats[:FULL_PATCHES]]),
        "rpy": rpys.astype(np.float32), "t": ts.astype(np.float32),
    }
    pset = PatchSet.from_features(feats)
    S = similarity_matrix_device(feats, pset, cfg.z_check)
    out["sim_row_sum"] = S.astype(np.float64).sum(1)
    out["sim_head"] = S[:FULL_ROWS]

    m_host = train_forest(feats, rpys, ts, cfg, device=False, **FOREST)
    m_jit = train_forest(feats, rpys, ts, cfg, device=True, **FOREST)
    forest_arrays("host_tree", m_host.forest, out)
    forest_arrays("jit_tree", m_jit.forest, out)

    depth_offset = float(RADIUS - np.mean([p.center_dep for p in m_host.patches]))
    for vi in range(EVAL_VIEWS):
        view_record(m_host, mesh, views[vi], cfg, depth_offset, vi, out)
    res = evaluate_pose_recall(m_host, mesh, K, IM_SIZE, views[:EVAL_VIEWS], train_radius=RADIUS, cfg=cfg,
                               stride=ROI_STRIDE, top_k=TOP_K, device=False)
    errs = [r.get("err_mm") for r in res["records"]]
    assert errs == [float(out[f"v{vi}_err"]) for vi in range(EVAL_VIEWS)], (errs, res)
    out["recall"] = np.float64(res["recall"])
    for name, modes in (("raw", False), ("modes", True)):
        rec = evaluate_recall(m_host, mesh, K, IM_SIZE, views[:RECALL_VIEWS], train_radius=RADIUS, cfg=cfg,
                              stride=ROI_STRIDE, top_k=TOP_K, tol_px=30.0, leaf_modes=modes, device=False)
        out[f"vote_recall_{name}"] = np.array([rec["recall"], rec["top1_recall"]], np.float64)
        out[f"vote_top1_err_{name}"] = np.array([r["top1_center_err_px"] for r in rec["records"]], np.float64)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): {len(feats)} patches, recall {res['recall']}, "
          f"trees {[len(t.nodes) for t in m_host.forest.trees]} / {[len(t.nodes) for t in m_jit.forest.trees]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
