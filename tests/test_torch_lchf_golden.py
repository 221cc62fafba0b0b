"""The port's LCHF path on the CPU against the JAX golden.

``sixdpose_tpu_torch/testdata/lchf_golden.npz`` is JAX's run of the
configuration of tests/test_lchf.py::test_lchf_6d_pose_recall (160 x 120,
the box, 120 training poses, 1648 patches, 2 trees), written by
``tools/torch_port_lchf_golden.py``.  Features, similarities, forests,
leaves, votes and decoded hypotheses must equal JAX's.  The top bins are numpy's default argsort of the
votes, whose order among equal sums depends on numpy's sort kernel: they
must hold the golden's scores, and every bin its score; the golden's own
bins are then decoded and refined.  The refine stage is compared at two ICP
iterations (see ``STEP_ITERS``), the pipeline's result at the full 20.
"""

import os

import numpy as np
import pytest
import torch

from sixdpose_tpu_torch.benchmark import make_models
from sixdpose_tpu_torch.config import IcpConfig
from sixdpose_tpu_torch.geometry.render import render
from sixdpose_tpu_torch.geometry.view_sampler import sample_views
from sixdpose_tpu_torch.lchf import (
    LchfConfig,
    PatchSet,
    decode_bin_poses,
    evaluate_pose_recall,
    evaluate_recall,
    make_training_patches,
    refine_lchf_poses,
    train_forest,
)
from sixdpose_tpu_torch.lchf.device import similarity_matrix_device
from sixdpose_tpu_torch.lchf.pose import lchf_vote_bins

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata",
                      "lchf_golden.npz")
IM_SIZE = (160, 120)
K = np.array([[200.0, 0, 80.0], [0, 200.0, 60.0], [0, 0, 1]])
RADIUS = 420.0
CFG = LchfConfig(num_features=6, extract_threshold=1, strong_threshold=30.0)
FOREST = dict(num_trees=2, size_thresh=2, seed=1)
ROI_STRIDE, TOP_K, ICP_SEEDS = 8, 5, 5
# The refine stage is held to JAX's at two ICP iterations: the packages'
# float32 ICP differ in the last bits (the fixed-order sums and the 6 x 6
# solve are not XLA's), and 20 iterations from the far LCHF hypotheses
# amplify that on some of them (in this golden 4 of 15 end 0.02-1.3 apart
# in R); the pipeline's own outputs (the best hypothesis per view, the
# recall) are compared at the full 20.
STEP_ITERS = 2
# As chip_smoke.py's FUSED_TOL: R per entry, t in mm, fitness and verify
# within 2 of their 512 cloud and verify points.
TOL_R, TOL_T_MM, TOL_POINTS = 1e-4, 0.1, 2.0 / 512


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def mesh():
    return make_models()["box"]


@pytest.fixture(scope="module")
def views():
    return sample_views(8, radius=RADIUS)[0]


@pytest.fixture(scope="module")
def training(mesh, views):
    feats, rpys, ts, per_view = [], [], [], []
    for v in views:
        rgb, depth = render(mesh, IM_SIZE, K, v["R"], v["t"], mode="rgb+depth", device="cpu")
        rgb, depth = rgb.numpy(), depth.numpy().astype(np.uint16)
        p, r, t = make_training_patches(rgb, depth, (depth > 0).astype(np.uint8) * 255, v["R"], CFG, 40, 12,
                                        device="cpu")
        per_view.append(len(p))
        feats.extend(p)
        rpys.extend(r)
        ts.extend(t)
    return feats, np.array(rpys), np.array(ts), per_view


@pytest.fixture(scope="module")
def forests(training):
    feats, rpys, ts, _ = training
    return {route: train_forest(feats, rpys, ts, CFG, on_device=route == "jit", device="cpu", **FOREST)
            for route in ("host", "jit")}


def test_golden_patches(golden, training):
    feats, rpys, ts, per_view = training
    np.testing.assert_array_equal(per_view, golden["patches_per_view"])
    np.testing.assert_array_equal([len(f.features) for f in feats], golden["feat_count"])
    np.testing.assert_array_equal(np.concatenate([f.features for f in feats]), golden["features"])
    np.testing.assert_array_equal(np.concatenate([f.z_rel for f in feats]), golden["z_rel"])
    np.testing.assert_array_equal([f.center_dep for f in feats], golden["center_dep"])
    np.testing.assert_array_equal([f.shape for f in feats], golden["shape"])
    np.testing.assert_array_equal([f.responses.astype(np.int64).sum() for f in feats], golden["resp_sum"])
    np.testing.assert_array_equal([f.z_avg.astype(np.float64).sum() for f in feats], golden["zavg_sum"])
    n = len(golden["responses_head"])
    np.testing.assert_array_equal(np.stack([f.responses for f in feats[:n]]), golden["responses_head"])
    np.testing.assert_array_equal(np.stack([f.z_avg for f in feats[:n]]), golden["zavg_head"])
    np.testing.assert_array_equal(rpys.astype(np.float32), golden["rpy"])
    np.testing.assert_array_equal(ts.astype(np.float32), golden["t"])


def test_golden_similarity_matrix(golden, training):
    """The device route's float32 matrix equals the jit route's."""
    feats = training[0]
    S = similarity_matrix_device(feats, PatchSet.from_features(feats), CFG.z_check, "cpu")
    np.testing.assert_array_equal(S.astype(np.float64).sum(1), golden["sim_row_sum"])
    np.testing.assert_array_equal(S[: len(golden["sim_head"])], golden["sim_head"])


@pytest.mark.parametrize("route", ["host", "jit"])
def test_golden_forest(golden, forests, route):
    for ti, t in enumerate(forests[route].forest.trees):
        nodes = np.array([[int(nd.issplit), nd.pnode, nd.depth, nd.cnodes[0], nd.cnodes[1], int(nd.isleafnode),
                           nd.split_feat_idx] for nd in t.nodes], np.int64)
        np.testing.assert_array_equal(nodes, golden[f"{route}_tree{ti}_nodes"])
        np.testing.assert_array_equal(np.array([nd.simi_thresh for nd in t.nodes], np.float32),
                                      golden[f"{route}_tree{ti}_thresh"])
        np.testing.assert_array_equal(np.concatenate([t.nodes[i].ind_feats for i in t.id_leafnodes]),
                                      golden[f"{route}_tree{ti}_leaf_ids"])


def within_tolerance(got, want):
    """Refined (R, t mm, fitness, verify) within the fused frame's
    tolerances of JAX's."""
    for a, b, tol in zip(got, want, (TOL_R, TOL_T_MM, TOL_POINTS, TOL_POINTS)):
        assert a.shape == b.shape and np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


def check_top_bins(bins, votes, g_bins, g_scores, top_k):
    """``bins`` are a valid top-``top_k`` of ``votes`` with the golden's
    scores: the same score sequence, each bin holding its score, and the
    bins of every score the golden's, except in the last score group, which
    the cut may split."""
    scores = votes[tuple(np.asarray(bins).T)]
    np.testing.assert_array_equal(scores, g_scores)
    assert len({tuple(b) for b in bins}) == len(bins)
    last = g_scores[-1] if len(g_scores) == top_k else None
    for s in np.unique(g_scores):
        if s != last:
            assert {tuple(b) for b, x in zip(bins, scores) if x == s} == {tuple(b) for b, x in zip(g_bins, g_scores)
                                                                          if x == s}


@pytest.mark.parametrize("vi", [0, 1, 2])
def test_golden_view(golden, forests, mesh, views, vi):
    """One view of evaluate_pose_recall: renders, ROIs, both routes' leaves,
    the vote tensor and top bins exactly; the golden's bins decoded exactly,
    refined within the tolerances at ``STEP_ITERS`` ICP iterations, and the
    same best hypothesis at the full 20."""
    g = {k[len(f"v{vi}_"):]: v for k, v in golden.items() if k.startswith(f"v{vi}_")}
    model = forests["host"]
    view = views[vi]
    rgb, depth = render(mesh, IM_SIZE, K, view["R"], view["t"], mode="rgb+depth", device="cpu")
    rgb, depth = rgb.numpy(), depth.numpy().astype(np.uint16)
    np.testing.assert_array_equal(rgb, g["rgb"])
    np.testing.assert_array_equal(depth, g["depth"])
    kw = dict(stride=ROI_STRIDE, top_k=TOP_K, device="cpu")
    front = lchf_vote_bins(model, rgb, depth, RADIUS, CFG, **kw)
    front_jit = lchf_vote_bins(model, rgb, depth, RADIUS, CFG, on_device=True, **kw)
    np.testing.assert_array_equal(front["rois"], g["rois"])
    np.testing.assert_array_equal(front["leaves"], g["leaves"])
    np.testing.assert_array_equal(front_jit["leaves"], g["leaves_jit"])
    flat = front["votes"].reshape(-1)
    np.testing.assert_array_equal(np.nonzero(flat)[0], g["votes_idx"])
    np.testing.assert_array_equal(flat[g["votes_idx"]], g["votes_val"])
    check_top_bins(front["bins"], front["votes"], g["bins"], g["scores"], TOP_K)

    depth_offset = float(RADIUS - np.mean([p.center_dep for p in model.patches]))
    hyps = decode_bin_poses(g["bins"], *front["vote_arrays"], K, RADIUS, depth_offset=depth_offset)
    for key, name in (("R", "hyp_R"), ("t", "hyp_t"), ("weight", "hyp_weight"), ("center_px", "hyp_center")):
        np.testing.assert_array_equal(np.array([h[key] for h in hyps]), g[name])
    step = refine_lchf_poses(hyps, mesh, depth, K, IcpConfig(max_iters=STEP_ITERS), icp_seeds=ICP_SEEDS,
                             device="cpu")
    within_tolerance(step, [g[f"step_{k}"] for k in ("R", "t", "fitness", "verify")])
    R, t, fits, vscore = refine_lchf_poses(hyps, mesh, depth, K, None, icp_seeds=ICP_SEEDS, device="cpu")
    assert int(np.argmax(vscore * 100.0 + np.maximum(fits, 0.0))) == int(g["best"])


def test_golden_recall(golden, forests, mesh, views):
    """evaluate_pose_recall (host route, as the JAX test) and
    evaluate_recall (raw samples and leaf modes) give JAX's recall."""
    model = forests["host"]
    res = evaluate_pose_recall(model, mesh, K, IM_SIZE, views[:3], train_radius=RADIUS, cfg=CFG, stride=ROI_STRIDE,
                               top_k=TOP_K, device="cpu")
    assert res["n_views"] == 3 and res["recall"] == float(golden["recall"])
    for name, modes in (("raw", False), ("modes", True)):
        rec = evaluate_recall(model, mesh, K, IM_SIZE, views[:2], train_radius=RADIUS, cfg=CFG, stride=ROI_STRIDE,
                              top_k=TOP_K, tol_px=30.0, leaf_modes=modes, on_device=False, device="cpu")
        np.testing.assert_array_equal([rec["recall"], rec["top1_recall"]], golden[f"vote_recall_{name}"])
        np.testing.assert_array_equal([r["top1_center_err_px"] for r in rec["records"]],
                                      golden[f"vote_top1_err_{name}"])
