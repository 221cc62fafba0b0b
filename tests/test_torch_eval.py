"""Port parity of the eval package (misc, pose_error, score, loc) against the
JAX package, on the CPU.

Tolerances:
- ``add``, ``adi``: 1e-5 relative (float32 sums in another order); ``re``
  and ``te`` are numpy copies: equal;
- ``vsd`` with the step cost and ``cou``: equal (pixel counts of renders
  that equal JAX's); ``vsd`` with the linear cost: 1e-6 absolute;
- ``depth_im_to_dist_im``: equal (XLA's contracted sum of squares is
  reproduced);
- ``misc``'s numpy helpers, ``score`` and ``loc``: equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.benchmark import make_models
from sixdpose_tpu.eval import loc as JL
from sixdpose_tpu.eval import misc as JM
from sixdpose_tpu.eval import pose_error as JE
from sixdpose_tpu.eval import score as JS
from sixdpose_tpu.geometry.render import render as jax_render
from sixdpose_tpu.geometry.transform import random_rotation
from sixdpose_tpu_torch.eval import loc as TL
from sixdpose_tpu_torch.eval import misc as TM
from sixdpose_tpu_torch.eval import pose_error as TE
from sixdpose_tpu_torch.eval import score as TS

K = np.array([[84.0, 0, 48], [0, 84.0, 36], [0, 0, 1]])
IM = (96, 72)
MODELS = make_models()


def _pose_pairs(seed: int, n: int = 3):
    """(R_est, t_est, R_gt, t_gt): a close estimate, a flipped one, a far one."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        R = random_rotation(rng)
        t = np.array([rng.uniform(-10, 10), rng.uniform(-8, 8), rng.uniform(400, 480)]).reshape(3, 1)
        R_e = R if k == 0 else (R @ np.diag([-1.0, -1.0, 1.0]) if k == 1 else random_rotation(rng))
        out.append((R_e, t + rng.normal(0, 4, (3, 1)), R, t))
    return out


def test_dist_image_and_misc_match_jax():
    rng = np.random.default_rng(0)
    d = rng.integers(0, 900, (72, 96)).astype(np.float32)
    want = np.asarray(JM.depth_im_to_dist_im(jnp.asarray(d), jnp.asarray(K.astype(np.float32))))
    got = TM.depth_im_to_dist_im(torch.from_numpy(d), torch.from_numpy(K.astype(np.float32))).numpy()
    np.testing.assert_array_equal(got, want)
    pts = MODELS["cup"]["pts"]
    assert TM.model_diameter(pts) == JM.model_diameter(pts)
    R, t = random_rotation(rng), np.array([1.0, 2.0, 400.0])
    np.testing.assert_array_equal(TM.project_pts(pts, K, R, t), JM.project_pts(pts, K, R, t))
    assert TM.calc_pose_2d_bbox(MODELS["cup"], IM, K, R, t) == JM.calc_pose_2d_bbox(MODELS["cup"], IM, K, R, t)
    for a, b in zip(TM.rgbd_to_point_cloud(K, d), JM.rgbd_to_point_cloud(K, d)):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TM.norm_depth(d), JM.norm_depth(d))
    np.testing.assert_array_equal(TM.crop_im(d, [5, 6, 20, 10]), JM.crop_im(d, [5, 6, 20, 10]))


@pytest.mark.parametrize("cid", ["box", "cup", "star"])
def test_point_metrics_match_jax(cid):
    m = MODELS[cid]
    for R_e, t_e, R_g, t_g in _pose_pairs(len(cid)):
        assert TE.add(R_e, t_e, R_g, t_g, m, device="cpu") == pytest.approx(JE.add(R_e, t_e, R_g, t_g, m), rel=1e-5)
        for max_pts in (None, 20):
            want = JE.adi(R_e, t_e, R_g, t_g, m, max_pts=max_pts)
            got = TE.adi(R_e, t_e, R_g, t_g, m, max_pts=max_pts, device="cpu")
            assert got == pytest.approx(want, rel=1e-5)
        assert TE.re(R_e, R_g) == JE.re(R_e, R_g)
        assert TE.te(t_e, t_g) == JE.te(t_e, t_g)


def test_adi_chunks_add_up():
    """The chunked nearest neighbour is chunk-size independent."""
    m = {"pts": np.random.default_rng(2).normal(0, 20, (2500, 3))}
    R_e, t_e, R_g, t_g = _pose_pairs(9, 2)[1]
    a = TE.adi(R_e, t_e, R_g, t_g, m, device="cpu", chunk=1024)
    b = TE.adi(R_e, t_e, R_g, t_g, m, device="cpu", chunk=333)
    assert a == pytest.approx(b, rel=1e-6)


@pytest.mark.parametrize("cid", ["lbracket", "texbox"])
def test_render_metrics_match_jax(cid):
    m = MODELS[cid]
    for R_e, t_e, R_g, t_g in _pose_pairs(3 + len(cid)):
        depth = np.asarray(jax_render(dict(m), IM, K, R_g, t_g)).astype(np.uint16)
        assert TE.vsd(R_e, t_e, R_g, t_g, dict(m), depth, K, 15.0, 20.0, "step", device="cpu") == JE.vsd(
            R_e, t_e, R_g, t_g, dict(m), depth, K, 15.0, 20.0, "step"
        )
        assert TE.vsd(R_e, t_e, R_g, t_g, dict(m), depth, K, 15.0, 20.0, device="cpu") == pytest.approx(
            JE.vsd(R_e, t_e, R_g, t_g, dict(m), depth, K, 15.0, 20.0), abs=1e-6
        )
        assert TE.cou(R_e, t_e, R_g, t_g, dict(m), IM, K, device="cpu") == JE.cou(R_e, t_e, R_g, t_g, dict(m), IM, K)


def test_vsd_without_visible_surface_is_one():
    m = MODELS["box"]
    R = np.eye(3)
    far = np.array([0.0, 0.0, 20000.0])  # beyond clip_far: nothing renders
    assert TE.vsd(R, far, R, far, m, np.zeros((72, 96), np.uint16), K, 15.0, 20.0, device="cpu") == 1.0
    assert TE.cou(R, far, R, far, m, IM, K, device="cpu") == 1.0


def test_score_matches_jax():
    rng = np.random.default_rng(4)
    rec, pre = rng.uniform(size=12), rng.uniform(size=12)
    assert TS.ap(rec, pre) == JS.ap(rec, pre)
    errs = [{"est_id": i, "score": float(rng.uniform()), "errors": {g: float(rng.uniform()) for g in range(4)}}
            for i in range(6)]
    for thresh, n_top, mask in ((0.5, -1, None), (0.3, 2, [True, False, True, True])):
        assert TS.match_poses(errs, thresh, n_top, mask) == JS.match_poses(errs, thresh, n_top, mask)


def test_loc_matches_jax():
    """calc_errors over every error type, then match_scene, calc_scores and
    the Hinterstoisser split."""
    m = MODELS["cup"]
    pairs = _pose_pairs(21)
    gts = [{"obj_id": 3, "cam_R_m2c": R_g, "cam_t_m2c": t_g} for _, _, R_g, t_g in pairs[:2]]
    ests = [{"score": float(s), "R": R_e, "t": t_e} for s, (R_e, t_e, _, _) in zip((0.9, 0.4, 0.7), pairs)]
    depth = np.asarray(jax_render(dict(m), IM, K, pairs[0][2], pairs[0][3])).astype(np.uint16)
    errs = {}
    for et in ("vsd", "add", "adi", "cou", "re", "te"):
        got = TL.calc_errors(ests, gts, dict(m), depth, K, error_type=et, n_top=2, device="cpu")
        want = JL.calc_errors(ests, gts, dict(m), depth, K, error_type=et, n_top=2)
        assert [(g["est_id"], g["score"]) for g in got] == [(w["est_id"], w["score"]) for w in want]
        for g, w in zip(got, want):
            for gt_id in w["errors"]:
                assert g["errors"][gt_id] == pytest.approx(w["errors"][gt_id], rel=1e-5, abs=1e-6), et
        errs[et] = want
    scene_gts = {0: gts, 1: gts[:1]}
    visib = {0: [0.9, 0.05], 1: [0.5]}
    one_gt = [dict(e, errors={0: e["errors"][0]}) for e in errs["adi"][:1]]
    by_im = {0: {3: errs["adi"]}, 1: {3: one_gt}}
    mt = TL.match_scene(scene_gts, visib, by_im, 2, {3: 15.0}, n_top=2)
    mj = JL.match_scene(scene_gts, visib, by_im, 2, {3: 15.0}, n_top=2)
    assert mt == mj
    assert TL.calc_scores([2], [3], mt, n_top=2) == JL.calc_scores([2], [3], mj, n_top=2)
    assert TL.split_hinterstoisser(mt) == JL.split_hinterstoisser(mj)
