"""Port parity of models/refine.py (scene maps, batched ICP, verification)
against the JAX package, on the CPU at 128x96.

Tolerances, each with its reason:
- ``backproject``, ``_shift2d``, ``scene_chroma`` and
  ``sample_model_points``: the same float32 (or numpy) operations in the
  same order, so exact;
- ``scene_normals``: 1e-6 absolute (measured 1.2e-7: the normalization
  may round differently by an ulp);
- ``_so3_exp``: 1e-6 (sin/cos differ by ulps between XLA and PyTorch);
- ICP on a scene where it converges (a dome and a block on a plane), from
  offsets of up to 4 mm:
  R 1e-4 per entry, t 0.1 mm, fitness and rmse 2 / N and 1e-6 m (N cloud
  points: two inliers may flip at the gate).  Measured maxima: R 6.2e-8,
  t 9.2e-5 mm, fitness equal, with and without chroma;
- verification: 2 / P (P points: two points may flip at a test), measured
  equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from test_torch_detector import _frame

from sixdpose_tpu.config import IcpConfig as JIcp
from sixdpose_tpu.models import refine as JR
from sixdpose_tpu_torch.config import IcpConfig
from sixdpose_tpu_torch.models import refine as TR

KC = np.array([[500.0, 0, 63.5], [0, 502.0, 47.5], [0, 0, 1]], np.float32)
K_ICP = np.array([[300.0, 0, 63.5], [0, 302.0, 47.5], [0, 0, 1]], np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dome(seed=3, variant=1, x=40, y=24):
    """A textured dome on a noisy plane (128x96) and its mask."""
    rgb, depth, mask = _frame(variant, x, y, seed=seed)
    return rgb, depth, mask


def _maps(rgb, depth, K=KC):
    jp = JR.backproject(jnp.asarray(depth), jnp.asarray(K))
    tp = TR.backproject(_t(depth.astype(np.int32)), _t(K))
    return (jp, JR.scene_normals(jp), JR.scene_chroma(jnp.asarray(rgb))), (tp, TR.scene_normals(tp), TR.scene_chroma(_t(rgb)))


@pytest.mark.parametrize("seed", [None, 3])
def test_backproject_matches_jax(seed):
    _, depth, _ = _dome(seed=seed)
    depth[5:9, 7:30] = 0  # holes
    want = np.asarray(JR.backproject(jnp.asarray(depth), jnp.asarray(KC)))
    got = TR.backproject(_t(depth.astype(np.int32)), _t(KC)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dy,dx", [(0, 0), (2, -1), (-3, 5), (1, 0), (0, -2)])
def test_shift2d_matches_jax(dy, dx):
    a = np.random.default_rng(0).standard_normal((7, 9, 2)).astype(np.float32)
    np.testing.assert_array_equal(TR._shift2d(_t(a), dy, dx).numpy(), np.asarray(JR._shift2d(jnp.asarray(a), dy, dx)))


@pytest.mark.parametrize("seed", [None, 3, 8])
def test_scene_normals_matches_jax(seed):
    rgb, depth, _ = _dome(seed=seed)
    depth[40:44, 60:90] = 0  # a hole inside and beside the object
    (jp, jn, _), (tp, tn, _) = _maps(rgb, depth)
    jn, tn = np.asarray(jn), tn.numpy()
    np.testing.assert_array_equal(tn != 0, jn != 0)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-6)
    assert (np.abs(jn).sum(-1) > 0).sum() > 1000


@pytest.mark.parametrize("seed,blur", [(None, 2), (3, 2), (8, 0), (8, 1)])
def test_scene_chroma_matches_jax(seed, blur):
    rgb, _, _ = _dome(seed=seed)
    want = JR.scene_chroma(jnp.asarray(rgb), blur)
    got = TR.scene_chroma(_t(rgb), blur)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_so3_exp_matches_jax():
    w = np.random.default_rng(1).uniform(-0.5, 0.5, (6, 3)).astype(np.float32)
    w[0] = 0.0
    want = np.stack([np.asarray(JR._so3_exp(jnp.asarray(v))) for v in w])
    np.testing.assert_allclose(TR._so3_exp(_t(w)).numpy(), want, rtol=0, atol=1e-6)


def test_solve_spd_solves():
    """The Gauss-Jordan solve against float64 numpy on damped normal
    equations of the ICP's scale."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((5, 40, 6)).astype(np.float32) * [0.01, 0.01, 0.01, 1, 1, 1]
    H = np.einsum("kni,knj->kij", a, a) + 1e-9 * np.eye(6)
    g = rng.standard_normal((5, 6))
    want = np.linalg.solve(H.astype(np.float64), g[..., None])[..., 0]
    got = TR._solve_spd(_t(H.astype(np.float32)), _t(g.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6)


def test_sample_model_points_matches_jax():
    _, depth, mask = _dome()
    obj = np.where(mask > 0, depth, 0).astype(np.uint16)
    for n, pix in ((300, True), (4000, False)):
        want = JR.sample_model_points(obj, KC, n, return_pixels=pix)
        got = TR.sample_model_points(obj, KC, n, return_pixels=pix)
        for w, g in zip(want[:2], got[:2]):
            np.testing.assert_array_equal(g, w)
    empty = TR.sample_model_points(np.zeros_like(obj), KC, 16)
    assert not empty[1].any()


def _icp_case(n=400, k=6):
    """The dome with a block beside it on the plane (so that no rotation is
    a symmetry of the scene), the camera at f = 300 px, and K copies of
    the cloud of a crop around both, offset by up to 4 mm."""
    rgb, depth, _ = _dome()
    depth[60:84, 92:118] = 820
    rgb[60:84, 92:118] = (200, 60, 60)
    crop = np.zeros_like(depth)
    crop[16:90, 30:124] = depth[16:90, 30:124]
    pts, val, (ys, xs) = JR.sample_model_points(crop, K_ICP, n, return_pixels=True)
    cols = rgb[ys, xs].astype(np.float32)
    chroma = np.zeros((n, 2), np.float32)
    chroma[: len(cols)] = cols[:, :2] / np.maximum(cols.sum(-1, keepdims=True), 1e-6)
    init = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    init[:, :3, 3] = np.random.default_rng(0).uniform(-0.004, 0.004, (k, 3))
    stack = lambda a: np.ascontiguousarray(np.broadcast_to(a, (k,) + a.shape))  # noqa: E731
    return rgb, depth, stack(pts), stack(val), stack(chroma), init


@pytest.mark.parametrize("use_chroma", [False, True])
def test_icp_batch_matches_jax(use_chroma):
    rgb, depth, pts, val, chroma, init = _icp_case()
    val[1, 300:] = False  # a shorter cloud
    (jp, jn, jc), (tp, tn, tc) = _maps(rgb, depth, K_ICP)
    kw = dict(corr_dist=0.01, max_iters=16, coarse_gate_mult=3.0, color_weight=0.1, bilinear_iters=6, coarse_points=64)
    want = JR.icp_batch(
        jnp.asarray(pts), jnp.asarray(val), jp, jn, jnp.asarray(K_ICP), jnp.asarray(init),
        model_chroma=jnp.asarray(chroma) if use_chroma else None, chroma_maps=jc if use_chroma else None, **kw,
    )
    got = TR.icp_batch(
        _t(pts), _t(val), tp, tn, _t(K_ICP), _t(init),
        model_chroma=_t(chroma) if use_chroma else None, chroma_maps=tc if use_chroma else None, **kw,
    )
    (jT, jfit, jrmse), (tT, tfit, trmse) = [np.asarray(a) for a in want], [a.numpy() for a in got]
    n = pts.shape[1]
    np.testing.assert_allclose(tT[:, :3, :3], jT[:, :3, :3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tT[:, :3, 3], jT[:, :3, 3], rtol=0, atol=1e-4)  # 0.1 mm
    np.testing.assert_allclose(tfit, jfit, rtol=0, atol=2.0 / n + 1e-7)
    np.testing.assert_allclose(trmse, jrmse, rtol=0, atol=1e-6)
    # ICP converges here: every candidate ends within 3 mm and 0.01 of its
    # own pose, from offsets of up to 4 mm.
    assert (tfit > 0.9).all(), tfit
    assert (np.abs(tT[:, :3, 3]) < 0.003).all(), tT[:, :3, 3]
    assert (np.abs(tT[:, :3, :3] - np.eye(3)) < 0.01).all()


def test_icp_point_to_plane_is_one_candidate_of_the_batch():
    rgb, depth, pts, val, _, init = _icp_case(k=2)
    _, (tp, tn, _) = _maps(rgb, depth, K_ICP)
    batch = TR.icp_batch(_t(pts), _t(val), tp, tn, _t(K_ICP), _t(init), max_iters=8)
    one = TR.icp_point_to_plane(_t(pts[1]), _t(val[1]), tp, tn, _t(K_ICP), _t(init[1]), max_iters=8)
    for b, o in zip(batch, one):
        assert torch.equal(b[1], o)


def _verify_case():
    rgb, depth, mask = _dome()
    obj = np.where(mask > 0, depth, 0)
    pts, val, (ys, xs) = JR.sample_model_points(obj, KC, 500, return_pixels=True)
    pts_mm = pts[val] * 1000.0
    cols = rgb[ys, xs].astype(np.float32)
    rng = np.random.default_rng(4)
    Rs = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
    ts = np.zeros((5, 3), np.float32)
    ts[1] = (6.0, -4.0, 3.0)      # a few mm off
    ts[2] = (0.0, 0.0, 200.0)     # behind the surface: occluded
    ts[3] = (0.0, 0.0, -60.0)     # in front of it
    c = pts_mm.mean(0)
    th = 0.4
    Rs[4] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    ts[4] = c - Rs[4] @ c + rng.uniform(-2, 2, 3)
    return rgb, depth, pts_mm.astype(np.float32), cols, Rs, ts


@pytest.mark.parametrize("colors,zscore", [(False, False), (True, False), (True, True)])
def test_verify_poses_matches_jax(colors, zscore):
    rgb, depth, pts, cols, Rs, ts = _verify_case()
    kw = dict(tau_mm=15.0, color_zscore=zscore)
    want = np.asarray(JR.verify_poses(
        jnp.asarray(pts), jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(depth), jnp.asarray(KC),
        model_colors=jnp.asarray(cols) if colors else None, rgb=jnp.asarray(rgb) if colors else None, **kw,
    ))
    got = TR.verify_poses(
        _t(pts), _t(Rs), _t(ts), _t(depth.astype(np.int32)), _t(KC),
        model_colors=_t(cols) if colors else None, rgb=_t(rgb) if colors else None, **kw,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 / len(pts))
    assert want[0] > 0.9 and want[2] == 0.0, want


@pytest.mark.parametrize("colors,zscore", [(False, False), (True, False), (True, True)])
def test_verify_poses_multi_matches_jax(colors, zscore):
    """Different padded point sets per candidate."""
    rgb, depth, pts, cols, Rs, ts = _verify_case()
    n = len(pts)
    rng = np.random.default_rng(5)
    pts_k = np.zeros((5, n + 40, 3), np.float32)
    val_k = np.zeros((5, n + 40), bool)
    cols_k = np.zeros((5, n + 40, 3), np.float32)
    for i in range(5):
        m = rng.integers(n // 2, n + 1)
        pick = rng.permutation(n)[:m]
        pts_k[i, :m], cols_k[i, :m], val_k[i, :m] = pts[pick], cols[pick], True
        pts_k[i, m:] = rng.uniform(-50, 50, (n + 40 - m, 3))  # pad rows must not count
    kw = dict(tau_mm=12.0, cell=3, color_zscore=zscore)
    want = np.asarray(JR.verify_poses_multi(
        jnp.asarray(pts_k), jnp.asarray(val_k), jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(depth), jnp.asarray(KC),
        model_colors=jnp.asarray(cols_k) if colors else None, rgb=jnp.asarray(rgb) if colors else None, **kw,
    ))
    got = TR.verify_poses_multi(
        _t(pts_k), _t(val_k), _t(Rs), _t(ts), _t(depth.astype(np.int32)), _t(KC),
        model_colors=_t(cols_k) if colors else None, rgb=_t(rgb) if colors else None, **kw,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 / n)


def _refiner_case():
    """The dome rendered alone at (40, 24), and a scene with it at (46, 27)."""
    _, model_depth, model_mask = _dome(seed=None)
    model_depth = np.where(model_mask > 0, model_depth, 0).astype(np.uint16)
    _, scene_depth, scene_mask = _dome(seed=2, x=46, y=27)
    ys, xs = np.nonzero(scene_mask)
    return model_depth, scene_depth, int(xs.min()), int(ys.min())


def test_pose_refiner_matches_jax():
    model_depth, scene_depth, dx, dy = _refiner_case()
    R0 = np.eye(3)
    t0 = np.array([[0.0], [0.0], [850.0]])
    jref = JR.PoseRefiner(JIcp(max_iters=12, num_model_points=400))
    tref = TR.PoseRefiner(IcpConfig(max_iters=12, num_model_points=400), device="cpu")
    for ref in (jref, tref):
        ref.process(scene_depth, model_depth, KC, KC, R0, t0, dx, dy)
    assert jref.getResidual() > 0.8
    assert abs(tref.getResidual() - jref.getResidual()) <= 2.0 / 400 + 1e-7
    np.testing.assert_allclose(tref.getR(), jref.getR(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tref.getT(), jref.getT(), rtol=0, atol=0.1)
    # A detection whose crop leaves the frame gives the reference's -1.
    tref.process(scene_depth, model_depth, KC, KC, R0, t0, 120, dy)
    assert tref.getResidual() == -1.0


def test_refine_poses_matches_jax():
    model_depth, scene_depth, _, _ = _refiner_case()
    init = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    # The scene dome sits 6 px right and 3 px down of the model's.
    init[:, :3, 3] = [[0.0095, 0.0048, 0.0], [0.011, 0.004, 0.002], [0.008, 0.006, -0.002]]
    cfg = (JIcp(max_iters=10, num_model_points=300), IcpConfig(max_iters=10, num_model_points=300))
    models = np.stack([model_depth] * 3)
    want = [np.asarray(a) for a in JR.refine_poses(scene_depth, KC, models, KC, init, cfg[0])]
    got = [a.numpy() for a in TR.refine_poses(scene_depth, KC, models, KC, init, cfg[1], device="cpu")]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2.0 / 300 + 1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    assert (want[1] > 0.8).all(), want[1]
