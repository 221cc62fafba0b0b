"""Port parity: lchf/ (torch) against the JAX package's lchf/.

The same seeded numpy inputs go through both packages, at the small shapes
of tests/test_lchf.py.  Features, responses, mean depths, similarities
(each route against the same route: numpy float64 against numpy, the
device route's float32 against the XLA jit route), forests, leaves, votes,
bins and decoded hypotheses are compared exactly; refined poses are held
to JAX's in tests/test_torch_lchf_golden.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import sixdpose_tpu.lchf as J  # noqa: E402
import sixdpose_tpu_torch.lchf as T  # noqa: E402
from sixdpose_tpu.lchf import device as JD  # noqa: E402
from sixdpose_tpu.lchf import feature as JF  # noqa: E402
from sixdpose_tpu_torch.convert import lchf_tables_from_model  # noqa: E402
from sixdpose_tpu_torch.lchf import device as TD  # noqa: E402
from sixdpose_tpu_torch.lchf import feature as TF  # noqa: E402
from sixdpose_tpu_torch.lchf import voting as TV  # noqa: E402

SMALL = dict(num_features=6, extract_threshold=1, strong_threshold=30.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: these small tensors gain nothing from more, and
    the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _object():
    """The disc object of tests/test_lchf.py, its training frame and a scene
    with it shifted."""
    obj = np.zeros((60, 60, 3), np.uint8)
    yy, xx = np.mgrid[0:60, 0:60]
    m = ((yy - 30) ** 2 + (xx - 30) ** 2) < 625
    obj[m] = (180, 90, 40)
    obj[m & (xx > 30)] = (40, 160, 220)
    obj[m & (yy > 30) & (xx <= 30)] = (90, 220, 90)
    obj_depth = np.where(m, 500 + (xx - 30) * 2, 0).astype(np.uint16)
    frame = {}
    for name, (y0, x0) in (("train", (30, 40)), ("scene", (50, 60))):
        rgb = np.zeros((120, 140, 3), np.uint8)
        rgb[y0 : y0 + 60, x0 : x0 + 60] = obj
        depth = np.zeros((120, 140), np.uint16)
        depth[y0 : y0 + 60, x0 : x0 + 60] = obj_depth
        mask = np.zeros((120, 140), np.uint8)
        mask[y0 : y0 + 60, x0 : x0 + 60] = m.astype(np.uint8) * 255
        frame[name] = (rgb, depth, mask)
    return frame


def _random_patches(pkg, seed, n, size=32, base=500, spread=40, **cfg_kw):
    rng = np.random.default_rng(seed)
    cfg = pkg.LchfConfig(**cfg_kw)
    kw = {} if pkg is J else {"device": "cpu"}
    out = []
    for _ in range(n):
        rgb = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        dep = (base + spread * rng.standard_normal((size, size))).astype(np.uint16)
        p = pkg.extract_patch_feature(rgb, dep, cfg=cfg, with_responses=True, **kw)
        if p is not None:
            out.append(p)
    return out


def _same_patch(a, b):
    np.testing.assert_array_equal(b.features, a.features)
    np.testing.assert_array_equal(b.z_rel, a.z_rel)
    assert b.center_dep == a.center_dep and tuple(b.shape) == tuple(a.shape)
    for k in ("responses", "z_avg"):
        if getattr(a, k) is None:
            assert getattr(b, k) is None
        else:
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))


def _same_forest(fa, fb):
    assert len(fa.trees) == len(fb.trees)
    for ta, tb in zip(fa.trees, fb.trees):
        assert ta.id_leafnodes == tb.id_leafnodes
        assert len(ta.nodes) == len(tb.nodes)
        for na, nb in zip(ta.nodes, tb.nodes):
            assert (na.issplit, na.pnode, na.depth, tuple(na.cnodes), na.isleafnode, na.split_feat_idx) == (
                nb.issplit, nb.pnode, nb.depth, tuple(nb.cnodes), nb.isleafnode, nb.split_feat_idx)
            assert np.float32(na.simi_thresh) == np.float32(nb.simi_thresh)
            np.testing.assert_array_equal(nb.ind_feats, na.ind_feats)


@pytest.fixture(scope="module")
def object_models():
    """Both packages' patches and forests (host route) of the disc object,
    with seeded random labels so the trees split."""
    frame = _object()
    rgb, depth, mask = frame["train"]
    jf, _, jt = J.make_training_patches(rgb, depth, mask, np.eye(3), J.LchfConfig(**SMALL), patch=40, stride=10)
    tf, _, tt = T.make_training_patches(rgb, depth, mask, np.eye(3), T.LchfConfig(**SMALL), patch=40, stride=10,
                                        device="cpu")
    rpy = np.random.default_rng(11).uniform(-3, 3, (len(jf), 3)).astype(np.float32)
    jm = J.train_forest(jf, rpy, np.array(jt), J.LchfConfig(**SMALL), num_trees=2, size_thresh=2, seed=3)
    tm = T.train_forest(tf, rpy, np.array(tt), T.LchfConfig(**SMALL), num_trees=2, size_thresh=2, seed=3)
    return frame, (jf, jm), (tf, tm)


def test_mean_depth_5x5(rng):
    depth = rng.integers(300, 1200, (37, 45)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.3] = 0
    np.testing.assert_array_equal(TF.mean_depth_5x5(depth, "cpu"), JF.mean_depth_5x5(depth))


@pytest.mark.parametrize("phase", ["exact", "cv"])
def test_construct_response(rng, phase):
    rgb = rng.integers(0, 256, (45, 50, 3)).astype(np.uint8)
    rgb[10:30, 12:40] = (200, 40, 90)
    depth = (600 + 20 * rng.standard_normal((45, 50))).astype(np.uint16)
    cfgj, cfgt = J.LchfConfig(phase=phase), T.LchfConfig(phase=phase)
    np.testing.assert_array_equal(T.construct_response(rgb, depth, cfgt, "cpu"), J.construct_response(rgb, depth, cfgj))


def test_extract_patch_feature_masked(object_models):
    frame, (jf, _), (tf, _) = object_models
    assert len(jf) >= 20 and len(tf) == len(jf)
    for a, b in zip(jf, tf):
        _same_patch(a, b)


def test_extract_patch_feature_unmasked():
    jp = _random_patches(J, 2, 8)
    tp = _random_patches(T, 2, 8)
    assert len(jp) >= 4 and len(tp) == len(jp)
    for a, b in zip(jp, tp):
        _same_patch(a, b)
    # without responses: no maps, no mean depth
    rgb, depth, _ = _object()["train"]
    a = J.extract_patch_feature(rgb[30:80, 40:90], depth[30:80, 40:90], None, J.LchfConfig(**SMALL))
    b = T.extract_patch_feature(rgb[30:80, 40:90], depth[30:80, 40:90], None, T.LchfConfig(**SMALL), device="cpu")
    _same_patch(a, b)


def test_similarity_numpy_route():
    """The host route is JAX's numpy: float64, equal to the bit."""
    jp, tp = _random_patches(J, 4, 10), _random_patches(T, 4, 10)
    js, ts = J.PatchSet.from_features(jp), T.PatchSet.from_features(tp)
    idx = np.arange(len(jp))
    for i in range(len(jp)):
        ref = J.similarity_one_to_many(jp[i], js, idx, 200.0)
        got = T.similarity_one_to_many(tp[i], ts, idx, 200.0)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_similarity_matrix_device_route(monkeypatch):
    """The device route's float32 matrix equals the XLA jit route's, also
    when it is computed in several blocks of pivots."""
    jp, tp = _random_patches(J, 2, 12), _random_patches(T, 2, 12)
    ref = JD.similarity_matrix_device(jp, J.PatchSet.from_features(jp), 200.0)
    got = TD.similarity_matrix_device(tp, T.PatchSet.from_features(tp), 200.0, "cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    monkeypatch.setattr(TD, "_BLOCK_ELEMENTS", 3 * len(tp) * max(len(p.features) for p in tp))
    np.testing.assert_array_equal(TD.similarity_matrix_device(tp, T.PatchSet.from_features(tp), 200.0, "cpu"), ref)


def test_device_roi_set_sim_rows():
    jp, tp = _random_patches(J, 6, 9), _random_patches(T, 6, 9)
    jd = JD.DeviceRoiSet(J.PatchSet.from_features(jp), jp, 200.0)
    td = TD.DeviceRoiSet(T.PatchSet.from_features(tp), tp, 200.0, "cpu")
    idx = np.array([3, 0, 5, 5, 1])
    for pivot in range(len(jp)):
        np.testing.assert_array_equal(td.sim_rows(pivot, idx), jd.sim_rows(pivot, idx))


@pytest.mark.parametrize("on_device", [False, True])
def test_train_forest(on_device):
    """Each route's forest equals the same route's forest in JAX, node for
    node (the shapes of tests/test_lchf.py::test_train_forest_device_matches_host)."""
    rng = np.random.default_rng(3)
    jp, tp = _random_patches(J, 21, 20, base=600, spread=30), _random_patches(T, 21, 20, base=600, spread=30)
    rpys = rng.standard_normal((len(jp), 3)).astype(np.float32)
    ts = rng.standard_normal((len(jp), 3)).astype(np.float32)
    jm = J.train_forest(jp, rpys, ts, J.LchfConfig(), device=on_device)
    tm = T.train_forest(tp, rpys, ts, T.LchfConfig(), on_device=on_device, device="cpu")
    assert sum(len(t.nodes) for t in jm.forest.trees) > len(jm.forest.trees)
    _same_forest(jm.forest, tm.forest)


def _fake_clusters(seed, n_clusters=4, per=30):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-50, 50, (n_clusters, 2))
    pts, rpy = [], []
    for ci, c in enumerate(centers):
        pts.append(c + rng.normal(0, 1.5, (per, 2)))
        base = np.array([ci * 0.7, -ci * 0.4, ci * 0.2])
        rpy.append(base + rng.normal(0, 0.02, (per, 3)))
    return np.concatenate(pts), np.concatenate(rpy).astype(np.float32)


@pytest.mark.parametrize("gain_norm", ["node", "reference"])
def test_forest_synthetic_similarity(gain_norm):
    """forest.py: the same draws, splits and gains as JAX's on the fake
    clusters of tests/test_lchf.py (cxxLCHF/test.cpp:94-141)."""
    pts, rpy = _fake_clusters(5)

    def similarity_rows(pivot, members):
        d = np.linalg.norm(pts[members] - pts[pivot], axis=1)
        return 100.0 * np.exp(-d / 20.0)

    jf = J.Forest(num_trees=3, train_ratio=0.8, seed=1, size_thresh=5, gain_norm=gain_norm)
    tf = T.Forest(num_trees=3, train_ratio=0.8, seed=1, size_thresh=5, gain_norm=gain_norm)
    jf.train(similarity_rows, rpy)
    tf.train(similarity_rows, rpy)
    _same_forest(jf, tf)
    probe = pts[5] + 0.1

    def sim_to(piv):
        return 100.0 * np.exp(-np.linalg.norm(pts[piv] - probe) / 20.0)

    assert tf.predict(sim_to) == jf.predict(sim_to)


def test_forest_files_cross_load(tmp_path):
    """A forest saved by either package loads into the other unchanged."""
    pts, rpy = _fake_clusters(6, n_clusters=2, per=20)

    def similarity_rows(pivot, members):
        return 100.0 * np.exp(-np.linalg.norm(pts[members] - pts[pivot], axis=1) / 20.0)

    jf = J.Forest(num_trees=2, seed=0, size_thresh=5)
    jf.train(similarity_rows, rpy)
    jf.save(str(tmp_path / "j.npz"))
    _same_forest(jf, T.Forest.load(str(tmp_path / "j.npz")))
    T.Forest.load(str(tmp_path / "j.npz")).save(str(tmp_path / "t.npz"))
    _same_forest(jf, J.Forest.load(str(tmp_path / "t.npz")))


def test_mean_shift(rng):
    pts = np.concatenate([rng.normal(0, 0.1, (30, 6)), rng.normal(3, 0.2, (25, 6)), rng.normal(-4, 0.3, (20, 6))])
    jm, jl = J.cluster_modes(pts, 1.0)
    tm, tl = T.cluster_modes(pts, 1.0)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(T.mean_shift(pts, 0.7), J.mean_shift(pts, 0.7))


def test_dense_rois():
    rng = np.random.default_rng(7)
    depth = np.zeros((100, 130), np.uint16)
    depth[18:77, 25:95] = rng.integers(400, 1200, (59, 70)).astype(np.uint16)
    depth[30:40, 40:55] = 0
    for stride, size in ((5, 50), (10, 40)):
        np.testing.assert_array_equal(
            T.dense_rois(depth, stride=stride, width=size, height=size, device="cpu"),
            J.dense_rois(depth, stride=stride, width=size, height=size),
        )


@pytest.mark.parametrize("on_device", [False, True])
def test_predict_scene(object_models, on_device):
    frame, (jf, jm), (tf, tm) = object_models
    _same_forest(jm.forest, tm.forest)
    rgb, depth, _ = frame["scene"]
    cfgj, cfgt = J.LchfConfig(**SMALL), T.LchfConfig(**SMALL)
    rois = J.dense_rois(depth, stride=10, width=40, height=40)
    jr = J.scene_roi_set(rgb, depth, rois, cfgj)
    tr = T.scene_roi_set(rgb, depth, rois, cfgt, "cpu")
    for k in ("responses", "z_avg", "center"):
        np.testing.assert_array_equal(getattr(tr, k), getattr(jr, k))
    leaves = J.predict_scene(jm, jr, cfgj, device=on_device)
    assert len({tuple(v) for v in leaves}) > 1
    assert T.predict_scene(tm, tr, cfgt, on_device=on_device, device="cpu") == leaves


def test_lchf_tables_from_model(object_models):
    """The walk's tables hold the JAX DeviceForest's, from a JAX model."""
    _, (jf, jm), _ = object_models
    jd = JD.DeviceForest(jm)
    tab = lchf_tables_from_model(jm, "cpu")
    assert tab.max_depth == jd.max_depth
    for got, ref in zip((tab.pivots.feats, tab.pivots.valid, tab.pivots.zrel, tab.pivots.center, tab.pivots.shape),
                        (jd.p_feats, jd.p_valid, jd.p_zrel, jd.p_center, jd.p_shape)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for tt, (split, thresh, leaf, child) in zip(tab.trees, jd.trees):
        for got, ref in ((tt.split, split), (tt.thresh, thresh), (tt.leaf, leaf), (tt.child, child)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("on_device", [False, True])
def test_jax_saved_model_predicts_jax_leaves(object_models, tmp_path, on_device):
    """A model saved by the JAX package loads into the port, which then
    predicts JAX's leaves (both routes); the port's save of it is JAX's."""
    frame, (_, jm), _ = object_models
    prefix = str(tmp_path / "jax_model")
    jm.save(prefix)
    tm = T.LchfModel.load(prefix)
    jl = J.LchfModel.load(prefix)
    rgb, depth, _ = frame["scene"]
    rois = J.dense_rois(depth, stride=10, width=40, height=40)
    jr = J.scene_roi_set(rgb, depth, rois, J.LchfConfig(**SMALL))
    tr = T.scene_roi_set(rgb, depth, rois, T.LchfConfig(**SMALL), "cpu")
    ref = J.predict_scene(jl, jr, J.LchfConfig(**SMALL), device=on_device)
    assert T.predict_scene(tm, tr, T.LchfConfig(**SMALL), on_device=on_device, device="cpu") == ref
    tm.save(str(tmp_path / "port_model"))
    back = J.LchfModel.load(str(tmp_path / "port_model"))
    _same_forest(jl.forest, back.forest)
    for k in ("responses", "z_avg", "center"):
        np.testing.assert_array_equal(getattr(back.patch_set, k), getattr(jl.patch_set, k))


def _votes(seed, v=20000, shape=(14, 12, 10, 10, 10)):
    """Seeded votes, half of them piled into a few bins, some out of range."""
    rng = np.random.default_rng(seed)
    roi_xy = rng.integers(-20, 160, (v, 2)).astype(np.int64)
    roi_d = rng.integers(300, 900, v).astype(np.int64)
    off = rng.normal(0, 40, (v, 3)).astype(np.float32)
    rpy = rng.uniform(-7.0, 7.0, (v, 3)).astype(np.float32)
    h = v // 2
    roi_xy[:h] = (70, 60)
    roi_d[:h] = 500
    off[:h, :2] = rng.normal(0, 3, (h, 2))
    rpy[:h] = rng.uniform(-3, 3, (4, 3)).astype(np.float32)[rng.integers(0, 4, h)]
    w = (1.0 / rng.integers(1, 40, v) / 5).astype(np.float32)
    return roi_xy, roi_d, off, rpy, w, shape


@pytest.mark.parametrize("seed", [0, 1])
def test_accumulate_votes(seed):
    """Equal to XLA's scatter-add to the bit: the same bins (XLA's folded
    constants), each bin's votes summed in input order."""
    roi_xy, roi_d, off, rpy, w, shape = _votes(seed)
    ref = np.asarray(J.accumulate_votes(jnp.asarray(roi_xy), jnp.asarray(roi_d), jnp.asarray(off),
                                        jnp.asarray(rpy), jnp.asarray(w), 500.0, shape, 10, 10))
    got = T.accumulate_votes(roi_xy, roi_d, off, rpy, w, 500.0, shape, 10, 10, device="cpu").numpy()
    assert (ref > 0).sum() > 100 and ref.max() > 5
    np.testing.assert_array_equal(got, ref)


def test_angle_bin_factor():
    """The factor of the angle bins is the one XLA compiles
    ``rpy / 2.0 / 3.14 * bins`` into, for several bin counts."""
    r = np.random.default_rng(9).uniform(-3.2, 3.2, 100000).astype(np.float32)
    for nb in (6, 8, 10, 12, 36):
        ref = np.asarray(jax.jit(lambda x, nb=nb: (x / 2.0 / 3.14 * nb).astype(jnp.int32))(r))
        np.testing.assert_array_equal((r * TV.angle_bin_factor(nb)).astype(np.int32), ref)


@pytest.mark.parametrize("modes", [False, True])
def test_hough_vote(object_models, modes):
    frame, (_, jm), (_, tm) = object_models
    rgb, depth, _ = frame["scene"]
    rois = J.dense_rois(depth, stride=10, width=40, height=40)
    leaves = J.predict_scene(jm, J.scene_roi_set(rgb, depth, rois, J.LchfConfig(**SMALL)), J.LchfConfig(**SMALL))
    jmodes = J.leaf_mode_map(jm) if modes else None
    tmodes = T.leaf_mode_map(tm) if modes else None
    if modes:
        for a, b in zip(jmodes, tmodes):
            assert a.keys() == b.keys()
            for k in a:
                for x, y in zip(a[k], b[k]):
                    np.testing.assert_array_equal(y, x)
    ja = J.assemble_votes(leaves, jm.leaf_feats_map(), rois, jm.rpy, jm.t, jmodes)
    ta = T.assemble_votes(leaves, tm.leaf_feats_map(), rois, tm.rpy, tm.t, tmodes)
    for x, y in zip(ja, ta):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(y, x)
    kw = dict(im_size=(140, 120), train_radius=500.0, steps=10, top_k=12)
    jb, js, jv = J.hough_vote(leaves, jm.leaf_feats_map(), rois, jm.rpy, jm.t, leaf_modes=jmodes, **kw)
    tb, ts, tv = T.hough_vote(leaves, tm.leaf_feats_map(), rois, tm.rpy, tm.t, leaf_modes=tmodes, device="cpu", **kw)
    assert js[0] > 0
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)


def test_decode_bin_poses():
    roi_xy, roi_d, off, rpy, w, shape = _votes(3)
    K = np.array([[200.0, 0, 70.0], [0, 200.0, 60.0], [0, 0, 1]])
    votes = np.asarray(J.accumulate_votes(jnp.asarray(roi_xy), jnp.asarray(roi_d), jnp.asarray(off),
                                          jnp.asarray(rpy), jnp.asarray(w), 500.0, shape, 10, 10))
    flat = votes.reshape(-1)
    top = np.argsort(-flat)[:10]
    bins = np.stack(np.unravel_index(top, votes.shape), axis=1)
    ref = J.decode_bin_poses(bins, roi_xy, roi_d, off, rpy, w, K, 500.0, depth_offset=12.5)
    got = T.decode_bin_poses(bins, roi_xy, roi_d, off, rpy, w, K, 500.0, depth_offset=12.5)
    assert len(ref) == 10 and len(got) == len(ref)
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
