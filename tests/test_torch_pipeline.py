"""Port parity of models/pipeline.py (detect -> refine -> verify, for one
class and for every class of a bank) against the JAX package, on the CPU.

Tolerances:
- integers (tid, x, y, active), the matcher's score and the seeding
  helpers' selections compare exactly;
- ``_seed_candidates`` is the same float32 operations in the same order:
  exact;
- the seed fan goes through cos/sin, which may differ by an ulp between
  XLA and PyTorch: 1e-6 absolute;
- the fused pipeline's poses on active slots: R 1e-4 per entry, t 0.1 mm;
  fitness 2 / N (N cloud points: at most two inliers may flip at the gate);
  verify 2 / P (P verification points); the multi-class pipeline's
  tighter: R 1e-5, t 0.01 mm, fitness and verify within one point.  Dead
  slots are compared on
  ``active`` only: the port's refine kernel zeroes dead candidates, as the
  TPU kernels do, while JAX on the CPU scores them, so their x, y, seeds
  and poses differ.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.benchmark import make_models
from sixdpose_tpu.config import ColorGradientConfig as JColor
from sixdpose_tpu.config import DepthNormalConfig as JDepth
from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.config import IcpConfig as JIcp
from sixdpose_tpu.geometry.render import render, subdivide_mesh
from sixdpose_tpu.models import pipeline as JP
from sixdpose_tpu.models.detector import Detector as JDetector
from sixdpose_tpu.models.multiclass import MultiClassMatcher as JMatcher
from sixdpose_tpu.models.train import render_train_templates, template_pose
from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import ColorGradientConfig, DepthNormalConfig, DetectorConfig, IcpConfig
from sixdpose_tpu_torch.convert import refine_bank_from_numpy
from sixdpose_tpu_torch.models import pipeline as TP
from sixdpose_tpu_torch.models.detector import Detector as TDetector
from sixdpose_tpu_torch.models.multiclass import MultiClassMatcher

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")
K = np.array([[160.0, 0, 80], [0, 160.0, 60], [0, 0, 1]])
IM = (160, 120)
CFG = dict(t_at_level=(4, 8), top_k=16)
COLOR = dict(num_features=24, strong_threshold=30.0)
DEPTH = dict(num_features=16, extract_threshold=1, focal=160.0)
NUM_POINTS = 256


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """The box bank of tests/test_pipeline.py::trained_box, trained by the
    JAX package (render_train_templates, 160x120) and carried to the port
    through the shared npz; the box's verification points and colors."""
    model = make_models()["box"]
    jdet = JDetector(JConfig(color=JColor(**COLOR), depth=JDepth(**DEPTH), **CFG))
    stats = render_train_templates(
        jdet, "box", model, K, radii=[420.0], min_n_views=16, im_size=IM, tilt_range=(0.0, 0.1), tilt_step=1.0,
    )
    assert stats["added"] >= 8, stats
    path = str(tmp_path_factory.mktemp("bank") / "box.npz")
    jdet.write_classes(path)
    tdet = TDetector.read_classes(
        path, DetectorConfig(color=ColorGradientConfig(**COLOR), depth=DepthNormalConfig(**DEPTH), **CFG), device="cpu"
    )
    pts, _, cols = subdivide_mesh(
        np.asarray(model["pts"], np.float64), np.asarray(model["faces"], np.int64), max_edge=6.0,
        attrs=np.asarray(model["colors"], np.float64),
    )
    return jdet, tdet, model, pts.astype(np.float32), cols.astype(np.float32)


def test_bank_infos_cross_intact(box):
    """The JAX bank's refine infos (clouds, colors, poses, bboxes) load
    unchanged in the port."""
    jdet, tdet, _, _, _ = box
    j_infos, t_infos = jdet.bank.infos["box"], tdet.bank.infos["box"]
    assert len(j_infos) == len(t_infos) == jdet.num_templates("box")
    for ji, ti in zip(j_infos, t_infos):
        for key in ("icp_points", "icp_colors", "cam_R_w2c", "cam_t_w2c", "render_bbox"):
            assert ti[key].dtype == ji[key].dtype
            np.testing.assert_array_equal(ti[key], ji[key])


def test_build_refine_bank_equals_converted_jax_bank(box):
    jdet, tdet, _, _, _ = box
    jrb = JP.build_refine_bank(jdet, "box", NUM_POINTS)
    fields = [None if a is None else np.array(a)
              for a in (jrb.clouds, jrb.valids, jrb.chroma, jrb.src_c, jrb.bbox_wh, jrb.base_T)]
    converted = refine_bank_from_numpy(fields, jrb.win, "cpu")
    built = TP.build_refine_bank(tdet, "box", NUM_POINTS, device="cpu")
    assert built.win == converted.win == tuple(jrb.win)
    for name in ("clouds", "valids", "chroma", "src_c", "bbox_wh", "base_T"):
        a, b = getattr(built, name), getattr(converted, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert float(built.base_T[0, 2, 3]) == pytest.approx(0.42, abs=0.01)  # z mm -> m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_median_matches_jax(seed):
    """Exact: a sort and an index."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 50, (6, 37)).astype(np.float32)
    mask = rng.random((6, 37)) < [[0.0], [0.05], [0.3], [0.5], [0.9], [1.0]]
    got = TP._masked_median(torch.from_numpy(vals), torch.from_numpy(mask)).numpy()
    want = [np.asarray(JP._masked_median(jnp.asarray(v), jnp.asarray(m))) for v, m in zip(vals, mask)]
    np.testing.assert_array_equal(got, np.array(want))


@pytest.mark.parametrize("win", [(96, 96), (48, 80)])
def test_seed_candidates_matches_jax(win):
    """Exact: the same float32 operations in the same order."""
    rng = np.random.default_rng(win[1])
    h, w, k = 96, 128, 9
    depth = (600 + rng.integers(0, 400, (h, w))).astype(np.uint16)
    depth[rng.random((h, w)) < 0.2] = 0
    depth[:30, :40] = 0  # a window with no depth seeds at 0.5 m
    x = np.concatenate([[0, 5], rng.integers(-3, w + 3, k - 2)]).astype(np.int32)
    y = np.concatenate([[0, 3], rng.integers(-3, h + 3, k - 2)]).astype(np.int32)
    wh = rng.integers(4, min(win), (k, 2)).astype(np.int32)
    wh[0] = (10, 10)
    src_c = rng.uniform(-0.05, 0.05, (k, 3)).astype(np.float32)
    Kc = np.array([[150.0, 0, 63.7], [0, 151.0, 47.2], [0, 0, 1]], np.float32)
    want = np.asarray(JP._seed_candidates(
        jnp.asarray(depth), jnp.asarray(x), jnp.asarray(y), jnp.asarray(wh), jnp.asarray(src_c), jnp.asarray(Kc), win
    ))
    got = TP._seed_candidates(
        torch.from_numpy(depth.astype(np.int32)), torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(wh),
        torch.from_numpy(src_c), torch.from_numpy(Kc), win,
    ).numpy()
    assert want[0, 2, 3] == pytest.approx(0.5 - src_c[0, 2])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seeds,flip", [(1, False), (3, False), (4, True), (2, True)])
def test_inplane_seed_transforms_matches_jax(seeds, flip):
    """1e-6: cos and sin may differ by an ulp between XLA and PyTorch."""
    rng = np.random.default_rng(seeds)
    init = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    init[:, :3, :3] = np.linalg.qr(rng.standard_normal((5, 3, 3)))[0].astype(np.float32)
    init[:, :3, 3] = rng.uniform(-0.1, 0.5, (5, 3))
    src_c = rng.uniform(-0.02, 0.02, (5, 3)).astype(np.float32)
    want = np.asarray(JP._inplane_seed_transforms(jnp.asarray(init), jnp.asarray(src_c), seeds, 18.0, flip))
    got = TP._inplane_seed_transforms(torch.from_numpy(init), torch.from_numpy(src_c), seeds, 18.0, flip).numpy()
    assert got.shape == want.shape == (5 * seeds, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _scene(model, det, template, shift):
    _, R0, t0 = template_pose(det, "box", template)
    t_gt = t0.flatten() + np.asarray(shift)
    rgb, depth = render(model, IM, K, R0, t_gt, mode="rgb+depth")
    return np.asarray(rgb), np.asarray(depth).astype(np.uint16), t_gt


def assert_fused_close(j, t, n_points: int, n_verify: int, tol_R=1e-4, tol_t=0.1, points=2):
    """Parity of two fused results: ``active`` everywhere; tid, x, y and
    score exactly, the rest within the module's tolerances (R, t in mm, and
    ``points`` of the N cloud or P verify points), on active slots.
    Returns the number of active slots and the largest errors."""
    j = [np.asarray(a) for a in j]
    t = [a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in t]
    act = j[8]
    np.testing.assert_array_equal(t[8], act)
    for i in range(4):
        np.testing.assert_array_equal(t[i][act], j[i][act])
    err = {
        "R": float(np.abs(t[4][act] - j[4][act]).max(initial=0.0)),
        "t_mm": float(np.abs(t[5][act] - j[5][act]).max(initial=0.0)),
        "fitness": float(np.abs(t[6][act] - j[6][act]).max(initial=0.0)),
        "verify": float(np.abs(t[7][act] - j[7][act]).max(initial=0.0)),
    }
    assert err["R"] <= tol_R and err["t_mm"] <= tol_t, err
    assert err["fitness"] <= points / n_points + 1e-6 and err["verify"] <= points / n_verify + 1e-6, err
    np.testing.assert_array_equal(t[6][~act], -1.0)
    np.testing.assert_array_equal(t[7][~act], -1.0)
    return int(act.sum()), err


@pytest.mark.parametrize("seeds", [1, 3])
def test_fused_pipeline_matches_jax(box, seeds):
    """The slice as a whole: both packages' FusedPipeline on a rendered box
    scene, max_refine 4, with verification points and colors; three seeds
    with the flip slot."""
    jdet, tdet, model, vpts, vcols = box
    icp = dict(max_iters=12)
    kw = dict(max_refine=4, num_points=NUM_POINTS, verify_pts=vpts, verify_colors=vcols,
              icp_seeds=seeds, seed_flip=seeds > 1)
    jpipe = JP.FusedPipeline(jdet, "box", K, icp=JIcp(**icp), **kw)
    tpipe = TP.FusedPipeline(tdet, "box", K, icp=IcpConfig(**icp), device="cpu", **kw)
    n_active = 0
    for template, shift in ((0, (14.0, -9.0, 22.0)), (2, (-10.0, 6.0, 15.0))):
        rgb, depth, t_gt = _scene(model, jdet, template, shift)
        j = jpipe(rgb, depth, 60.0)
        t = tpipe(rgb, depth, 60.0)
        n, _ = assert_fused_close(j, t, NUM_POINTS, len(vpts))
        n_active += n
        # The port recovers the pose, as test_pipeline.py asks of JAX.
        tt = t[5].numpy()
        assert bool(t[8][0]) and float(t[6][0]) > 0.5
        assert np.linalg.norm(tt[0] - t_gt) < 6.0, (tt[0], t_gt)
    assert n_active >= 4


def test_fused_pipeline_empty_scene(box):
    _, tdet, _, _, _ = box
    pipe = TP.FusedPipeline(tdet, "box", K, icp=IcpConfig(max_iters=6), max_refine=4, num_points=128, device="cpu")
    out = pipe(np.zeros((120, 160, 3), np.uint8), np.zeros((120, 160), np.uint16), 60.0)
    assert not out[8].any() and (out[6] < 0).all() and (out[7] < 0).all()


def test_fused_pipeline_needs_refine_infos():
    det = TDetector(DetectorConfig(), device="cpu")
    cid, templates, _, _ = synthetic.bench_bank(num_templates=2)
    for tl in templates:
        det.bank.add_template_levels(cid, tl)
    assert TP.build_refine_bank(det, cid, device="cpu") is None
    with pytest.raises(ValueError, match="icp_points"):
        TP.FusedPipeline(det, cid, synthetic.BENCH_K, device="cpu")


def test_refine_golden_on_cpu():
    """The JAX fused-pipeline golden of tools/torch_port_golden.py (VGA
    planted-object scene, bank with refine infos saved by the JAX
    TemplateBank.save): the port on the CPU gives the same result within the
    module's tolerances, and its top active pose moves template 0's cloud
    centroid by the planted shift."""
    g = np.load(os.path.join(TESTDATA, "planted_refine_golden.npz"))
    det = TDetector.read_classes(os.path.join(TESTDATA, "planted_bank.npz"), DetectorConfig(t_at_level=(5, 8)), device="cpu")
    pipe = TP.FusedPipeline(
        det, "planted", g["K"], icp=IcpConfig(max_iters=int(g["icp_max_iters"])), max_refine=int(g["max_refine"]),
        num_points=int(g["num_points"]), verify_pts=g["verify_pts"], verify_colors=g["verify_colors"],
        icp_seeds=int(g["icp_seeds"]), seed_flip=bool(g["seed_flip"]), device="cpu",
    )
    golden = np.load(os.path.join(TESTDATA, "planted_golden.npz"))
    rgb, depth = synthetic.planted_scene(*(int(v) for v in golden["scene_xy"]), seed=int(golden["scene_seed"]))
    out = pipe(rgb, depth, float(g["threshold"]))
    names = ("tid", "x", "y", "score", "R", "t_mm", "fitness", "verify", "active")
    n_active, _ = assert_fused_close([g[k] for k in names], out, int(g["num_points"]), len(g["verify_pts"]))
    assert n_active >= 3
    R, t = out[4][0].numpy().astype(np.float64), out[5][0].numpy().astype(np.float64)
    c = det.bank.infos["planted"][0]["icp_points"].astype(np.float64).mean(0) * 1000.0
    assert np.linalg.norm(R @ c + t - c - g["planted_shift_mm"]) <= float(g["translation_tol_mm"])


# -- every class of a bank (detect_refine_multiclass_core) --------------------


@pytest.fixture(scope="module")
def two_class(tmp_path_factory):
    """The box and cup bank of tests/test_pipeline.py::trained_two_class,
    trained by the JAX package and carried to the port through the npz;
    each class's verification points and colors."""
    models = make_models()
    cfg = dict(color=JColor(**COLOR), depth=JDepth(**DEPTH), **CFG)
    jdet = JDetector(JConfig(**cfg))
    vps, vcs = {}, {}
    for cid in ("box", "cup"):
        stats = render_train_templates(
            jdet, cid, models[cid], K, radii=[420.0], min_n_views=16, im_size=IM, tilt_range=(0.0, 0.1), tilt_step=1.0,
        )
        assert stats["added"] >= 8, (cid, stats)
        pts, _, cols = subdivide_mesh(
            np.asarray(models[cid]["pts"], np.float64), np.asarray(models[cid]["faces"], np.int64), max_edge=6.0,
            attrs=np.asarray(models[cid]["colors"], np.float64),
        )
        vps[cid], vcs[cid] = pts.astype(np.float32), cols.astype(np.float32)
    path = str(tmp_path_factory.mktemp("bank") / "two.npz")
    jdet.write_classes(path)
    tdet = TDetector.read_classes(
        path, DetectorConfig(color=ColorGradientConfig(**COLOR), depth=DepthNormalConfig(**DEPTH), **CFG), device="cpu"
    )
    return jdet, tdet, models, vps, vcs


def _two_object_scene(det, models):
    """Both objects in one frame, z-buffer composited
    (tests/test_pipeline.py::_two_object_scene)."""
    _, Rb, tb = template_pose(det, "box", 0)
    _, Rc, tc = template_pose(det, "cup", 0)
    t_box = tb.flatten() + np.array([-35.0, 0.0, 10.0])
    t_cup = tc.flatten() + np.array([45.0, 5.0, -15.0])
    rgb = np.zeros((IM[1], IM[0], 3), np.uint8)
    depth = np.zeros((IM[1], IM[0]), np.float32)
    for cid, R, t in (("box", Rb, t_box), ("cup", Rc, t_cup)):
        r_i, d_i = render(models[cid], IM, K, R, t, mode="rgb+depth")
        r_i, d_i = np.asarray(r_i), np.asarray(d_i)
        closer = (d_i > 0) & ((depth == 0) | (d_i < depth))
        depth[closer] = d_i[closer]
        rgb[closer] = r_i[closer]
    return rgb, depth.astype(np.uint16), {"box": t_box, "cup": t_cup}


def _flat(out):
    """(C, R, ...) results as (C * R, ...)."""
    return [np.asarray(a).reshape(-1, *np.asarray(a).shape[2:]) for a in out]


def test_fused_multiclass_matches_jax(two_class):
    """The slice as a whole: both packages' FusedMultiClassPipeline on the
    two-object scene, 4 hypotheses per class, 3 seeds with the flip, each
    class verified with its own points and colors."""
    jdet, tdet, models, vps, vcs = two_class
    kw = dict(class_ids=["box", "cup"], max_refine=4, num_points=NUM_POINTS, verify_pts=vps, verify_colors=vcs,
              icp_seeds=3, seed_flip=True)
    jpipe = JP.FusedMultiClassPipeline(jdet, K, icp=JIcp(max_iters=12), **kw)
    tpipe = TP.FusedMultiClassPipeline(tdet, K, icp=IcpConfig(max_iters=12), device="cpu", **kw)
    rgb, depth, gts = _two_object_scene(jdet, models)
    j, t = jpipe(rgb, depth, 55.0), tpipe(rgb, depth, 55.0)
    assert t[0].shape == (2, 4) and t[4].shape == (2, 4, 3, 3)
    n_verify = min(len(v) for v in vps.values())
    n, err = assert_fused_close(_flat(j), _flat(t), NUM_POINTS, n_verify, tol_R=1e-5, tol_t=0.01, points=1)
    assert n >= 4, err
    # Each class's best-verified active hypothesis lands on its object.
    for ci, cid in enumerate(["box", "cup"]):
        act = t[8][ci].numpy() & (t[6][ci].numpy() > 0.3)
        assert act.any(), cid
        best = int(np.argmax(np.where(act, t[7][ci].numpy(), -2.0)))
        assert np.linalg.norm(t[5][ci, best].numpy() - gts[cid]) < 10.0, cid


def test_fused_multiclass_matches_per_class(two_class):
    """The multi-class frame's row of each class against the single-class
    FusedPipeline of that class (tests/test_pipeline.py:186-220, with its
    tolerances: the two select hypotheses with different box extents)."""
    _, tdet, models, vps, vcs = two_class
    icp = IcpConfig(max_iters=10)
    mc = TP.FusedMultiClassPipeline(tdet, K, class_ids=["box", "cup"], icp=icp, max_refine=3, num_points=NUM_POINTS,
                                    verify_pts=vps, verify_colors=vcs, device="cpu")
    rgb, depth, _ = _two_object_scene(tdet, models)
    out_mc = [a.numpy() for a in mc(rgb, depth, 55.0)]
    for ci, cid in enumerate(["box", "cup"]):
        single = TP.FusedPipeline(tdet, cid, K, icp=icp, max_refine=3, num_points=NUM_POINTS, verify_pts=vps[cid],
                                  verify_colors=vcs[cid], device="cpu")
        tid, x, y, score, R, t, fit, ver, active = (a.numpy() for a in single(rgb, depth, 55.0))
        np.testing.assert_array_equal(out_mc[8][ci], active)
        assert active.any()
        np.testing.assert_array_equal(out_mc[0][ci][active], tid[active])
        np.testing.assert_allclose(out_mc[3][ci][active], score[active], atol=1e-4)
        np.testing.assert_allclose(out_mc[5][ci][active], t[active], atol=0.5)
        np.testing.assert_allclose(out_mc[7][ci][active], ver[active], atol=0.02)


def test_fused_multiclass_one_class_equals_fused_pipeline(box):
    """A one-class multi-class frame is the single-class frame where both
    pick the same hypotheses: the same match, ICP and verification."""
    _, tdet, _, vpts, vcols = box
    icp = IcpConfig(max_iters=8)
    kw = dict(max_refine=4, num_points=NUM_POINTS, icp_seeds=2, seed_flip=True, device="cpu")
    mc = TP.FusedMultiClassPipeline(tdet, K, icp=icp, verify_pts={"box": vpts}, verify_colors={"box": vcols}, **kw)
    single = TP.FusedPipeline(tdet, "box", K, icp=icp, verify_pts=vpts, verify_colors=vcols, **kw)
    rgb, depth, _ = _scene(box[2], box[0], 0, (14.0, -9.0, 22.0))
    a = [x[0] for x in mc(rgb, depth, 60.0)]
    b = single(rgb, depth, 60.0)
    same = (a[0] == b[0]) & (a[1] == b[1]) & (a[2] == b[2]) & a[8] & b[8]
    assert bool(same[0])
    for x, y in zip(a, b):
        assert torch.equal(x[same], y[same])


def test_fused_multiclass_empty_scene(two_class):
    _, tdet, _, vps, _ = two_class
    pipe = TP.FusedMultiClassPipeline(tdet, K, icp=IcpConfig(max_iters=4), max_refine=2, num_points=64,
                                      verify_pts=vps, device="cpu")
    out = pipe(np.zeros((120, 160, 3), np.uint8), np.zeros((120, 160), np.uint16), 55.0)
    assert out[0].shape == (2, 2) and not out[8].any() and (out[6] < 0).all() and (out[7] < 0).all()


def test_fused_multiclass_needs_refine_infos_and_verify_points(two_class):
    _, tdet, _, vps, _ = two_class
    with pytest.raises(ValueError, match="verify_pts"):
        TP.FusedMultiClassPipeline(tdet, K, device="cpu")
    det = TDetector(DetectorConfig(), device="cpu")
    cid, templates, _, _ = synthetic.bench_bank(num_templates=2)
    for tl in templates:
        det.bank.add_template_levels(cid, tl)
    with pytest.raises(ValueError, match="icp_points"):
        TP.FusedMultiClassPipeline(det, synthetic.BENCH_K, verify_pts={cid: vps["box"]}, device="cpu")


def test_refine_bank_of_two_classes_equals_jax(two_class):
    """The global refine bank (class-major, the largest window) and the
    padded verification points of the two pipelines."""
    jdet, tdet, _, vps, vcs = two_class
    kw = dict(class_ids=["cup", "box"], num_points=NUM_POINTS, verify_pts=vps, verify_colors=vcs)
    j = JP.FusedMultiClassPipeline(jdet, K, **kw)
    t = TP.FusedMultiClassPipeline(tdet, K, device="cpu", **kw)
    assert t.rb.win == tuple(j.rb.win)
    for name in ("clouds", "valids", "chroma", "src_c", "bbox_wh", "base_T"):
        np.testing.assert_array_equal(getattr(t.rb, name).numpy(), np.asarray(getattr(j.rb, name)), err_msg=name)
    for name in ("verify_pts", "verify_valid", "verify_colors"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(t.mc.pad_map.numpy(), np.asarray(JMatcher(jdet, ["cup", "box"]).pad_map))


def test_planted_mc_golden_on_cpu():
    """The JAX fused multi-class golden of tools/torch_port_mc_golden.py
    (two planted objects in a VGA scene, three classes with refine infos):
    the port on the CPU gives the same result within the module's
    tolerances, and each planted class's top active pose moves its cloud
    centroid by the planted shift."""
    g = np.load(os.path.join(TESTDATA, "planted_mc_golden.npz"))
    det = TDetector.read_classes(os.path.join(TESTDATA, "planted_mc_bank.npz"), DetectorConfig(t_at_level=(5, 8)), device="cpu")
    cids = list(g["class_ids"])
    counts = g["verify_count"]
    pipe = TP.FusedMultiClassPipeline(
        det, g["K"], class_ids=cids, icp=IcpConfig(max_iters=int(g["icp_max_iters"])), max_refine=int(g["max_refine"]),
        num_points=int(g["num_points"]), icp_seeds=int(g["icp_seeds"]), seed_flip=bool(g["seed_flip"]),
        verify_pts={c: g["verify_pts"][i, : counts[i]] for i, c in enumerate(cids)},
        verify_colors={c: g["verify_colors"][i, : counts[i]] for i, c in enumerate(cids)}, device="cpu",
    )
    rgb, depth = synthetic.planted_scene_multi([tuple(p) for p in g["placements"].tolist()], seed=int(g["scene_seed"]))
    out = pipe(rgb, depth, float(g["refine_threshold"]))
    names = ("tid", "x", "y", "score", "R", "t_mm", "fitness", "verify", "active")
    n_active, _ = assert_fused_close(_flat([g[f"fused_{k}"] for k in names]), _flat(out), int(g["num_points"]),
                                     int(counts.min()))
    assert n_active >= 3
    for (ci, _, _), shift in zip(g["placements"], g["planted_shift_mm"]):
        top = int(np.flatnonzero(out[8][ci].numpy())[0])
        R, t = out[4][ci, top].numpy().astype(np.float64), out[5][ci, top].numpy().astype(np.float64)
        c = det.bank.infos[cids[ci]][0]["icp_points"].astype(np.float64).mean(0) * 1000.0
        assert out[0][ci, top] == 0 and np.linalg.norm(R @ c + t - c - shift) <= float(g["translation_tol_mm"])
