"""Port parity of models/pipeline.py (single-class detect -> refine -> verify)
against the JAX package, on the CPU.

Tolerances:
- integers (tid, x, y, active), the matcher's score and the seeding
  helpers' selections compare exactly;
- ``_seed_candidates`` is the same float32 operations in the same order:
  exact;
- the seed fan goes through cos/sin, which may differ by an ulp between
  XLA and PyTorch: 1e-6 absolute;
- the fused pipeline's poses on active slots: R 1e-4 per entry, t 0.1 mm;
  fitness 2 / N (N cloud points: at most two inliers may flip at the gate);
  verify 2 / P (P verification points).  Dead slots are compared on
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
from sixdpose_tpu.models.train import render_train_templates, template_pose
from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import ColorGradientConfig, DepthNormalConfig, DetectorConfig, IcpConfig
from sixdpose_tpu_torch.convert import refine_bank_from_numpy
from sixdpose_tpu_torch.models import pipeline as TP
from sixdpose_tpu_torch.models.detector import Detector as TDetector

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


def assert_fused_close(j, t, n_points: int, n_verify: int):
    """Parity of two fused results: ``active`` everywhere; tid, x, y and
    score exactly, the rest within the module's tolerances, on active
    slots.  Returns the number of active slots and the largest errors."""
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
    assert err["R"] <= 1e-4 and err["t_mm"] <= 0.1, err
    assert err["fitness"] <= 2.0 / n_points + 1e-6 and err["verify"] <= 2.0 / n_verify + 1e-6, err
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
