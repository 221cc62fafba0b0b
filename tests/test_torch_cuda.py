"""Tests of the port that need a CUDA card (marker ``cuda``).

The local-refine kernel against its plain version on the card, the
wrapper's input checks, the detector on the card against its CPU run, the
response-pyramid kernels against their plain version, the scene maps,
batched ICP, verification and the fused detect+refine frame on the card
against their CPU runs, the multi-class path (the coarse-scorer
kernel, ``MultiClassMatcher`` and ``FusedMultiClassPipeline``),
the multi-scale matchers (``MultiScaleMultiClass``, ``MultiScaleDetector``),
the rasterizer, ``PoseEstimationService`` and ``run_benchmark`` on the card
against their CPU runs and the JAX goldens.
They import neither JAX nor the JAX package, so a GPU machine without JAX
runs them apart from the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card each test skips.  Scores are sums of small integers in
float32 and counts are integers, so every comparison of the matcher is
exact; the refine tests state their tolerances below.
"""

import os

import numpy as np
import pytest
import torch

from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.entry import entry
from sixdpose_tpu_torch.models.detector import Detector, detect_frame_core
from sixdpose_tpu_torch.ops import local_refine as LR
from sixdpose_tpu_torch.ops.similarity import similarity_local_sparse

from coarse_cases import EDGE_CASES, edge_case

pytestmark = pytest.mark.cuda

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, c, h, w, t, k, f, xmax=120, ymax=150, b=None, scale=False, active=False):
    rng = np.random.default_rng(seed)
    lead = (k,) if b is None else (b, k)
    maps = rng.integers(0, 5, (c, h, w) if b is None else (b, c, h, w)).astype(np.uint8)
    feats = np.stack(
        [rng.integers(0, xmax, lead + (f,)), rng.integers(0, ymax, lead + (f,)), rng.integers(0, c, lead + (f,))], -1
    ).astype(np.int32)
    valid = rng.random(lead + (f,)) < 0.9
    org = (rng.integers(0, max(1, min(h, w) // t - 4), lead + (2,)) * t).astype(np.int32)
    out = dict(maps=maps, feats=feats, valid=valid, origins=org, scale=None, active=None)
    if scale:
        out["scale"] = rng.uniform(0.4, 1.3, lead).astype(np.float32)
    if active:
        out["active"] = rng.random(lead) < 0.7
    return out


# The shapes of tests/test_pallas.py, a window below 16, a batch of frames,
# F = 700 and F = 61; the levelup maximum F = 8191 (one table pass) and
# F = 9000 (two passes); each split of a candidate into 1, 2 or 4 thread
# groups (chosen from B*K, here for 132 SMs) with F not a multiple of it,
# up to B*K = 1020.
CASES = {
    "vga_t5_K16_F64_scale": (5, 16, dict(c=16, h=480, w=640, t=5, k=16, f=64, scale=True)),
    "t4_K8_F16_active_tails": (4, 16, dict(c=8, h=128, w=128, t=4, k=8, f=16, xmax=30, ymax=30, active=True)),
    "vga_t4_K64_F120_window11": (4, 11, dict(c=16, h=480, w=640, t=4, k=64, f=120)),
    "batch3_t5_K12_F40_active": (5, 16, dict(c=16, h=96, w=128, t=5, k=12, f=40, b=3, active=True)),
    "t5_K5_F700_scale_active": (5, 16, dict(c=16, h=96, w=128, t=5, k=5, f=700, scale=True, active=True)),
    "t4_K9_F61_edges": (4, 16, dict(c=16, h=93, w=122, t=4, k=9, f=61)),
    "t5_K4_F8191_scale_active": (5, 16, dict(c=16, h=480, w=640, t=5, k=4, f=8191, scale=True, active=True)),
    "t5_K3_F9000_two_passes": (5, 16, dict(c=16, h=480, w=640, t=5, k=3, f=9000, scale=True, active=True)),
    "t5_K128_F253_split4": (5, 16, dict(c=16, h=480, w=640, t=5, k=128, f=253, active=True)),
    "t4_K300_F37_split2_window13": (4, 13, dict(c=16, h=203, w=317, t=4, k=300, f=37, scale=True)),
    "batch4_t5_K255_F29_split1": (5, 16, dict(c=16, h=161, w=242, t=5, k=255, f=29, b=4, scale=True, active=True)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain(cuda, name):
    t, window, kw = CASES[name]
    c = _case(list(CASES).index(name), **kw)
    if name.endswith("tails"):
        c["valid"][:, 10:] = False
    args = {n: None if v is None else torch.from_numpy(v).to(cuda) for n, v in c.items()}
    before = LR.similarity_local_sparse_cuda.launches
    ks, kc = LR.similarity_local_sparse_cuda(
        args["maps"], args["feats"], args["valid"], args["origins"], t, window, args["scale"], args["active"]
    )
    ps, pc = similarity_local_sparse(
        args["maps"], args["feats"], args["valid"], args["origins"], t, window, args["scale"], args["active"]
    )
    torch.cuda.synchronize()
    assert LR.similarity_local_sparse_cuda.launches == before + 1
    assert torch.equal(ks, ps) and torch.equal(kc, pc)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    c = _case(1, c=8, h=64, w=64, t=4, k=4, f=8, xmax=20, ymax=20)
    maps, feats, valid, org = (torch.from_numpy(c[n]).to(cuda) for n in ("maps", "feats", "valid", "origins"))
    with pytest.raises(TypeError):
        LR.similarity_local_sparse_cuda(maps.to(torch.int32), feats, valid, org, 4)
    with pytest.raises(ValueError, match="contiguous"):
        LR.similarity_local_sparse_cuda(maps, feats.transpose(0, 1).contiguous().transpose(0, 1), valid, org, 4)
    with pytest.raises(ValueError, match="window"):
        LR.similarity_local_sparse_cuda(maps, feats, valid, org, 4, window=17)
    with pytest.raises(ValueError, match="on cpu"):
        LR.similarity_local_sparse_cuda(maps, feats, valid.cpu(), org, 4)


def _same(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def test_detector_on_card_equals_cpu_run(cuda):
    """A cut bench workload (8 templates) at VGA: the card's result equals
    the port's CPU run everywhere, single frames and a batch, and the
    refine kernel ran."""
    cid, templates, rgb, dep = synthetic.bench_bank(num_templates=8)
    dets = {}
    for device in (cuda, "cpu"):
        dets[device] = Detector(DetectorConfig(t_at_level=(5, 8)), device=device)
        for tl in templates:
            dets[device].bank.add_template_levels(cid, tl)
    before = LR.similarity_local_sparse_cuda.launches
    for thr in (75.0, 30.0):
        gpu = dets[cuda].match_arrays(rgb, dep, thr, cid)
        assert _same(gpu, dets["cpu"].match_arrays(rgb, dep, thr, cid))
    frames = np.stack([rgb, rgb ^ np.uint8(1)])
    batch = dets[cuda].match_batch_arrays(frames, np.stack([dep, dep]), 30.0, cid)
    for i in range(2):
        assert _same([a[i] for a in batch], dets["cpu"].match_arrays(frames[i], dep, 30.0, cid))
    assert LR.similarity_local_sparse_cuda.launches == before + 3


def test_dense_route_on_card_equals_cpu_and_the_entry_golden(cuda):
    """The bank without feature lists (grouped-conv refinement): a cut bench
    workload at VGA, one frame and a batch of two, at 75 and 30, equal on
    the card and the CPU in every slot, and ``entry()`` on the card equal to
    the JAX golden; the route launches no refine kernel."""
    cid, templates, rgb, dep = synthetic.bench_bank(num_templates=8)
    banks = {}
    for device in (cuda, "cpu"):
        det = Detector(DetectorConfig(t_at_level=(5, 8)), device=device)
        for tl in templates:
            det.bank.add_template_levels(cid, tl)
        banks[device] = det.device_bank(cid).without_features()
    frames = np.stack([rgb, rgb ^ np.uint8(1)])
    deps = np.stack([dep, dep]).astype(np.int32)
    before = LR.similarity_local_sparse_cuda.launches
    for thr in (75.0, 30.0):
        for r, d in ((frames[0], deps[0]), (frames, deps)):
            got = detect_frame_core(torch.from_numpy(r).to(cuda), torch.from_numpy(d).to(cuda), banks[cuda],
                                    DetectorConfig(t_at_level=(5, 8)), thr)
            want = detect_frame_core(torch.from_numpy(r), torch.from_numpy(d), banks["cpu"],
                                     DetectorConfig(t_at_level=(5, 8)), thr)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    g = np.load(os.path.join(TESTDATA, "entry_golden.npz"))
    fn, args = entry(device=cuda)
    out = fn(*args)
    for name, a in zip(("tid", "x", "y", "score", "keep"), out):
        np.testing.assert_array_equal(a.cpu().numpy(), g[name])
    assert LR.similarity_local_sparse_cuda.launches == before


def test_planted_golden_on_card(cuda):
    """The JAX golden of tools/torch_port_golden.py on the card."""
    g = np.load(os.path.join(TESTDATA, "planted_golden.npz"))
    det = Detector.read_classes(
        os.path.join(TESTDATA, "planted_bank.npz"),
        DetectorConfig(t_at_level=tuple(int(v) for v in g["t_at_level"])),
        device=cuda,
    )
    rgb, depth = synthetic.planted_scene(*(int(v) for v in g["scene_xy"]), seed=int(g["scene_seed"]))
    tid, x, y, score, keep = (a.cpu().numpy() for a in det.match_arrays(rgb, depth, float(g["threshold"]), "planted"))
    live = g["score"] >= 0
    np.testing.assert_array_equal(score >= 0, live)
    np.testing.assert_array_equal(keep, g["keep"])
    for a, name in ((tid, "tid"), (x, "x"), (y, "y"), (score, "score")):
        np.testing.assert_array_equal(a[live], g[name][live])


# -- refine and verify (models/refine.py, models/pipeline.py) ----------------
#
# GPU against the port's CPU run: integers (tid, x, y, score, active)
# exactly; R per entry 1e-4, t 1e-4 m (0.1 mm), fitness and verify 2 / N of
# their N points.  Every sum on that path is a fixed-order tree of adds and
# the transcendental functions run in float64, so the two runs are expected
# to agree to the bit; the tolerances are those of the CPU parity tests.


def _view_cloud(k=6, n=400, seed=0):
    """Training view 0 (VGA) as the scene, K copies of its object's cloud
    (with chroma) offset by up to 4 mm."""
    from sixdpose_tpu_torch.models.refine import sample_model_points

    rgb, depth, mask = synthetic.training_view(0)
    obj = np.where(mask > 0, depth, 0).astype(np.uint16)
    pts, val, (ys, xs) = sample_model_points(obj, synthetic.BENCH_K, n, return_pixels=True)
    cols = rgb[ys, xs].astype(np.float32)
    chroma = np.zeros((n, 2), np.float32)
    chroma[: len(cols)] = cols[:, :2] / np.maximum(cols.sum(-1, keepdims=True), 1e-6)
    init = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    init[:, :3, 3] = np.random.default_rng(seed).uniform(-0.004, 0.004, (k, 3))
    stack = lambda a: np.ascontiguousarray(np.broadcast_to(a, (k,) + a.shape))  # noqa: E731
    return rgb, depth, stack(pts), stack(val), stack(chroma), init, cols


def _scene_maps(rgb, depth, device):
    from sixdpose_tpu_torch.models import refine as TR

    K = torch.from_numpy(synthetic.BENCH_K).to(device)
    sp = TR.backproject(torch.from_numpy(depth.astype(np.int32)).to(device), K)
    return sp, TR.scene_normals(sp), TR.scene_chroma(torch.from_numpy(rgb).to(device)), K


def _close(gpu, cpu, atol):
    return all(float((g.cpu() - c).abs().max()) <= a for g, c, a in zip(gpu, cpu, atol))


def test_scene_maps_and_icp_batch_on_card_equal_cpu(cuda):
    from sixdpose_tpu_torch.models import refine as TR

    rgb, depth, pts, val, chroma, init, _ = _view_cloud()
    out = {}
    for device in (cuda, torch.device("cpu")):
        sp, sn, chroma_maps, K = _scene_maps(rgb, depth, device)
        args = [torch.from_numpy(a).to(device) for a in (pts, val, init, chroma)]
        out[device.type] = (sp, sn, *chroma_maps), TR.icp_batch(
            args[0], args[1], sp, sn, K, args[2], max_iters=16, model_chroma=args[3], chroma_maps=chroma_maps,
            color_weight=0.1,
        )
    torch.cuda.synchronize()
    maps_gpu, (T, fit, rmse) = out["cuda"]
    maps_cpu, (T_c, fit_c, rmse_c) = out["cpu"]
    assert all(torch.equal(g.cpu(), c) for g, c in zip(maps_gpu, maps_cpu))
    assert _close((T[:, :3, :3], T[:, :3, 3], fit, rmse), (T_c[:, :3, :3], T_c[:, :3, 3], fit_c, rmse_c),
                  (1e-4, 1e-4, 2.0 / pts.shape[1], 1e-6))
    assert (fit_c > 0.8).all()


# The ICP kernel's shapes: the fused frame's call (K 240, N 512, colour),
# the host route's (N 1,024, K 1, 57, 63, colour on and off), a cloud that
# is not a power of two (with the coarse subset at 64), one below a block
# (256 threads), one of 2,000 points (8 a thread), clouds above 2,048 that
# the kernel streams from memory, and schedules above the 128 iterations
# the launch arguments hold.  synthetic.icp_call makes candidates 7, 17,
# ... start a metre off (never 6 inliers) and 9, 19, ... without valid
# points.
ICP_CASES = {
    "tless_K240_N512_color": ("tless", 240, 512, True, {}),
    "linemod_K1_N1024_color": ("linemod", 1, 1024, True, {}),
    "linemod_K1_N1024_geometry": ("linemod", 1, 1024, False, {}),
    "linemod_K57_N1024_color": ("linemod", 57, 1024, True, {}),
    "linemod_K57_N1024_geometry": ("linemod", 57, 1024, False, {}),
    "linemod_K63_N1024_color": ("linemod", 63, 1024, True, {}),
    "linemod_K63_N1024_geometry": ("linemod", 63, 1024, False, {}),
    "linemod_K13_N337_color_coarse64": ("linemod", 13, 337, True, dict(max_iters=16, bilinear_iters=6, coarse_points=64)),
    "tless_K12_N100_geometry": ("tless", 12, 100, False, dict(max_iters=12)),
    "tless_K12_N2000_color": ("tless", 12, 2000, True, {}),
    "tless_K12_N2049_color": ("tless", 12, 2049, True, {}),
    "linemod_K12_N4100_geometry_coarse64": ("linemod", 12, 4100, False, dict(coarse_points=64)),
    "tless_K12_N512_color_iters130": ("tless", 12, 512, True, dict(max_iters=130)),
    "linemod_K10_N3000_color_iters129": ("linemod", 10, 3000, True, dict(max_iters=129)),
}


def _icp_args(deployment, k, n, color, device):
    from sixdpose_tpu_torch.config import IcpConfig
    from sixdpose_tpu_torch.models import refine as TR

    c = synthetic.icp_call(deployment, k=k, n=n, color=color)
    K = torch.from_numpy(c["K"]).to(device)
    sp = TR.backproject(torch.from_numpy(c["depth"]).to(device), K)
    args = [torch.from_numpy(c["pts"]).to(device), torch.from_numpy(c["valid"]).to(device), sp, TR.scene_normals(sp),
            K, torch.from_numpy(c["init_T"]).to(device)]
    cfg = IcpConfig()
    kw = {f: getattr(cfg, f) for f in ("corr_dist", "max_iters", "coarse_gate_mult", "color_weight", "chroma_scale",
                                       "point_weight", "lm_damping", "bilinear_iters", "coarse_points")}
    kw.update(model_chroma=None, chroma_maps=None)
    if color:
        kw.update(model_chroma=torch.from_numpy(c["chroma"]).to(device),
                  chroma_maps=TR.scene_chroma(torch.from_numpy(c["rgb"]).to(device)))
    return args, kw


@pytest.mark.parametrize("name", list(ICP_CASES))
def test_icp_kernel_equals_plain_on_card(cuda, name):
    """``icp_batch`` on the card (the ICP kernel, one launch by the
    wrapper's counter) gives T, fitness and rmse equal to the bit to
    ``icp_batch_plain`` on the card, degenerate candidates included."""
    from sixdpose_tpu_torch.models import refine as TR
    from sixdpose_tpu_torch.ops import icp as OI

    deployment, k, n, color, extra = ICP_CASES[name]
    args, kw = _icp_args(deployment, k, n, color, cuda)
    kw.update(extra)
    before = OI.icp_cuda.launches
    got = TR.icp_batch(*args, **kw)
    assert OI.icp_cuda.launches == before + 1
    want = TR.icp_batch_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("T", "fitness", "rmse")):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w), (what, float((g - w).abs().max()))
    fit = want[1].cpu().numpy()
    off = np.isin(np.arange(k) % 10, (7, 9))  # a metre off; no valid points
    assert (fit[off] == 0.0).all() and (fit[~off] > 0.5).all(), fit


def test_icp_batch_takes_strided_inputs_on_card(cuda):
    """``icp_batch`` on the card takes strided inputs (one cloud expanded
    over the candidates, as ``parallel/fused.py`` passes it; a transposed
    copy of the start poses) in one launch, with the plain version's bits."""
    from sixdpose_tpu_torch.models import refine as TR
    from sixdpose_tpu_torch.ops import icp as OI

    args, kw = _icp_args("linemod", 12, 1024, True, cuda)
    pts, valid = args[0][:1].expand(12, -1, -1), args[1][:1].expand(12, -1)
    init_T = args[5].transpose(1, 2).contiguous().transpose(1, 2)
    kw["model_chroma"] = kw["model_chroma"][:1].expand(12, -1, -1)
    assert not any(x.is_contiguous() for x in (pts, valid, init_T, kw["model_chroma"]))
    call = (pts, valid, *args[2:5], init_T)
    before = OI.icp_cuda.launches
    got = TR.icp_batch(*call, **kw)
    assert OI.icp_cuda.launches == before + 1
    want = TR.icp_batch_plain(*call, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _pyramid_scene(seed, b, h, w):
    """B frames: RGB noise with two flat blocks, and depth of a tilted dome
    with noise, a hole of zeros, a band past the distance threshold and a
    400 mm step."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    rgb[:, h // 5 : h // 2, w // 4 : 3 * w // 4] = (200, 40, 90)
    rgb[:, h // 3 : 2 * h // 3, w // 2 :] = (30, 220, 120)
    yy, xx = np.mgrid[0:h, 0:w]
    d = 800.0 + 0.8 * xx - 0.5 * yy - 80.0 * np.sqrt(np.clip(1 - ((yy - h / 2) ** 2 + (xx - w / 2) ** 2)
                                                             / (0.35 * max(h, 2)) ** 2, 0, 1))
    dep = d + rng.normal(0, 3.0, (b, h, w))
    dep[:, : h // 6, : w // 5] = 0
    dep[:, h // 2 :, : w // 8] = 2600
    dep[:, h // 4 : h // 3, :] += 400
    return torch.from_numpy(rgb), torch.from_numpy(np.clip(dep, 0, 65535).astype(np.int32))


# name: (frames, height, width, DetectorConfig settings, strided inputs)
PYRAMID_CASES = {
    "tless_720x540": (1, 540, 720, dict(t_at_level=(5, 8)), False),
    "linemod_640x480": (1, 480, 640, dict(t_at_level=(5, 8)), False),
    "odd_131x97_b2_t4": (2, 97, 131, dict(t_at_level=(4, 8)), False),
    "below_the_halos_13x9_t1": (1, 9, 13, dict(t_at_level=(1, 2)), False),
    "stock_lut_parity": (1, 120, 160, dict(t_at_level=(5, 8), response_lut="stock", depth=dict(lut_parity=True)),
                         False),
    "binary45_colour_only": (1, 120, 160, dict(t_at_level=(4, 8), response_lut="binary45", use_depth=False), False),
    "depth_only_thresholds": (2, 96, 128, dict(t_at_level=(5, 8), use_color=False, depth=dict(
        distance_threshold=1000, difference_threshold=20, focal=572.0)), False),
    "three_levels_weak_threshold": (1, 150, 200, dict(t_at_level=(4, 8, 3), color=dict(weak_threshold=7.3)), False),
    "strided_b2": (2, 97, 131, dict(t_at_level=(5, 8)), True),
}


@pytest.mark.parametrize("name", list(PYRAMID_CASES))
def test_response_pyramid_kernel_equals_plain(cuda, name):
    """``_build_response_pyramid`` on the card (the pyramid kernels, one
    launcher call by the wrapper's counter) gives every level's maps equal
    to the byte to ``_build_response_pyramid_plain`` on the card and on the
    CPU."""
    from sixdpose_tpu_torch.config import ColorGradientConfig, DepthNormalConfig
    from sixdpose_tpu_torch.models import detector as D
    from sixdpose_tpu_torch.ops import response_pyramid as RP

    b, h, w, kw, strided = PYRAMID_CASES[name]
    kw = dict(kw)
    cfg = DetectorConfig(color=ColorGradientConfig(**kw.pop("color", {})),
                         depth=DepthNormalConfig(**kw.pop("depth", {})), **kw)
    rgb, dep = _pyramid_scene(len(name), b, h, w)
    rgb_d, dep_d = rgb.to(cuda), dep.to(cuda)
    if strided:  # a crop of a wider frame and a transposed copy
        rgb_d = torch.cat([rgb_d, rgb_d[:, :, :5]], dim=2)[:, :, :w]
        dep_d = dep_d.transpose(1, 2).contiguous().transpose(1, 2)
        assert not (rgb_d.is_contiguous() or dep_d.is_contiguous())
    before = RP.response_pyramid_cuda.launches
    got = D._build_response_pyramid(rgb_d, dep_d, cfg)
    assert RP.response_pyramid_cuda.launches == before + 1
    on_card = D._build_response_pyramid_plain(rgb_d, dep_d, cfg)
    on_cpu = D._build_response_pyramid_plain(rgb, dep, cfg)
    assert len(got) == len(cfg.t_at_level)
    for g, c, p in zip(got, on_card, on_cpu):
        assert g.shape == c.shape == p.shape and g.dtype == torch.uint8
        assert torch.equal(g, c), int((g != c).sum())
        assert torch.equal(g.cpu(), p)
    assert int((got[0] != 0).sum()) > 0


def test_response_pyramid_runs_once_a_frame(cuda):
    """A frame's pyramid at each cell's frame size calls the kernels'
    launcher once, and the launcher enqueues at most 8 kernels inside the
    ``pyramid`` stage span."""
    from torch.profiler import ProfilerActivity, profile

    from sixdpose_tpu_torch.ops import response_pyramid as RP

    det = Detector(DetectorConfig(t_at_level=(5, 8)), device=cuda)
    frames = [_pyramid_scene(0, 1, 540, 720), _pyramid_scene(1, 1, 480, 640)]
    frames = [(r[0].numpy(), d[0].numpy()) for r, d in frames]
    for rgb, dep in frames:
        det.build_response_pyramid(rgb, dep)
    torch.cuda.synchronize()
    before = RP.response_pyramid_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for rgb, dep in frames:
            det.build_response_pyramid(rgb, dep)
        torch.cuda.synchronize()
    assert RP.response_pyramid_cuda.launches == before + 2
    events = prof.events()
    spans = [e.time_range for e in events if e.name == "sixdpose.pyramid"]
    assert len(spans) == 2
    for r in spans:
        launches = [e.name for e in events if (e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC")
                                               or e.name.startswith("cuLaunchKernel"))
                    and r.start <= e.time_range.start <= r.end]
        assert 1 <= len(launches) <= 8, launches


@pytest.mark.parametrize("zscore", [False, True])
def test_verify_poses_multi_on_card_equals_cpu(cuda, zscore):
    from sixdpose_tpu_torch.models import refine as TR

    rgb, depth, pts, val, _, init, cols = _view_cloud(k=5, seed=3)
    rng = np.random.default_rng(4)
    val = val.copy()
    val[1, 200:] = False
    pts_mm = (pts * 1000.0).astype(np.float32)
    colors = np.zeros(pts.shape, np.float32)
    colors[:, : len(cols)] = cols
    Rs = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
    ts = (init[:, :3, 3] * 1000.0).astype(np.float32)
    ts[2, 2] += 200.0  # behind the surface
    ts[3] = rng.uniform(-30, 30, 3)
    out = {}
    for device in (cuda, torch.device("cpu")):
        K = torch.from_numpy(synthetic.BENCH_K).to(device)
        a = [torch.from_numpy(x).to(device) for x in (pts_mm, val, Rs, ts, depth.astype(np.int32), colors, rgb)]
        out[device.type] = TR.verify_poses_multi(
            a[0], a[1], a[2], a[3], a[4], K, model_colors=a[5], rgb=a[6], color_zscore=zscore
        )
    assert _close((out["cuda"],), (out["cpu"],), (2.0 / pts.shape[1],))
    assert float(out["cpu"][0]) > 0.8 and float(out["cpu"][2]) == 0.0


def _bench_refine(device, num_templates=8):
    from sixdpose_tpu_torch.convert import refine_bank_from_numpy

    cid, templates, rgb, dep = synthetic.bench_bank(num_templates=num_templates)
    det = Detector(DetectorConfig(t_at_level=(5, 8)), device=device)
    for tl in templates:
        det.bank.add_template_levels(cid, tl)
    bank = det.device_bank(cid)
    b = synthetic.bench_refine_bank(bank.whs[0].cpu().numpy())
    rb = refine_bank_from_numpy(b["fields"], b["win"], device)
    K, vp, vc = (torch.from_numpy(b[n]).to(device) for n in ("K", "verify_pts", "verify_colors"))
    images = torch.from_numpy(rgb).to(device), torch.from_numpy(dep.astype(np.int32)).to(device)
    return images, (bank, det.cfg), (rb, b["icp"], K, b["max_refine"], vp, vc)


def test_detect_refine_core_on_card_equals_cpu(cuda):
    """A cut bench workload (8 templates) with bench.py's refine stage at
    VGA, thresholds 75 and 30; the refine kernel ran."""
    from sixdpose_tpu_torch.models.pipeline import detect_refine_core

    gpu, cpu = _bench_refine(cuda), _bench_refine(torch.device("cpu"))
    before = LR.similarity_local_sparse_cuda.launches
    for thr in (75.0, 30.0):
        g = detect_refine_core(*gpu[0], *gpu[1], thr, *gpu[2])
        c = detect_refine_core(*cpu[0], *cpu[1], thr, *cpu[2])
        assert all(torch.equal(a.cpu(), b) for a, b in zip((g[0], g[1], g[2], g[3], g[8]), (c[0], c[1], c[2], c[3], c[8])))
        assert _close((g[4], g[5], g[6], g[7]), (c[4], c[5], c[6], c[7]), (1e-4, 0.1, 2.0 / 512, 2.0 / 512))
    assert bool(c[8].all())  # 8 active at threshold 30
    assert LR.similarity_local_sparse_cuda.launches == before + 2


def test_detect_refine_core_waits_for_nothing(cuda):
    """Nothing in a fused frame waits for the device: every synchronizing
    CUDA call raises in this mode."""
    from sixdpose_tpu_torch.models.pipeline import detect_refine_core

    gpu = _bench_refine(cuda)
    detect_refine_core(*gpu[0], *gpu[1], 30.0, *gpu[2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = detect_refine_core(*gpu[0], *gpu[1], 30.0, *gpu[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(out[8].cpu().all())


# -- every class of a bank (models/multiclass.py, the coarse scorer) ---------
#
# The matcher and the coarse scorer compare exactly; the fused multi-class
# frame as the fused frame above.


def test_matmul_scorer_on_card_equals_cpu_and_dense(cuda):
    """The coarse scorer on the card (the kernel) equals its plain version
    on the CPU at several scales, one of them 0; at scale 1 the conv of the
    kernels built from the same features gives the same integers."""
    from sixdpose_tpu_torch.ops import similarity as TS

    rng = np.random.default_rng(7)
    maps = rng.integers(0, 5, (16, 120, 160)).astype(np.uint8)
    feats = np.stack([rng.integers(0, 30, (300, 32)), rng.integers(0, 30, (300, 32)), rng.integers(0, 16, (300, 32))], -1)
    feats = feats.astype(np.int32)
    valid = rng.random((300, 32)) < 0.9
    scales = np.array([1.0, 0.0, 0.8, 1.2], np.float32)
    out = {}
    for device in (cuda, torch.device("cpu")):
        args = [torch.from_numpy(a).to(device) for a in (maps, feats, valid, scales)]
        out[device.type] = TS.similarity_multiscale_auto(*args, 8, 28, 28)
    assert torch.equal(out["cuda"][0].cpu(), out["cpu"][0]) and torch.equal(out["cuda"][1].cpu(), out["cpu"][1])
    kern = torch.from_numpy(TS.build_template_kernels(feats, valid, 28, 28, 16)).to(cuda)
    dense = TS.similarity_dense(torch.from_numpy(maps).to(cuda), kern, 8)
    assert torch.equal(out["cuda"][0][:300], dense)
    assert not out["cuda"][0][300:600].any() and not out["cuda"][1][300:600].any()



# The coarse-scorer kernel (csrc/coarse_score.cu) against its plain version
# and the dense conv: exact, integer sums in float32.


@pytest.mark.parametrize("name", EDGE_CASES)
def test_coarse_kernel_equals_matmul_and_plain(cuda, name):
    """At each edge case of ``tests/coarse_cases.py`` (zero scales, .5
    ties, the extent's border, F = 1 and 8191, B = 1 and 4, padded maps,
    the T-LESS coarse map shape) the kernel's raw sums and counts equal the
    plain version on the CPU and on the card, in one launch, and at each
    scale above 0 the dense conv of kernels built from the features at that
    scale."""
    from sixdpose_tpu_torch.ops import coarse_score as CS
    from sixdpose_tpu_torch.ops import similarity as TS

    maps, feats, valid, scales, t, kh, kw = edge_case(name)
    cpu = [torch.from_numpy(a) for a in (maps, feats, valid, scales)]
    gpu = [a.to(cuda) for a in cpu]
    before = CS.similarity_multiscale_cuda.launches
    raw, nf = TS.similarity_multiscale_auto(*gpu, t, kh, kw)
    torch.cuda.synchronize()
    assert CS.similarity_multiscale_cuda.launches == before + 1
    want = TS.similarity_multiscale_auto(*cpu, t, kh, kw)
    plain = TS.similarity_multiscale_sparse(*gpu, t, kh, kw)
    assert raw.dtype == torch.float32 and nf.dtype == torch.int32 and raw.shape == want[0].shape
    assert torch.equal(raw.cpu(), want[0]) and torch.equal(nf.cpu(), want[1])
    assert torch.equal(raw, plain[0]) and torch.equal(nf, plain[1])
    n = feats.shape[0]
    for s, sc in enumerate(scales.tolist()):
        if sc > 0:
            kern = TS.build_kernels_scaled(gpu[1], gpu[2], sc, kh, kw, maps.shape[-3])
            assert torch.equal(raw[..., s * n : (s + 1) * n, :, :], TS.similarity_dense(gpu[0], kern, t)), sc


@pytest.mark.parametrize("name", ["tless", "linemod"])
def test_coarse_kernel_at_the_cells_shapes(cuda, name):
    """At the benchmark cells' coarse shapes the kernel equals the plain
    gather-sum on the card, raw and counts."""
    from sixdpose_tpu_torch.ops import similarity as TS

    call = synthetic.coarse_scorer_call(name)
    args = [torch.from_numpy(a).to(cuda) for a in call[:4]] + list(call[4:])
    raw, nf = TS.similarity_multiscale_auto(*args)
    plain = TS.similarity_multiscale_sparse(*args)
    assert torch.equal(raw, plain[0]) and torch.equal(nf, plain[1])


def test_coarse_kernel_runs_once_a_frame(cuda):
    """A frame of the multi-class matcher (a small feature-list superbank)
    and of the multi-scale matcher launches the coarse kernel once, and no
    ``addmm`` runs inside its ``coarse`` stage."""
    from torch.profiler import ProfilerActivity, profile

    from sixdpose_tpu_torch.models.multiclass import MultiClassMatcher
    from sixdpose_tpu_torch.models.multiscale import MultiScaleMultiClass
    from sixdpose_tpu_torch.ops import coarse_score as CS

    w, det = _multiclass(cuda)
    mc = MultiClassMatcher(det, device=cuda)
    w_ms = synthetic.multiscale_workload(classes=3, views=24)
    ms = MultiScaleMultiClass(synthetic.multiscale_detector(w_ms, cuda), w_ms["train_depth"], device=cuda,
                              num_scales=w_ms["num_scales"])
    frames = [lambda: mc.match_arrays(w["rgb"], w["depth"], 30.0), lambda: ms.match_arrays(w_ms["rgb"], w_ms["depth"], 30.0)]
    for frame in frames:
        frame()
    torch.cuda.synchronize()
    before = CS.similarity_multiscale_cuda.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for frame in frames:
            frame()
        torch.cuda.synchronize()
    assert CS.similarity_multiscale_cuda.launches == before + 2
    coarse = [e.time_range for e in prof.events() if e.name == "sixdpose.coarse"]
    assert len(coarse) == 2
    inside = [e.name for e in prof.events() if e.name in ("aten::addmm", "aten::mm", "aten::matmul")
              and any(r.start <= e.time_range.start <= r.end for r in coarse)]
    assert not inside, inside


def _multiclass(device, classes=3, views=40):
    w = synthetic.multiclass_workload(classes=classes, views=views)
    return w, synthetic.multiclass_detector(w, device)


@pytest.mark.parametrize("dense_twin", [False, True])
def test_multiclass_matcher_on_card_equals_cpu(cuda, dense_twin):
    """A cut synthetic multi-class workload (3 classes x 40 views, 320 x 240):
    the card's result equals the port's CPU run everywhere, with the
    feature-list superbank (one refine kernel launch per frame for every
    class) and with its ``without_features()`` twin (the dense conv and
    the grouped conv: no refine kernel launch)."""
    from sixdpose_tpu_torch.models.multiclass import MultiClassMatcher

    w, det = _multiclass(cuda)
    gpu, cpu = MultiClassMatcher(det, device=cuda), MultiClassMatcher(det, device="cpu")
    if dense_twin:
        gpu.bank, cpu.bank = gpu.bank.without_features(), cpu.bank.without_features()
    before = LR.similarity_local_sparse_cuda.launches
    for thr in (55.0, 30.0):
        g = gpu.match_arrays(w["rgb"], w["depth"], thr)
        assert _same(g, cpu.match_arrays(w["rgb"], w["depth"], thr))
    assert bool((g[3] >= 0).all())  # every class fills its 128 slots at 30
    assert LR.similarity_local_sparse_cuda.launches == before + (0 if dense_twin else 2)
    key = lambda m: (m.class_id, m.template_id, m.x, m.y, m.similarity)  # noqa: E731
    assert [key(m) for m in gpu.match(w["rgb"], w["depth"], 30.0)] == [key(m) for m in cpu.match(w["rgb"], w["depth"], 30.0)]


def test_fused_multiclass_on_card_equals_cpu_and_waits_for_nothing(cuda):
    """The cut workload through FusedMultiClassPipeline with the synthetic
    benchmark's refine settings (8 hypotheses per class here): the card
    equals the CPU at 55 and 30, and a frame runs with every synchronizing
    call raising."""
    from sixdpose_tpu_torch.models.pipeline import FusedMultiClassPipeline

    w, det = _multiclass(cuda)
    args = dict(synthetic.multiclass_pipeline_args(w), max_refine=8)
    gpu = FusedMultiClassPipeline(det, w["K"], device=cuda, **args)
    cpu = FusedMultiClassPipeline(det, w["K"], device="cpu", **args)
    for thr in (55.0, 30.0):
        g, c = gpu(w["rgb"], w["depth"], thr), cpu(w["rgb"], w["depth"], thr)
        assert all(torch.equal(a.cpu(), b) for a, b in zip((g[0], g[1], g[2], g[3], g[8]), (c[0], c[1], c[2], c[3], c[8])))
        assert _close((g[4], g[5], g[6], g[7]), (c[4], c[5], c[6], c[7]), (1e-4, 0.1, 2.0 / 512, 2.0 / 512))
    assert bool(c[8].all())  # 3 x 8 active at threshold 30
    rgb, dep = torch.from_numpy(w["rgb"]).to(cuda), torch.from_numpy(w["depth"].astype(np.int32)).to(cuda)
    gpu(rgb, dep, 30.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gpu(rgb, dep, 30.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out[4].cpu(), g[4].cpu())


# -- multi-scale matching (models/multiscale.py) ------------------------------
#
# Exact: every score is a sum of small integers in float32.


def test_multiscale_on_card_equals_cpu_and_waits_for_nothing(cuda):
    """A cut multi-scale workload (3 classes x 24 templates, VGA, 5
    proposals): MultiScaleMultiClass and MultiScaleDetector on the card
    equal their CPU runs everywhere at 70 and 30, one scaled refine launch
    per frame, and a frame runs with every synchronizing call raising."""
    from sixdpose_tpu_torch.models.multiscale import MultiScaleDetector, MultiScaleMultiClass

    w = synthetic.multiscale_workload(classes=3, views=24)
    det = synthetic.multiscale_detector(w, cuda)
    kw = dict(num_scales=w["num_scales"])
    gpu = MultiScaleMultiClass(det, w["train_depth"], device=cuda, **kw)
    cpu = MultiScaleMultiClass(det, w["train_depth"], device="cpu", **kw)
    one = MultiScaleDetector(det, w["train_depth"], device=cuda, **kw)
    one_cpu = MultiScaleDetector(det, w["train_depth"], device="cpu", **kw)
    before = LR.similarity_local_sparse_cuda.launches
    for thr in (70.0, 30.0):
        g = gpu.match_arrays(w["rgb"], w["depth"], thr)
        assert _same(g, cpu.match_arrays(w["rgb"], w["depth"], thr))
        assert _same(one.match_arrays(w["rgb"], w["depth"], thr, "obj_01"),
                     one_cpu.match_arrays(w["rgb"], w["depth"], thr, "obj_01"))
    assert bool((g[3] >= 0).all())  # every class fills its 128 slots at 30
    assert LR.similarity_local_sparse_cuda.launches == before + 4
    rgb, dep = torch.from_numpy(w["rgb"]).to(cuda), torch.from_numpy(w["depth"].astype(np.int32)).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gpu.match_arrays(rgb, dep, 30.0)
        single = one.match_arrays(rgb, dep, 30.0, "obj_01")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _same(out, g) and bool((single[3] >= 0).any())


# -- rendering, the service and the synthetic benchmark -----------------------
#
# The rasterizer's arithmetic has a fixed order on every device: the card's
# renders equal the CPU's to the bit.  The service's estimates go through
# ICP: within FUSED_TOL of the CPU run (so far equal).


def _synth_golden():
    import json

    g = np.load(os.path.join(TESTDATA, "synth_golden.npz"))
    return g, json.loads(str(g["settings"]))


def test_render_on_card_equals_cpu_and_waits_for_nothing(cuda):
    """Every benchmark mesh in all three modes of ``render``, and a batch of
    poses through the training renderer, bitwise; the JAX golden's renders;
    a batch with every synchronizing call raising."""
    from sixdpose_tpu_torch import benchmark as TB
    from sixdpose_tpu_torch.geometry import render as GR
    from sixdpose_tpu_torch.geometry.transform import random_rotation

    g, _ = _synth_golden()
    K, size = g["render_K"], tuple(int(v) for v in g["render_size"])
    models = TB.make_models()
    for i, (cid, m) in enumerate((c, m) for c, m in models.items() for _ in range(2)):
        R, t = g["render_R"][i], g["render_t"][i]
        for mode in ("depth", "rgb+depth", "rgb"):
            card = GR.render(dict(m), size, K, R, t, mode=mode, texture=m.get("texture"), device=cuda)
            cpu = GR.render(dict(m), size, K, R, t, mode=mode, texture=m.get("texture"), device="cpu")
            card, cpu = (card, cpu) if isinstance(card, tuple) else ((card,), (cpu,))
            assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)), (cid, mode)
        rgb, depth = GR.render(dict(m), size, K, R, t, mode="rgb+depth", device=cuda)
        assert np.array_equal(depth.cpu().numpy(), g["render_depth"][i]) and np.array_equal(rgb.cpu().numpy(), g["render_rgb"][i])
    rng = np.random.default_rng(1)
    m = models["texbox"]
    pts, faces, uv = GR.subdivide_mesh(m["pts"], m["faces"], 10.0, np.asarray(m["texture_uv"], np.float64))
    Rs = np.stack([random_rotation(rng) for _ in range(8)]).astype(np.float32)
    ts = np.tile(np.array([[0.0, 0.0, 450.0]], np.float32), (8, 1))
    out = {}
    for device in (cuda, "cpu"):
        up = lambda a, d=np.float32: torch.from_numpy(np.ascontiguousarray(np.asarray(a, d))).to(device)  # noqa: E731
        args = (up(pts), up(faces, np.int64), up(uv), up(m["texture"] / 255.0), up(K), up(Rs), up(ts), (96, 72))
        out[str(device)] = args, GR.render_textured(*args)
    (args, (rgb_g, dep_g)), (_, (rgb_c, dep_c)) = out[str(cuda)], out["cpu"]
    assert torch.equal(rgb_g.cpu(), rgb_c) and torch.equal(dep_g.cpu(), dep_c)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rgb_again, _ = GR.render_textured(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(rgb_again, rgb_g)


def test_service_on_card_matches_cpu_and_the_jax_golden(cuda):
    """The golden's scenes through ``PoseEstimationService`` on the card:
    the same published estimates as the CPU run and the JAX golden (ints
    exactly, R 1e-4, t 0.1 mm, fitness and verify 0.01), one refine kernel
    launch per frame."""
    import json

    from sixdpose_tpu_torch import benchmark as TB
    from sixdpose_tpu_torch.config import IcpConfig
    from sixdpose_tpu_torch.serving import PoseEstimationService

    g, settings = _synth_golden()
    svc = json.loads(str(g["service"]))
    models = {c: TB.make_models()[c] for c in settings["object_ids"]}
    services = {}
    for device in (cuda, "cpu"):
        det = Detector.read_classes(os.path.join(TESTDATA, "synth_bank.npz"), TB.benchmark_config(settings["top_k"]),
                                    device=device)
        services[str(device)] = PoseEstimationService(
            det, models, TB.benchmark_K(tuple(settings["im_size"])), threshold=svc["threshold"],
            max_refine=svc["max_refine"], icp=IcpConfig(max_iters=svc["icp_max_iters"]), min_fitness=svc["min_fitness"],
            icp_seeds=svc["icp_seeds"], verify_tau=svc["verify_tau"], seed_flip=svc["seed_flip"], device=device)
    before = LR.similarity_local_sparse_cuda.launches
    for i in range(settings["num_scenes"]):
        card = services[str(cuda)].process_frame(g["rgb"][i], g["depth"][i])
        cpu = services["cpu"].process_frame(g["rgb"][i], g["depth"][i])
        assert len(card) == len(cpu) == int(g["est_n"][i])
        for j, (a, b) in enumerate(zip(card, cpu)):
            assert (a.class_id, a.template_id, a.x, a.y, a.similarity) == (b.class_id, b.template_id, b.x, b.y, b.similarity)
            assert a.class_id == str(g["est_class"][i, j]) and a.template_id == g["est_template_id"][i, j]
            assert np.abs(a.R - b.R).max() <= 1e-4 and np.abs(a.t - b.t).max() <= 0.1
            assert np.abs(a.R - g["est_R"][i, j]).max() <= 1e-4 and np.abs(a.t.ravel() - g["est_t"][i, j]).max() <= 0.1
            assert abs(a.fitness - b.fitness) <= 0.01 and abs(a.verify - b.verify) <= 0.01
    assert LR.similarity_local_sparse_cuda.launches == before + settings["num_scenes"]


def test_run_benchmark_on_card_matches_jax_golden(cuda, tmp_path):
    """``run_benchmark`` on the card at the golden's cut size, over the
    JAX-trained bank: JAX's targets, hits, VSD hits and per-object recall."""
    import json
    import shutil

    from sixdpose_tpu_torch import benchmark as TB

    g, settings = _synth_golden()
    cache = str(tmp_path / "bank.npz")
    shutil.copy(os.path.join(TESTDATA, "synth_bank.npz"), cache)
    shutil.copy(os.path.join(TESTDATA, "synth_bank.npz.meta.json"), cache + ".meta.json")
    got = TB.run_benchmark(bank_cache=cache, verbose=False, device=cuda, **settings)
    want = json.loads(str(g["result"]))
    assert {k: got[k] for k in ("targets", "hits", "hits_vsd", "per_object")} == {
        k: want[k] for k in ("targets", "hits", "hits_vsd", "per_object")}
    assert got["device_ms_per_frame"] > 0


# -- the segmentation path: ordered segment sums, seeding, DASP, registration --


@pytest.mark.parametrize("n,c,s", [(1000, 13, 40), (4097, 3, 1), (513, 7, 300), (0, 2, 5), (100, 1, 0)])
def test_segment_sum_kernel_matches_plain(cuda, n, c, s):
    """The kernel equals its plain version to the bit (ids out of range
    dropped; empty segments, one segment, no rows, no segments)."""
    from sixdpose_tpu_torch.ops import segment_sum as SS

    rng = np.random.default_rng(n + s)
    vals = torch.from_numpy(rng.normal(0, 3, (n, c)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(-2, s + 2, n).astype(np.int32))
    if s > 3:
        seg[seg == 3] = 4  # segment 3 stays empty
    want = SS.segment_sum(vals, seg, s)
    before = SS.segment_sum.launches
    got = SS.segment_sum(vals.to(cuda), seg.to(cuda), s)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert SS.segment_sum.launches == before + (1 if s * c else 0)


@pytest.mark.parametrize("h,w,scale", [(1, 1, 0.7), (1, 9, 0.4), (7, 1, 0.9), (37, 51, 0.05), (120, 161, 0.3),
                                       (480, 640, 0.01)])
def test_floyd_steinberg_kernel_matches_plain(cuda, h, w, scale):
    """The one-thread scan equals the host scan: the same seeds in order."""
    from sixdpose_tpu_torch.ops import floyd_steinberg as FS

    density = torch.from_numpy((np.random.default_rng(h * w).random((h, w)) * scale).astype(np.float32))
    want = FS.floyd_steinberg(density)
    before = FS.floyd_steinberg.launches
    got = FS.floyd_steinberg(density.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert FS.floyd_steinberg.launches == before + 1



def _segment_case(name):
    """Edge cases of the segment-sum kernel: (vals (N, C), ids, S)."""
    rng = np.random.default_rng(len(name))
    n, c, s = {"one_segment_every_row": (60_000, 13, 1), "c1": (5000, 1, 64), "c13_vga": (307_200, 13, 640),
               "rows_not_a_tile_multiple": (8 * 1024 + 1, 13, 77), "short": (31, 3, 5),
               "every_id_out_of_range": (3000, 13, 40), "s_above_1024": (20_000, 13, 3000),
               "s_past_48kb_of_counters": (50_000, 2, 20_000), "s_at_the_limit": (70_000, 1, 58_112)}[name]
    vals = (rng.normal(0, 1, (n, c)) * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)
    if name == "one_segment_every_row":
        ids = np.zeros(n, np.int64)
    elif name == "every_id_out_of_range":
        ids = np.where(rng.random(n) < 0.5, -1 - rng.integers(0, 5, n), s + rng.integers(0, 5, n))
    elif name == "c13_vga":  # superpixel-like: runs of one id along image rows
        ids = np.repeat(rng.integers(-1, s + 1, n // 40), 40)
    else:
        ids = rng.integers(-1, s + 1, n)
    return torch.from_numpy(vals), torch.from_numpy(ids.astype(np.int32 if c == 1 else np.int64)), s


SEGMENT_CASES = ["one_segment_every_row", "c1", "c13_vga", "rows_not_a_tile_multiple", "short",
                 "every_id_out_of_range", "s_above_1024", "s_past_48kb_of_counters", "s_at_the_limit"]


@pytest.mark.parametrize("name", SEGMENT_CASES)
def test_segment_sum_kernel_edge_cases(cuda, name):
    """The kernel equals its plain version to the bit at the longest chain
    (one segment holding every row), C = 1 and 13, row counts that are not
    a multiple of the layout's tile, every id out of range, and S above
    1,024 (counters beyond 48 KB of shared memory, and at the limit)."""
    from sixdpose_tpu_torch.ops import segment_sum as SS

    vals, ids, s = _segment_case(name)
    want = SS.segment_sum(vals, ids, s)
    got = SS.segment_sum(vals.to(cuda), ids.to(cuda), s)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", SEGMENT_CASES)
def test_segment_layout_kernel_matches_csr_layout(cuda, name):
    """The card's counting sort gives the plain layout's kept rows, in the
    same (stable) order, and its segment starts."""
    from sixdpose_tpu_torch.ops import segment_sum as SS

    _, ids, s = _segment_case(name)
    order, starts, counts = SS.csr_layout(ids, s)
    got_order, got_starts = SS.segment_layout(ids.to(cuda), s)
    kept = int(counts.sum())
    assert int(got_starts[-1]) == kept
    assert torch.equal(got_order[:kept].cpu().to(torch.int64), order[:kept])
    assert torch.equal(got_starts[:-1].cpu().to(torch.int64), starts)


def test_segment_sum_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from sixdpose_tpu_torch.ops import segment_sum as SS

    vals = torch.zeros((10, 3), device=cuda)
    ids = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        SS.segment_sum(vals, ids, SS.MAX_SEGMENTS + 1)
    with pytest.raises(ValueError):
        SS.segment_sum(torch.zeros((10, SS.MAX_CHANNELS + 1), device=cuda), ids, 4)
    with pytest.raises(TypeError):
        SS.segment_sum(vals, ids.to(torch.int16), 4)


@pytest.mark.parametrize("h,w,scale", [(64, 80, 0.95), (1, 700, 0.95), (33, 47, 1.0), (5, 301, 0.02),
                                       (9, 1, 0.6), (3, 7175, 0.05)])
def test_floyd_steinberg_kernel_edge_cases(cuda, h, w, scale):
    """Dense seeds (most pixels at or above one half), H = 1 and W = 1, odd
    heights, and the widest width the kernel's shared memory holds."""
    from sixdpose_tpu_torch.ops import floyd_steinberg as FS

    assert w <= FS.MAX_WIDTH
    density = torch.from_numpy((np.random.default_rng(h + w).random((h, w)) * scale).astype(np.float32))
    want = FS.floyd_steinberg(density)
    got = FS.floyd_steinberg(density.to(cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("h,w", [(4, 32), (5, 33), (6, 64), (3, 1)])
def test_floyd_steinberg_kernel_values_exactly_one_half(cuda, h, w):
    """A density of exactly 0.5 (and 0.25 beside it): every comparison with
    0.5 meets equality somewhere, at word and row boundaries."""
    from sixdpose_tpu_torch.ops import floyd_steinberg as FS

    density = np.full((h, w), 0.5, np.float32)
    density[1::2, ::3] = 0.25
    density = torch.from_numpy(density)
    want = FS.floyd_steinberg(density)
    got = FS.floyd_steinberg(density.to(cuda))
    assert torch.equal(got.cpu(), want) and len(want) > 0


def test_floyd_steinberg_rejects_too_wide_and_chain_probe_runs(cuda):
    from sixdpose_tpu_torch.ops import floyd_steinberg as FS

    with pytest.raises(ValueError):
        FS.floyd_steinberg(torch.zeros((2, FS.MAX_WIDTH + 1), device=cuda))
    out = FS.chain_probe(1000, cuda, 0.3).cpu().numpy()
    carry, seeds = 0.0, 0
    for _ in range(1000):  # the chain in Python floats (IEEE doubles)
        v = 0.3 + carry
        seeds += v >= 0.5
        carry = (v - 1.0 if v >= 0.5 else v) * 0.4375
    assert out[0] == carry and out[1] == seeds

def _seg_scene():
    """Two flat boxes on a tilted ground plane, 160x120, f=200."""
    h, w = 120, 160
    yy = np.mgrid[0:h, 0:w][0]
    depth = (900 + (h - yy) * 3).astype(np.uint16)
    depth[40:80, 20:60] = 700
    depth[30:70, 95:135] = 800
    rgb = np.full((h, w, 3), 120, np.uint8)
    rgb[40:80, 20:60] = (200, 60, 60)
    rgb[30:70, 95:135] = (60, 200, 60)
    return rgb, depth, np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])


def test_convex_cloud_seg_on_card_equals_cpu(cuda):
    from sixdpose_tpu_torch.ops import floyd_steinberg as FS
    from sixdpose_tpu_torch.ops import segment_sum as SS
    from sixdpose_tpu_torch.seg import DaspConfig, convex_cloud_seg, superpixel_stage

    rgb, depth, K = _seg_scene()
    cfg = DaspConfig(focal_px=200.0, cx=80, cy=60, radius=0.03)
    card = superpixel_stage(rgb, depth, cfg, device=cuda)
    cpu = superpixel_stage(rgb, depth, cfg, device="cpu")
    for k in card[0]:
        assert torch.equal(card[0][k].cpu(), cpu[0][k]), k
    assert torch.equal(card[1].cpu(), cpu[1]) and torch.equal(card[2].cpu(), cpu[2])
    for k in card[3]:
        assert torch.equal(card[3][k].cpu(), cpu[3][k]), k
    before = (FS.floyd_steinberg.launches, SS.segment_sum.launches)
    seg_card = convex_cloud_seg(rgb, depth, K, cfg, device=cuda)
    assert (FS.floyd_steinberg.launches, SS.segment_sum.launches) == (before[0] + 1, before[1] + cfg.iterations)
    seg_cpu = convex_cloud_seg(rgb, depth, K, cfg, device="cpu")
    for a, b in zip(seg_card, seg_cpu):
        assert np.array_equal(a, b)


def test_pose_estimation_on_card_equals_cpu(cuda):
    from sixdpose_tpu_torch.geometry.transform import rotation_matrix
    from sixdpose_tpu_torch.seg import pose_estimation

    rng = np.random.default_rng(0)
    base = rng.uniform(0, 40, (400, 3))
    base[:200, 2] = 0
    base[200:, 0] = 0
    scene = base @ rotation_matrix(0.6, [0.2, 1, 0.3])[:3, :3].T + np.array([30.0, -20.0, 55.0])
    for kw in (dict(delta=2.0, num_hyp=2048, seed=1), dict(delta=4.0, method="4pcs", min_lcp=0.2, seed=3)):
        T_card, lcp_card = pose_estimation(scene, base, device=cuda, **kw)
        T_cpu, lcp_cpu = pose_estimation(scene, base, device="cpu", **kw)
        assert lcp_card == lcp_cpu and np.array_equal(T_card, T_cpu), kw


def test_slic_and_asp_on_card_equal_cpu(cuda):
    from sixdpose_tpu_torch.seg import superpixels_asp, superpixels_slic

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)
    density = np.full((64, 96), 6.0 / (64 * 96), np.float32)
    density[:, 48:] *= 8
    for fn, args in ((superpixels_slic, (rgb, 24)), (superpixels_asp, (rgb, density))):
        a, sa = fn(*args, device=cuda)
        b, sb = fn(*args, device="cpu")
        assert np.array_equal(a, b)
        for k in sa:
            assert np.array_equal(sa[k], sb[k]), k


# -- multi-device matching (parallel/) ----------------------------------------------


def _parallel_case(n_templates=12):
    from sixdpose_tpu_torch.models.detector import Detector as TDetector

    cid, templates, rgb, dep = synthetic.bench_bank(num_templates=n_templates)
    det = TDetector(DetectorConfig(t_at_level=(5, 8)), device="cpu")
    for tl in templates:
        det.bank.add_template_levels(cid, tl)
    frames = np.stack([rgb ^ np.uint8(i) for i in range(4)])
    return cid, det, frames, np.stack([dep] * 4)


def test_nccl_mesh_of_one_equals_match_batch(cuda):
    """Mesh (1, 1, 1), one rank over NCCL: ``sharded_detect`` equals
    ``Detector.match_batch_arrays`` on the card, and launches the kernel."""
    from sixdpose_tpu_torch.parallel.distributed import backend_for, run_ranks
    from sixdpose_tpu_torch.parallel.rank_jobs import run_jobs

    cid, det, frames, depths = _parallel_case()
    job = dict(kind="sharded", mesh=(1, 1, 1), levels=det.bank.finalized(cid), rgb=frames, depth=depths,
               cfg=det.cfg, threshold=30.0)
    assert backend_for("cuda", 1) == "nccl"
    (res,) = run_ranks(run_jobs, 1, ("cuda", [job]), device_type="cuda", timeout=300)[0]
    card = Detector(det.cfg, device=cuda)
    card.bank = det.bank
    ref = card.match_batch_arrays(frames, depths, 30.0, cid)
    for a, b in zip(res["outputs"], ref):
        np.testing.assert_array_equal(a, b.cpu().numpy())
    assert res["launches"] > 0


def test_ranks_sharing_the_card_equal_cpu_ranks(cuda):
    """Four ranks on the one card over gloo against four CPU ranks, to the
    bit."""
    from sixdpose_tpu_torch.parallel.distributed import run_ranks
    from sixdpose_tpu_torch.parallel.rank_jobs import run_jobs

    cid, det, frames, depths = _parallel_case()
    levels = det.bank.finalized(cid)
    jobs = [dict(kind="sharded", mesh=(2, 2, 1), levels=levels, rgb=frames, depth=depths, cfg=det.cfg, threshold=30.0),
            dict(kind="tiled", mesh=(1, 1, 2), levels=levels, rgb=frames[0], depth=depths[0], cfg=det.cfg,
                 threshold=30.0)]
    card = run_ranks(run_jobs, 4, ("cuda", jobs), device_type="cuda", timeout=300)
    cpu = run_ranks(run_jobs, 4, ("cpu", jobs), device_type="cpu", timeout=300)
    for i in range(len(jobs)):
        for r in range(4):
            if card[r][i] is None:
                assert cpu[r][i] is None
                continue
            assert card[r][i]["launches"] > 0
            for a, b in zip(card[r][i]["outputs"], cpu[r][i]["outputs"]):
                np.testing.assert_array_equal(a, b)


def test_fused_frames_over_data_equal_the_single_process_card(cuda):
    """``fused_mc`` and ``fused_ms`` at data 2 on two ranks sharing the card:
    each rank's frames equal ``FusedMultiClassPipeline`` and
    ``MultiScaleMultiClass`` on the card, to the bit, and every rank
    launches the kernel."""
    from sixdpose_tpu_torch.models.multiscale import MultiScaleMultiClass
    from sixdpose_tpu_torch.models.pipeline import FusedMultiClassPipeline
    from sixdpose_tpu_torch.parallel.distributed import run_ranks
    from sixdpose_tpu_torch.parallel.rank_jobs import run_jobs

    w_mc = synthetic.multiclass_workload(classes=3, views=40)
    w_ms = synthetic.multiscale_workload(classes=3, views=40)
    frames = {k: [f(s) for s in (1, 2)] for k, f in (("mc", synthetic.multiclass_frame),
                                                     ("ms", synthetic.multiscale_frame))}
    jobs = [dict(kind="fused_mc", mesh=(2, 1, 1), class_ids=w_mc["class_ids"], templates=w_mc["templates"],
                 infos=w_mc["infos"], K=w_mc["K"], pipeline=synthetic.multiclass_pipeline_args(w_mc),
                 rgb=np.stack([f[0] for f in frames["mc"]]), depth=np.stack([f[1] for f in frames["mc"]]),
                 cfg=w_mc["cfg"], threshold=30.0),
            dict(kind="fused_ms", mesh=(2, 1, 1), class_ids=w_ms["class_ids"], templates=w_ms["templates"],
                 train_depth=w_ms["train_depth"], num_scales=w_ms["num_scales"],
                 rgb=np.stack([f[0] for f in frames["ms"]]), depth=np.stack([f[1] for f in frames["ms"]]),
                 cfg=w_ms["cfg"], threshold=30.0)]
    res = run_ranks(run_jobs, 2, ("cuda", jobs), device_type="cuda", timeout=300)
    pipe = FusedMultiClassPipeline(synthetic.multiclass_detector(w_mc, cuda), w_mc["K"], device=cuda,
                                   **synthetic.multiclass_pipeline_args(w_mc))
    ms = MultiScaleMultiClass(synthetic.multiscale_detector(w_ms, cuda), w_ms["train_depth"],
                              num_scales=w_ms["num_scales"], device=cuda)
    for i, (job, run) in enumerate(zip(jobs, (pipe, ms.match_arrays))):
        for f, (rgb, dep) in enumerate(zip(job["rgb"], job["depth"])):
            want = run(rgb, dep, 30.0)
            for r in range(2):
                assert res[r][i]["launches"] > 0
                for a, b in zip(res[r][i]["outputs"], want):
                    np.testing.assert_array_equal(a[f], b.cpu().numpy())


# -- the bank checkpoint and the measurement twins -----------------------------------


def _checkpoint_rank(rank, world, path, cid, cfg):
    """On a card rank of mesh (2, 2, 1): ``load_checkpoint`` onto the mesh
    and this rank's ``restore_local_bank``, as numpy, with their devices."""
    from sixdpose_tpu_torch.models.templates import TemplateBank
    from sixdpose_tpu_torch.parallel import make_mesh
    from sixdpose_tpu_torch.parallel.mesh import rank_device
    from sixdpose_tpu_torch.parallel.sharded_match import restore_local_bank

    mesh = make_mesh(2, 2, 1)
    full = TemplateBank.load_checkpoint(path, cfg, mesh)
    bank = restore_local_bank(mesh, path, cid, cfg, rank_device("cuda", rank))
    return {"coordinate": tuple(mesh.get_coordinate()),
            "templates": [[(lv.features, lv.width, lv.height) for lv in t] for t in full.templates[cid]],
            "shard_device": full.shards[cid]["feats"].to_local().device.type,
            "bank_device": bank.nfeats[0].device.type, "bank_kdims": bank.kdims, "bank_kernels": bank.kernels,
            "bank": [[t.cpu().numpy() for t in getattr(bank, f)] for f in ("nfeats", "whs", "feats", "valids")]}


def test_checkpoint_restores_onto_the_card_as_on_the_cpu(cuda, tmp_path):
    """Four ranks sharing the card over gloo: the mesh load's shards and each
    rank's restored bank lie on the card and equal the CPU restore
    (``shard_bank`` of the saved bank, to the bit); the checkpoint job of
    ``run_jobs`` equals its ``levels`` job, one refine launch a level."""
    from sixdpose_tpu_torch.parallel.distributed import run_ranks
    from sixdpose_tpu_torch.parallel.rank_jobs import run_jobs
    from sixdpose_tpu_torch.parallel.sharded_match import shard_bank

    cid, det, frames, depths = _parallel_case(n_templates=13)  # 13 over template 2 splits 7 / 6
    path = str(tmp_path / "ckpt")
    det.bank.save_checkpoint(path)
    levels = det.bank.finalized(cid)
    for res in run_ranks(_checkpoint_rank, 4, (path, cid, det.cfg), device_type="cuda", timeout=300):
        assert res["shard_device"] == res["bank_device"] == "cuda"
        assert len(res["templates"]) == 13
        for t, got in zip(det.bank.templates[cid], res["templates"]):
            assert all(np.array_equal(a.features, f) and (a.width, a.height) == (w, h) for a, (f, w, h) in zip(t, got))
        want = shard_bank(levels, 2, res["coordinate"][1], "cpu")
        assert res["bank_kernels"] is None and res["bank_kdims"] == want.kdims
        for f, got in zip(("nfeats", "whs", "feats", "valids"), res["bank"]):
            for a, b in zip(got, getattr(want, f)):
                np.testing.assert_array_equal(a, b.numpy())
    common = dict(mesh=(2, 2, 1), rgb=frames, depth=depths, cfg=det.cfg, threshold=30.0)
    jobs = [dict(kind="sharded", levels=levels, **common), dict(kind="sharded", checkpoint=path, class_id=cid, **common)]
    for r, (by_levels, by_checkpoint) in enumerate(run_ranks(run_jobs, 4, ("cuda", jobs), device_type="cuda",
                                                             timeout=300)):
        assert by_checkpoint["launches"] == len(det.cfg.t_at_level) - 1, r
        for a, b in zip(by_checkpoint["outputs"], by_levels["outputs"]):
            np.testing.assert_array_equal(a, b)


def test_local_refine_twin_is_equivalent_on_the_card(cuda):
    """``bench_local_refine`` at the JAX tool's K = 128, F = 254: the kernel
    equals its plain version exactly, and so does the grouped conv."""
    from sixdpose_tpu_torch.tools import bench_local_refine

    before = LR.similarity_local_sparse_cuda.launches
    r = bench_local_refine.report(device=cuda, reps=2)
    assert r["equivalent"] and r["grouped_conv_equal"]
    assert LR.similarity_local_sparse_cuda.launches > before
    assert 0 < r["bound_ms"] < r["kernel_ms"]


def test_bench_twin_chain_on_the_card_equals_the_cpu(cuda, capsys):
    """bench.py's twin: its one-frame match chain and a B = 2 batch chain
    on the card equal the CPU's to the bit on the full bench workload, and
    ``main`` on a cut workload (4 templates of 32 x 32, 120 x 160, short
    chains) streams records that parse, the last with every fps key above 0,
    the card's ``nvidia-smi`` line and the kernel's launches."""
    import json

    from sixdpose_tpu_torch import bench

    cid, templates, rgb, dep = synthetic.bench_bank()
    banks = {}
    for device in (cuda, "cpu"):
        det = Detector(bench.CFG, device=device)
        for tl in templates:
            det.bank.add_template_levels(cid, tl)
        banks[str(device)] = det.device_bank(cid)
    rgb_c, dep_c = torch.from_numpy(rgb), torch.from_numpy(dep.astype(np.int32))
    r_gpu, m_gpu = bench.match_chain(1, rgb_c.to(cuda), dep_c.to(cuda), banks[str(cuda)])
    r_cpu, m_cpu = bench.match_chain(1, rgb_c, dep_c, banks["cpu"])
    assert torch.equal(r_gpu.cpu(), r_cpu)
    for a, b in zip(m_gpu, m_cpu):
        assert torch.equal(a.cpu(), b)
    rgb_b = torch.stack([rgb_c, rgb_c ^ 1])
    dep_b = dep_c.expand(2, -1, -1).contiguous()
    r_gpu, m_gpu = bench.batch_chain(2, rgb_b.to(cuda), dep_b.to(cuda), banks[str(cuda)])
    r_cpu, m_cpu = bench.batch_chain(2, rgb_b, dep_b, banks["cpu"])
    assert torch.equal(r_gpu.cpu(), r_cpu)
    for a, b in zip(m_gpu, m_cpu):
        assert torch.equal(a.cpu(), b)

    capsys.readouterr()
    cut = synthetic.bench_bank(num_templates=4, sizes=(32, 16), features=64, hw=(120, 160))
    assert bench.main(workload=cut, match_chains=(1, 3), refine_chains=(1, 2)) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    last = lines[-1]
    assert len(lines) == 5 and all(last[k] > 0 for k in bench.RECORD_KEYS), last
    assert last["nvidia_smi"] and last["local_refine_launches"] > 0
