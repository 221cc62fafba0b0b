"""Port parity of multi-scale matching against the JAX package, on the CPU:
the multi-scale similarity functions of ops/similarity.py, the scaled
pyramid refinement, models/multiscale.py (both matcher classes, against
the JAX programs on both of their coarse routes: tables prebuilt per depth
bin and the per-frame scatter build) and the planted multi-scale golden.

Everything compared is integer or exact float32, so every comparison is
exact.  Dead slots (score < 0) are compared on deadness and ``keep`` only:
the port's refine kernel zeroes dead candidates, as the TPU kernels do,
while JAX on the CPU scores them, so their x and y differ.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.config import ColorGradientConfig as JColor
from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.models import multiscale as JM
from sixdpose_tpu.models.detector import Detector as JDetector
from sixdpose_tpu.ops import similarity as JS
from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import ColorGradientConfig, DetectorConfig
from sixdpose_tpu_torch.convert import multiscale_arrays
from sixdpose_tpu_torch.models import detector as TD
from sixdpose_tpu_torch.models import multiscale as TM
from sixdpose_tpu_torch.models.detector import Detector as TDetector
from sixdpose_tpu_torch.ops import similarity as TS
from sixdpose_tpu_torch.ops.scale_proposal import bin_centers

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")
OUTPUTS = ("tid", "x", "y", "score", "keep", "depth_mm", "scale")
CFG = dict(t_at_level=(4, 8), use_depth=False, use_color=True, top_k=16)
TRAIN_DEPTH = 600.0


# -- the similarity functions -------------------------------------------------


def _case(seed, c=16, h=96, w=128, n=19, f=29, kh=33, kw=41, spill=6):
    """Random maps in 0..4 and feature lists reaching ``spill`` pixels past
    the kernel extent, with padded tails and a template without features."""
    rng = np.random.default_rng(seed)
    maps = rng.integers(0, 5, (c, h, w)).astype(np.uint8)
    feats = np.stack(
        [rng.integers(0, kw + spill, (n, f)), rng.integers(0, kh + spill, (n, f)), rng.integers(0, c, (n, f))], -1
    ).astype(np.int32)
    valid = rng.random((n, f)) < 0.85
    valid[3, :] = False
    valid[5, f // 2 :] = False
    return maps, feats, valid


T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


@pytest.mark.parametrize("scale", [1.0, 0.55, 1.3, 0.0])
def test_build_kernels_scaled_matches_jax(scale):
    _, feats, valid = _case(1)
    want = np.asarray(JS.build_kernels_scaled(jnp.asarray(feats), jnp.asarray(valid), jnp.float32(scale), 40, 48, 16))
    got = TS.build_kernels_scaled(T(feats), T(valid), scale, 40, 48, 16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # Effective feature counts: scaling merges features onto one cell and drops those past the extent.
    counts = got.sum(dim=(1, 2, 3)).to(torch.int32)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(JS.count_kernel_features(jnp.asarray(want))))


def test_build_kernels_scaled_per_template_scale():
    """A (N, 1) scale tensor scales each template by its own factor: the
    kernels of separate one-scale builds."""
    _, feats, valid = _case(2)
    scales = np.linspace(0.4, 1.3, feats.shape[0]).astype(np.float32)
    got = TS.build_kernels_scaled(T(feats), T(valid), T(scales[:, None]), 50, 60, 16)
    for i in (0, 7, 18):
        one = TS.build_kernels_scaled(T(feats[i : i + 1]), T(valid[i : i + 1]), float(scales[i]), 50, 60, 16)
        assert torch.equal(got[i : i + 1], one)


@pytest.mark.parametrize("t", [4, 8])
def test_dense_pre_s2d_matches_jax(t):
    maps, feats, valid = _case(3 + t)
    kern = np.asarray(JS.build_kernels_scaled(jnp.asarray(feats), jnp.asarray(valid), jnp.float32(0.8), 33, 41, 16))
    k_s2d = JS.s2d_kernels_host(kern, t)
    want = np.asarray(JS.similarity_dense_pre_s2d(jnp.asarray(maps), jnp.asarray(k_s2d), t))
    got = TS.similarity_dense_pre_s2d(T(maps), T(k_s2d), t)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), TS.similarity_dense(T(maps), T(kern), t).numpy())


def _im2col_s2d(response_maps: torch.Tensor, t: int, khb: int, kwb: int):
    """The port's space-to-depth maps unfolded into the JAX package's im2col
    rows: (P (khb*kwb*C*t*t, Ho*Wo), Ho, Wo), row (dy*kwb + dx)*C*t*t + c'
    holding maps_s2d[c', dy:dy+Ho, dx:dx+Wo] flattened (bucket-major)."""
    maps = TS._s2d_maps(response_maps, t)  # (C*t*t, Hb, Wb)
    ct2, hb, wb = maps.shape
    ho, wo = hb - khb + 1, wb - kwb + 1
    blocks = torch.stack([maps[:, dy : dy + ho, dx : dx + wo] for dy in range(khb) for dx in range(kwb)])
    return blocks.reshape(khb * kwb * ct2, ho * wo), ho, wo


@pytest.mark.parametrize("t,khb,kwb", [(8, 5, 6), (4, 3, 2)])
def test_im2col_matches_jax(t, khb, kwb):
    maps, _, _ = _case(6, h=93, w=122)
    want, ho, wo = JS._im2col_s2d(jnp.asarray(maps), t, khb, kwb)
    got, gho, gwo = _im2col_s2d(T(maps), t, khb, kwb)
    assert (gho, gwo) == (ho, wo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scales,t", [([1.0], 8), ([0.7, 0.0, 1.3], 8), ([0.83, 1.17], 5), ([0.5, 1.0], 4)])
def test_multiscale_sparse_matches_jax_and_matmul(scales, t, monkeypatch):
    maps, feats, valid = _case(int(10 * t + len(scales)))
    sc = np.array(scales, np.float32)
    want_raw, want_nf = JS.similarity_multiscale_sparse(jnp.asarray(maps), jnp.asarray(feats), jnp.asarray(valid),
                                                        jnp.asarray(sc), t, 33, 41)
    got_raw, got_nf = TS.similarity_multiscale_sparse(T(maps), T(feats), T(valid), T(sc), t, 33, 41)
    assert got_raw.dtype == torch.float32 and got_nf.dtype == torch.int32
    np.testing.assert_array_equal(got_raw.numpy(), np.asarray(want_raw))
    np.testing.assert_array_equal(got_nf.numpy(), np.asarray(want_nf))
    # Row chunks (here 5 rows) give the one-chunk result.
    monkeypatch.setattr(TS, "_W_CHUNK_BYTES", 5 * feats.shape[1] * got_raw[0].numel() * 5)
    chunked = TS.similarity_multiscale_sparse(T(maps), T(feats), T(valid), T(sc), t, 33, 41)
    assert torch.equal(chunked[0], got_raw)


@pytest.mark.parametrize("train_depth", [600.0, 850.0])
def test_host_and_device_scaling_round_alike(train_depth):
    """The JAX package's host tables scale coordinates in float64, the
    port's per-frame build in float32; at the default bins they round every
    coordinate below 4096 to the same integer, so the port's one coarse
    route scores as the JAX table route does."""
    sc = (train_depth / bin_centers()).astype(np.float32)
    x = np.arange(4096)
    f32 = np.round((x[None].astype(np.float32) * sc[:, None]).astype(np.float32))
    np.testing.assert_array_equal(f32, np.round(x[None] * sc.astype(np.float64)[:, None]))


# -- the scaled refinement ----------------------------------------------------


def test_scaled_pyramid_refine_matches_jax():
    """``pyramid_refine`` with per-candidate scales against the JAX
    ``_refine_scaled_candidates``, on random maps and candidates (a third of
    them dead), scales 0.4 to 1.3."""
    rng = np.random.default_rng(21)
    levels = [rng.integers(0, 5, (16, 96, 128)).astype(np.uint8), rng.integers(0, 5, (16, 48, 64)).astype(np.uint8)]
    n, k = 7, 24
    feats, valids, whs = [], [], []
    for l, ext in enumerate((40, 20)):
        feats.append(np.stack([rng.integers(0, ext, (n, 30)), rng.integers(0, ext, (n, 30)),
                               rng.integers(0, 16, (n, 30))], -1).astype(np.int32))
        valids.append(rng.random((n, 30)) < 0.9)
        whs.append(np.full((n, 2), ext, np.int32) - rng.integers(0, 5, (n, 2)).astype(np.int32))
    tid = rng.integers(0, n, k).astype(np.int32)
    x = rng.integers(0, 8, k).astype(np.int32) * 8 + 3
    y = rng.integers(0, 6, k).astype(np.int32) * 8 + 3
    score = np.where(rng.random(k) < 0.66, rng.uniform(40, 90, k), -1.0).astype(np.float32)
    scale = rng.uniform(0.4, 1.3, k).astype(np.float32)
    jcfg = JConfig(t_at_level=(4, 8))
    want = JM._refine_scaled_candidates(
        [jnp.asarray(m) for m in levels], [jnp.asarray(f) for f in feats], [jnp.asarray(v) for v in valids],
        [jnp.asarray(w) for w in whs], jcfg, 30.0, jnp.asarray(tid), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(score), jnp.asarray(scale),
    )
    _, gx, gy, gs = TD.pyramid_refine(
        [T(m) for m in levels], None, None, [T(w) for w in whs], [T(f) for f in feats], [T(v) for v in valids], (4, 8),
        30.0, T(tid), T(x), T(y), T(score), scale=T(scale),
    )
    want = [np.asarray(a) for a in want]
    live = want[2] >= 0
    assert live.sum() >= 8
    np.testing.assert_array_equal(gs.numpy() >= 0, live)
    for g, w in zip((gx, gy, gs), want):
        np.testing.assert_array_equal(g.numpy()[live], w[live])


# -- the matchers ---------------------------------------------------------------


def _object(h=60, w=60):
    """The disc of tests/test_multiscale.py."""
    obj = np.zeros((h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    m = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2) < (h / 2 - 4) ** 2
    obj[m] = (50, 160, 220)
    obj[m & (xx > w / 2)] = (220, 100, 30)
    obj[m & (yy > h / 2)] = (120, 220, 60)
    return obj, (m * 255).astype(np.uint8)


def _objects():
    """Three classes of different extents: the disc (about 52 px), the
    square of tests/test_multiscale.py (40 px) and a small triangle (about
    26 px), so the coarse maps are padded (pad_kb > 0)."""
    disc = _object()
    sq = np.zeros((60, 60, 3), np.uint8)
    sq[10:50, 10:50] = (230, 230, 40)
    sq[20:40, 20:40] = (40, 60, 200)
    sq_m = np.zeros((60, 60), np.uint8)
    sq_m[10:50, 10:50] = 255
    yy, xx = np.mgrid[0:60, 0:60]
    tri_m = (yy > 17) & (yy < 44) & (xx > 17) & (xx < 44) & (yy > xx - 5)
    tri = np.zeros((60, 60, 3), np.uint8)
    tri[tri_m] = (90, 230, 90)
    tri[tri_m & (xx > 30)] = (200, 60, 200)
    return {"a": disc, "b": (sq, sq_m), "c": (tri, (tri_m * 255).astype(np.uint8))}


def _nearest(a, s):
    h, w = a.shape[:2]
    ys = np.minimum(((np.arange(round(h * s)) + 0.5) / s).astype(int), h - 1)
    xs = np.minimum(((np.arange(round(w * s)) + 0.5) / s).astype(int), w - 1)
    return a[ys][:, xs]


def _scene():
    """128 x 160: the disc and the square at 0.6 of their size (as at 1000
    mm for a bank trained at 600 mm), the triangle at 0.8 in a band at 750
    mm, on a floor at 1000 mm."""
    objs = _objects()
    scene = np.zeros((128, 160, 3), np.uint8)
    for cid, (y0, x0), s in (("a", (40, 20), 0.6), ("b", (66, 100), 0.6), ("c", (4, 100), 0.8)):
        small = _nearest(objs[cid][0], s)
        h, w = small.shape[:2]
        scene[y0 : y0 + h, x0 : x0 + w] = np.where(small.sum(-1, keepdims=True) > 0, small, scene[y0 : y0 + h, x0 : x0 + w])
    depth = np.full((128, 160), 1000, np.uint16)
    depth[:40] = 750
    return scene, depth


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """The three-class bank, trained by the JAX package and carried to the
    port through the shared npz."""
    jdet = JDetector(JConfig(color=JColor(num_features=32), **CFG))
    for cid, (obj, mask) in _objects().items():
        train = np.zeros((128, 160, 3), np.uint8)
        train[30:90, 50:110] = obj
        tmask = np.zeros((128, 160), np.uint8)
        tmask[30:90, 50:110] = mask
        assert jdet.add_template(cid, train, None, tmask) == 0
    # A second, shifted disc template, so the classes differ in size.
    obj, mask = _object(48, 48)
    train = np.zeros((128, 160, 3), np.uint8)
    train[40:88, 20:68] = obj
    tmask = np.zeros((128, 160), np.uint8)
    tmask[40:88, 20:68] = mask
    assert jdet.add_template("a", train, None, tmask) == 1
    path = str(tmp_path_factory.mktemp("bank") / "ms.npz")
    jdet.write_classes(path)
    tdet = TDetector.read_classes(path, DetectorConfig(color=ColorGradientConfig(num_features=32), **CFG), device="cpu")
    return jdet, tdet


def _assert_same_live(want, got):
    want = [np.asarray(a) for a in want]
    got = [a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in got]
    live = want[3] >= 0
    np.testing.assert_array_equal(got[3] >= 0, live)
    np.testing.assert_array_equal(got[4], want[4])
    for i in (0, 1, 2, 3, 5, 6):
        np.testing.assert_array_equal(got[i][live], want[i][live], err_msg=OUTPUTS[i])
    return int(live.sum())


def _jax_single(jdet, cid, threshold, budget):
    ms = JM.MultiScaleDetector(jdet, TRAIN_DEPTH, num_scales=3, table_budget_bytes=budget)
    feats, valids, whs, bs, kdims, w_bins, nf_bins = ms._feature_arrays(cid)
    scene, depth = _scene()
    return JM._multiscale_detect(jnp.asarray(scene), jnp.asarray(depth), feats, valids, whs, bs, ms.cfg, threshold, 3,
                                 kdims, w_bins=w_bins, nf_bins=nf_bins)


BIG, NONE = 2 << 30, 0


def test_multiscale_arrays_match_jax(banks):
    """Padded feature arrays, extents at the largest scale, pad map, class
    blocks and padding, as MultiScaleMultiClass._build and
    MultiScaleDetector._feature_arrays make them."""
    jdet, tdet = banks
    jm = JM.MultiScaleMultiClass(jdet, TRAIN_DEPTH, num_scales=3, table_budget_bytes=NONE)
    tm = TM.MultiScaleMultiClass(tdet, TRAIN_DEPTH, num_scales=3, device="cpu")
    assert tm.max_scale == jm.max_scale and tm.bank.kdims == jm.kdims and tm.bank.pad_kb == jm.pad_kb
    assert tm.bank.pad_kb[0] > 0 and tm.bank.pad_kb[1] > 0
    np.testing.assert_array_equal(tm.bin_scales.numpy(), np.asarray(jm.bin_scales))
    for name in ("feats", "valids", "whs"):
        for a, b in zip(getattr(tm.bank, name), getattr(jm, name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tm.bank.pad_map.numpy(), np.asarray(jm.pad_map))
    np.testing.assert_array_equal(tm.bank.cls_kb.numpy(), np.asarray(jm.cls_kb))
    js = JM.MultiScaleDetector(jdet, TRAIN_DEPTH, table_budget_bytes=NONE)._feature_arrays("a")
    bank = TM.MultiScaleDetector(tdet, TRAIN_DEPTH, device="cpu").class_bank("a")
    assert bank.kdims == js[4]
    for i, name in enumerate(("feats", "valids", "whs")):
        for a, b in zip(getattr(bank, name), js[i]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("budget", [BIG, NONE])
@pytest.mark.parametrize("threshold", [50.0, 30.0])
def test_multiscale_detect_core_matches_jax(banks, budget, threshold):
    """MultiScaleDetector (the one-pass core over one class) against the
    JAX single-class program on its table route (BIG) and its scatter route
    (NONE)."""
    jdet, tdet = banks
    td = TM.MultiScaleDetector(tdet, TRAIN_DEPTH, num_scales=3, device="cpu")
    scene, depth = _scene()
    for cid in ("a", "b", "c"):
        got = td.match_arrays(scene, depth, threshold, cid)
        assert got[0].shape == (16,)
        assert _assert_same_live(_jax_single(jdet, cid, threshold, budget), got) >= 1


def test_multiscale_detector_match_matches_jax(banks):
    jdet, tdet = banks
    key = lambda m: (m.class_id, m.template_id, m.x, m.y, m.similarity, m.depth_mm, m.scale)  # noqa: E731
    scene, depth = _scene()
    jd = JM.MultiScaleDetector(jdet, TRAIN_DEPTH, num_scales=3)
    td = TM.MultiScaleDetector(tdet, TRAIN_DEPTH, num_scales=3, device="cpu")
    for cid in ("a", "b"):
        want = jd.match(scene, depth, 50.0, cid)
        got = td.match(scene, depth, 50.0, cid)
        assert want and [key(m) for m in got] == [key(m) for m in want]
    assert isinstance(got[0], TM.ScaleMatch)


@pytest.mark.parametrize("room", [1, 2])
def test_multiscale_detector_matches_jax_across_table_evictions(banks, room):
    """With room for one or two of class a's tables, the JAX package builds,
    touches and (at 1) evicts tables over a sequence of requests; the port,
    which builds its weights per frame, gives JAX's result at every
    request."""
    jdet, tdet = banks
    jb = JM.MultiScaleDetector(jdet, TRAIN_DEPTH, num_scales=3, table_budget_bytes=BIG)._feature_arrays("a")
    budget = room * int(jb[5].nbytes + jb[6].nbytes) + int(jb[5].nbytes) // 2
    jd = JM.MultiScaleDetector(jdet, TRAIN_DEPTH, num_scales=3, table_budget_bytes=budget)
    td = TM.MultiScaleDetector(tdet, TRAIN_DEPTH, num_scales=3, device="cpu")
    scene, depth = _scene()
    jax_routes = set()
    for cid in ("a", "b", "a", "c", "b", "a"):
        feats, valids, whs, bs, kdims, w_bins, nf_bins = jd._feature_arrays(cid)
        jax_routes.add("table" if w_bins is not None else "scatter")
        want = JM._multiscale_detect(jnp.asarray(scene), jnp.asarray(depth), feats, valids, whs, bs, jd.cfg, 40.0, 3,
                                     kdims, w_bins=w_bins, nf_bins=nf_bins)
        _assert_same_live(want, td.match_arrays(scene, depth, 40.0, cid))
    assert jax_routes == ({"table", "scatter"} if room == 1 else {"table"})  # room for all three at 2


@pytest.mark.parametrize("budget", [BIG, NONE])
@pytest.mark.parametrize("threshold", [50.0, 30.0])
def test_multiscale_multiclass_core_matches_jax(banks, budget, threshold):
    """Against the JAX program on its per-bin table-list route (BIG) and on
    its scatter route (NONE); each class's row equals the port's
    MultiScaleDetector for that class."""
    jdet, tdet = banks
    scene, depth = _scene()
    jm = JM.MultiScaleMultiClass(jdet, TRAIN_DEPTH, num_scales=3, table_budget_bytes=budget)
    tm = TM.MultiScaleMultiClass(tdet, TRAIN_DEPTH, num_scales=3, device="cpu")
    assert (jm.w_bins is not None) == (budget == BIG)
    got = tm.match_arrays(scene, depth, threshold)
    assert got[0].shape == (3, 16)
    assert _assert_same_live(jm.match_arrays(scene, depth, threshold), got) >= 3
    td = TM.MultiScaleDetector(tdet, TRAIN_DEPTH, num_scales=3, device="cpu")
    for ci, cid in enumerate(tm.class_ids):
        for a, b in zip(got, td.match_arrays(scene, depth, threshold, cid)):
            assert torch.equal(a[ci], b), cid


def test_multiscale_multiclass_match_matches_jax(banks):
    jdet, tdet = banks
    key = lambda m: (m.class_id, m.template_id, m.x, m.y, m.similarity, m.depth_mm, m.scale)  # noqa: E731
    scene, depth = _scene()
    want = JM.MultiScaleMultiClass(jdet, TRAIN_DEPTH, num_scales=3).match(scene, depth, 50.0)
    got = TM.MultiScaleMultiClass(tdet, TRAIN_DEPTH, num_scales=3, device="cpu").match(scene, depth, 50.0)
    assert [key(m) for m in got] == [key(m) for m in want]
    assert {"a", "b", "c"} <= {m.class_id for m in got}


def test_multiscale_multiclass_without_nms_and_empty_scene(banks):
    _, tdet = banks
    tm = TM.MultiScaleMultiClass(tdet, TRAIN_DEPTH, num_scales=3, device="cpu")
    scene, depth = _scene()
    with_nms = tm.match_arrays(scene, depth, 30.0)
    without = tm.match_arrays(scene, depth, 30.0, apply_nms=False)
    for a, b in zip(with_nms[:4] + with_nms[5:], without[:4] + without[5:]):
        assert torch.equal(a, b)
    assert torch.equal(without[4], without[3] >= 0) and int(with_nms[4].sum()) < int(without[4].sum())
    assert tm.match(np.zeros_like(scene), depth, 50.0) == []
    # No depth inside the histogram's range: no proposal, no match.
    assert tm.match(scene, np.zeros_like(depth), 10.0) == []


def test_planted_ms_golden_on_cpu():
    """The JAX golden of tools/torch_port_ms_golden.py (the disc resized to
    850 / 1050 at 1050 mm in a VGA scene; the bank of planted_mc_bank.npz
    trained at 850 mm): the port on the CPU gives the same live entries from
    MultiScaleDetector and MultiScaleMultiClass, and the disc's top match is
    at its planted depth, scale and position."""
    g = np.load(os.path.join(TESTDATA, "planted_ms_golden.npz"))
    cids = [str(c) for c in g["class_ids"]]
    det = TDetector.read_classes(os.path.join(TESTDATA, "planted_mc_bank.npz"),
                                 DetectorConfig(t_at_level=tuple(int(v) for v in g["t_at_level"])), device="cpu")
    rgb, depth = synthetic.planted_scene_scaled(*(int(v) for v in g["scene_xy"]), float(g["planted_scale"]),
                                                int(g["scene_depth"]), seed=int(g["scene_seed"]))
    kw = dict(num_scales=int(g["num_scales"]), device="cpu")
    single = TM.MultiScaleDetector(det, float(g["train_depth"]), **kw).match_arrays(rgb, depth, float(g["threshold"]),
                                                                                   "disc")
    multi = TM.MultiScaleMultiClass(det, float(g["train_depth"]), class_ids=cids, **kw).match_arrays(
        rgb, depth, float(g["threshold"]))
    for prefix, out in (("single", single), ("multi", multi)):
        _assert_same_live([g[f"{prefix}_{k}"] for k in OUTPUTS], out)
    for out in (single, [a[0] for a in multi]):
        tid, x, y, score, keep, dmm, sc = (a.numpy() for a in out)
        top = np.flatnonzero(keep & (score >= 0))[0]
        assert (tid[top], dmm[top], sc[top]) == (0, float(g["scene_depth"]), g["planted_scale"])
        assert np.abs(np.array([x[top], y[top]]) - g["expected_xy"]).max() <= int(g["tolerance_px"])


def test_multiscale_workload_shape():
    """The drawn full-width workload: 15 x 337 templates of 126 / 62
    features, largest level-1 extents 32..46 px (so the coarse maps pad by
    2 blocks), and 4 proposals of 5 with one empty."""
    from sixdpose_tpu_torch.ops.scale_proposal import propose_depth_bins

    w = synthetic.multiscale_workload()
    assert len(w["templates"]) == 15 and {len(t) for t in w["templates"]} == {337}
    assert w["templates"][0][0][0].features.shape == (126, 3) and w["templates"][0][0][1].features.shape == (62, 3)
    assert [max(t[1].width for t in tm) for tm in w["templates"]] == list(range(32, 47))
    bins = (w["train_depth"] / bin_centers()).astype(np.float32)
    a = multiscale_arrays(w["templates"], float(bins.max()), 8)
    assert a["kdims"][-1] == (63, 63) and a["pad_kb"] == (2, 2)
    _, _, counts = propose_depth_bins(torch.from_numpy(w["depth"].astype(np.int32)))
    assert int((counts > 0).sum()) == 4 and int(counts[-1]) == 0
