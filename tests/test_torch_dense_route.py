"""Port parity of the dense-kernel route against the JAX package, on the CPU.

A bank passed as its per-level (kernels, nfeats, whs) alone, without feature
lists, is scored at the coarse level by the dense conv and refined down the
pyramid by the grouped conv of ``similarity_local``, in both packages
(JAX ``models/detector.py::pyramid_refine`` with ``feats=None``).  Here
``pyramid_refine``, ``detect_frame_core`` (a batch of two frames against
JAX's single frame), ``match_multiclass_core`` and the twin of
``__graft_entry__.entry()`` run that route in the port on the same numpy
inputs as JAX, at 128 x 96 or below with torch on one thread, and every
output field must be equal to the bit.  On this route both packages score
dead candidates too, so dead slots are compared in x and y as well.

``entry()`` at VGA is held against the golden of
``JAX_PLATFORMS=cpu python tools/torch_port_entry_golden.py``
(``sixdpose_tpu_torch/testdata/entry_golden.npz``).
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from __graft_entry__ import _toy_bank
from sixdpose_tpu.config import ColorGradientConfig as JColor
from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.models import detector as JD
from sixdpose_tpu.models.multiclass import MultiClassMatcher as JMatcher
from sixdpose_tpu.models.multiclass import _match_multiclass as jmatch_multiclass
from sixdpose_tpu.ops import similarity as JS
from sixdpose_tpu_torch import entry as TE
from sixdpose_tpu_torch.config import ColorGradientConfig, DetectorConfig
from sixdpose_tpu_torch.convert import DeviceBank, multiclass_bank_from_numpy, without_features
from sixdpose_tpu_torch.models import detector as TD
from sixdpose_tpu_torch.models.multiclass import match_multiclass_core
from sixdpose_tpu_torch.ops import similarity as TS

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")
FIELDS = ("tid", "x", "y", "score", "keep")
KW = dict(t_at_level=(4, 8), top_k=16)
THRESHOLDS = (75.0, 30.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _assert_equal(got, want, names=FIELDS):
    """Every field of every slot, dtype included."""
    for name, g, w in zip(names, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _shape(kind, s=40):
    """A two-coloured disc or square, and its mask."""
    o = np.zeros((s, s, 3), np.uint8)
    yy, xx = np.mgrid[0:s, 0:s]
    if kind == "disc":
        m = ((yy - s / 2) ** 2 + (xx - s / 2) ** 2) < (s / 2 - 3) ** 2
        o[m] = (40, 200, 230)
        o[m & (xx > s / 2)] = (230, 80, 40)
    else:
        m = (yy > 5) & (yy < s - 5) & (xx > 5) & (xx < s - 5)
        o[m] = (220, 220, 60)
        o[m & (yy > s / 2)] = (60, 120, 220)
    return o, m


def _view(kind, x, y, seed=None, h=96, w=128):
    """The shape at (x, y) on a black or (with a seed) noisy canvas, raised
    20 mm over a plane at 900 mm; rgb, depth (uint16) and mask."""
    o, m = _shape(kind)
    if seed is None:
        rgb, depth = np.zeros((h, w, 3), np.uint8), np.full((h, w), 900, np.uint16)
    else:
        r = np.random.default_rng(seed)
        rgb = r.integers(20, 60, (h, w, 3)).astype(np.uint8)
        depth = (900 + r.integers(-2, 3, (h, w))).astype(np.uint16)
    s = o.shape[0]
    rgb[y : y + s, x : x + s][m] = o[m]
    depth[y : y + s, x : x + s][m] = 880
    mask = np.zeros((h, w), np.uint8)
    mask[y : y + s, x : x + s] = m * 255
    return rgb, depth, mask


@pytest.fixture(scope="module")
def jdet():
    """A JAX detector trained on RGB-D views: the disc twice (at two places,
    so the templates differ in crop) and the square."""
    det = JD.Detector(JConfig(color=JColor(num_features=24), **KW))
    for cid, kind, at in (("disc", "disc", (30, 20)), ("disc", "disc", (50, 40)), ("square", "square", (40, 30))):
        rgb, depth, mask = _view(kind, *at)
        assert det.add_template(cid, rgb, depth, mask) >= 0
    return det


def _frames():
    """Two 128 x 96 RGB-D frames: the disc and the square on noise."""
    a = _view("disc", 64, 36, seed=5)
    b = _view("square", 20, 44, seed=6)
    return np.stack([a[0], b[0]]), np.stack([a[1], b[1]])


# -- similarity_local over a batch ---------------------------------------------


def test_similarity_local_folds_frames_into_groups():
    """A (B, ...) call equals JAX's single-frame ``similarity_local`` on each
    frame, including windows clamped at the map's edge."""
    rng = np.random.default_rng(4)
    b, k, c, t = 3, 5, 16, 4
    maps = rng.integers(0, 5, (b, c, 48, 64)).astype(np.uint8)
    kern = (rng.random((b, k, c, 17, 13)) < 0.03).astype(np.int8)
    org = (rng.integers(0, 16, (b, k, 2)) * t).astype(np.int32)
    got = TS.similarity_local(_t(maps), _t(kern), _t(org), t)
    assert got.shape == (b, k, 16, 16)
    for f in range(b):
        want = JS.similarity_local(jnp.asarray(maps[f]), jnp.asarray(kern[f]), jnp.asarray(org[f]), t)
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want))


# -- pyramid_refine --------------------------------------------------------------


def test_pyramid_refine_without_lists_matches_jax():
    """Random maps and kernels, a third of the candidates dead: the port's
    refinement over ``kernels`` (a batch of two frames) equals JAX's
    ``pyramid_refine`` with ``feats=None`` on each frame in every slot."""
    rng = np.random.default_rng(8)
    n, k, b = 6, 20, 2
    levels = [rng.integers(0, 5, (b, 16, h, w)).astype(np.uint8) for h, w in ((96, 128), (48, 64))]
    kernels = [(rng.random((n, 16, ext, ext)) < 0.02).astype(np.int8) for ext in (33, 17)]
    nfeats = [rng.integers(10, 40, n).astype(np.int32) for _ in range(2)]
    whs = [np.full((n, 2), ext, np.int32) - rng.integers(0, 4, (n, 2)).astype(np.int32) for ext in (32, 16)]
    tid = rng.integers(0, n, (b, k)).astype(np.int32)
    x = rng.integers(0, 8, (b, k)).astype(np.int32) * 8 + 3
    y = rng.integers(0, 6, (b, k)).astype(np.int32) * 8 + 3
    score = np.where(rng.random((b, k)) < 0.66, rng.uniform(40, 90, (b, k)), -1.0).astype(np.float32)
    got = TD.pyramid_refine([_t(m) for m in levels], [_t(a) for a in kernels], [_t(a) for a in nfeats],
                            [_t(a) for a in whs], None, None, (4, 8), 20.0, _t(tid), _t(x), _t(y), _t(score))
    jk, jn, jw = ([jnp.asarray(a) for a in arrs] for arrs in (kernels, nfeats, whs))
    live = 0
    for f in range(b):
        want = JD.pyramid_refine([jnp.asarray(m[f]) for m in levels], jk, jn, jw, (4, 8), 20.0, jnp.asarray(tid[f]),
                                 jnp.asarray(x[f]), jnp.asarray(y[f]), jnp.asarray(score[f]))
        _assert_equal([a[f] for a in got], want, FIELDS[:4])
        live += int((np.asarray(want[3]) >= 0).sum())
    assert live >= 12


def test_scale_without_lists_raises():
    """Per-candidate scales have no grouped-conv form in JAX: the port
    refuses them rather than guess."""
    maps = [torch.zeros((16, 32, 32), dtype=torch.uint8), torch.zeros((16, 16, 16), dtype=torch.uint8)]
    kernels = [torch.zeros((1, 16, 9, 9), dtype=torch.int8)] * 2
    ones = [torch.ones((1,), dtype=torch.int32)] * 2
    whs = [torch.full((1, 2), 8, dtype=torch.int32)] * 2
    cand = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="feature lists"):
        TD.pyramid_refine(maps, kernels, ones, whs, None, None, (4, 8), 30.0, cand, cand, cand,
                          torch.zeros((2,)), scale=torch.ones((2,)))


# -- detect_frame_core -------------------------------------------------------------


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_detect_frame_core_without_lists_matches_jax(jdet, threshold):
    """A batch of two frames through the port's feature-less bank (built
    from JAX's ``device_bank`` triple) equals JAX's single-frame
    ``detect_frame`` without lists on each frame, every slot; its live slots
    equal the sparse route's on the same bank with its lists."""
    cfg = DetectorConfig(color=ColorGradientConfig(num_features=24), **KW)
    triple = jdet.device_bank("disc")
    bank = DeviceBank.from_kernels(*([np.asarray(a) for a in arrs] for arrs in triple), device="cpu")
    assert bank.feats is None and bank.valids is None
    rgb, depth = _frames()
    got = TD.detect_frame_core(_t(rgb), _t(depth.astype(np.int32)), bank, cfg, threshold)
    assert got[0].shape == (2, 16)
    feats, valids = jdet._device_feats["disc"]
    sparse = DeviceBank(bank.nfeats, bank.whs, bank.kdims, tuple(_t(a) for a in feats), tuple(_t(a) for a in valids))
    sparse_out = TD.detect_frame_core(_t(rgb), _t(depth.astype(np.int32)), sparse, cfg, threshold)
    live = 0
    for f in range(2):
        want = JD.detect_frame(jnp.asarray(rgb[f]), jnp.asarray(depth[f]), *triple, jdet.cfg, threshold)
        _assert_equal([a[f] for a in got], want)
        alive = np.asarray(want[3]) >= 0
        np.testing.assert_array_equal(sparse_out[4][f].numpy(), np.asarray(want[4]))
        for a, w in zip(sparse_out[:4], want[:4]):
            np.testing.assert_array_equal(a[f].numpy()[alive], np.asarray(w)[alive])
        live += int(alive.sum())
    assert live >= (2 if threshold == 75.0 else 8)


# -- match_multiclass_core -------------------------------------------------------


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_match_multiclass_core_without_lists_matches_jax(jdet, threshold):
    """The two-class superbank without lists: the port's
    ``match_multiclass_core`` equals JAX's with ``feats=None`` in every slot,
    and the superbank of ``without_features`` levels is JAX's kernels,
    counts and extents."""
    jm = JMatcher(jdet, ["disc", "square"])
    rgb, depth = _frames()
    pyr = jm.det.build_response_pyramid(rgb[0], depth[0])
    want = jmatch_multiclass(tuple(pyr), jm.kernels, jm.nfeats, jm.whs, None, None, jm.pad_map, tuple(KW["t_at_level"]),
                             threshold, KW["top_k"], jm.nmax, jdet.cfg.nms_iou)
    mc = multiclass_bank_from_numpy([without_features(jdet.bank.finalized(c)) for c in ("disc", "square")], "cpu")
    assert mc.bank.feats is None and mc.nmax == jm.nmax
    for name in ("kernels", "nfeats", "whs"):
        for a, b in zip(getattr(mc.bank, name), getattr(jm, name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(mc.pad_map.numpy(), np.asarray(jm.pad_map))
    got = match_multiclass_core([_t(np.asarray(p)) for p in pyr], mc.bank, mc.pad_map, tuple(KW["t_at_level"]),
                                threshold, KW["top_k"], jdet.cfg.nms_iou)
    assert got[0].shape == (2, 16)
    _assert_equal(got, want)
    assert int((np.asarray(want[3]) >= 0).sum()) >= 1


# -- the twin of __graft_entry__.entry() ---------------------------------------------


def test_toy_bank_equals_jax():
    for kw in (dict(num_templates=16, size0=32), dict(num_templates=3, seed=2, size0=24)):
        mine, theirs = TE.toy_bank(**kw), _toy_bank(**kw)
        assert len(mine) == len(theirs)
        for tm, tj in zip(mine, theirs):
            for a, b in zip(tm, tj):
                np.testing.assert_array_equal(a.features, b.features)
                assert a.features.dtype == b.features.dtype
                assert (a.width, a.height, a.pyramid_level) == (b.width, b.height, b.pyramid_level)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.entry()


def test_entry_on_the_cpu_equals_the_jax_golden():
    """The port's ``entry()`` on the CPU: the frame is the one JAX drew, the
    outputs are JAX's to the bit, and the route launched no kernel."""
    g = np.load(os.path.join(TESTDATA, "entry_golden.npz"))
    fn, (rgb, depth) = TE.entry(device="cpu")
    assert rgb.shape == (480, 640, 3) and depth.dtype == torch.int32
    assert int(rgb.to(torch.int64).sum()) == int(g["rgb_sum"]) and int(depth.sum()) == int(g["depth_sum"])
    np.testing.assert_array_equal(rgb[0].numpy(), g["rgb_row0"])
    np.testing.assert_array_equal(depth[0].numpy(), g["depth_row0"])
    out = fn(rgb, depth)
    assert out[0].shape == (int(g["top_k"]),)
    _assert_equal(out, [g[n] for n in FIELDS])
    assert int((g["score"] >= 0).sum()) >= 8
