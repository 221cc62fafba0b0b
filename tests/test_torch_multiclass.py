"""Port parity of models/multiclass.py (the multi-class matcher) and of the
multi-class superbank (``convert.multiclass_bank_from_numpy``) against the
JAX package, on the CPU.

Everything the matcher computes is integer or exact float32, so every
comparison is exact.  Dead slots (score < 0) are compared on deadness and
``keep`` only: the port's refine kernel zeroes dead candidates, as the TPU
kernels do, while JAX on the CPU scores them, so their x and y differ.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.config import ColorGradientConfig as JColor
from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.models.detector import Detector as JDetector
from sixdpose_tpu.models.multiclass import MultiClassMatcher as JMatcher
from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import ColorGradientConfig, DetectorConfig
from sixdpose_tpu_torch.convert import multiclass_bank_from_numpy, without_features
from sixdpose_tpu_torch.models import detector as TD
from sixdpose_tpu_torch.models.detector import Detector as TDetector
from sixdpose_tpu_torch.models.multiclass import MultiClassMatcher, match_multiclass_core

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")
CFG = dict(t_at_level=(4, 8), use_depth=False, top_k=16)
KINDS = ("disc", "square", "triangle")


def _shape(kind: str, s: int = 48):
    """The shapes of tests/test_multiclass.py."""
    o = np.zeros((s, s, 3), np.uint8)
    yy, xx = np.mgrid[0:s, 0:s]
    if kind == "disc":
        m = ((yy - s / 2) ** 2 + (xx - s / 2) ** 2) < (s / 2 - 4) ** 2
        o[m] = (40, 200, 230)
        o[m & (xx > s / 2)] = (230, 80, 40)
    elif kind == "square":
        m = (yy > 6) & (yy < s - 6) & (xx > 6) & (xx < s - 6)
        o[m] = (220, 220, 60)
        o[m & (yy > s / 2)] = (60, 120, 220)
    else:  # triangle
        m = (yy > 6) & (xx > 6) & (xx < s - 6) & (yy < xx)
        o[m] = (90, 230, 90)
        o[m & (xx > s / 2)] = (200, 60, 200)
    return o, (m * 255).astype(np.uint8)


def _scene():
    scene = np.zeros((96, 128, 3), np.uint8)
    a, _ = _shape("disc")
    b, _ = _shape("square")
    scene[4:52, 4:52] = a
    scene[40:88, 72:120] = np.where(b > 0, b, scene[40:88, 72:120])
    return scene


@pytest.fixture(scope="module")
def three_class(tmp_path_factory):
    """The 3-class bank of tests/test_multiclass.py, trained by the JAX
    package (a second template of the disc, shifted, so the classes differ
    in size) and carried to the port through the shared npz."""
    jdet = JDetector(JConfig(color=JColor(num_features=24), **CFG))
    for kind in KINDS:
        o, m = _shape(kind)
        train = np.zeros((96, 128, 3), np.uint8)
        train[24:72, 40:88] = o
        tmask = np.zeros((96, 128), np.uint8)
        tmask[24:72, 40:88] = m
        assert jdet.add_template(kind, train, None, tmask) == 0
    o, m = _shape("disc", 40)
    train = np.zeros((96, 128, 3), np.uint8)
    train[30:70, 20:60] = o
    tmask = np.zeros((96, 128), np.uint8)
    tmask[30:70, 20:60] = m
    assert jdet.add_template("disc", train, None, tmask) == 1
    path = str(tmp_path_factory.mktemp("bank") / "three.npz")
    jdet.write_classes(path)
    tdet = TDetector.read_classes(path, DetectorConfig(color=ColorGradientConfig(num_features=24), **CFG), device="cpu")
    return jdet, tdet


def _assert_same_live(want, got):
    want = [np.asarray(a) for a in want]
    got = [a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in got]
    live = want[3] >= 0
    np.testing.assert_array_equal(got[3] >= 0, live)
    np.testing.assert_array_equal(got[4], want[4])
    for i in range(4):
        np.testing.assert_array_equal(got[i][live], want[i][live])
    return int(live.sum())


@pytest.mark.parametrize("class_ids", [None, ["square", "disc"], ["triangle"]])
def test_superbank_equals_jax(three_class, class_ids):
    """Padded feature lists, counts, the (C, Nmax) pad map and the extents
    of the padded kernels, exactly as MultiClassMatcher._build makes them;
    the superbank holds no kernels, and its ``without_features()`` twin
    holds JAX's padded kernels."""
    jdet, tdet = three_class
    jm = JMatcher(jdet, class_ids)
    tm = MultiClassMatcher(tdet, class_ids, device="cpu")
    assert tm.class_ids == jm.class_ids and tm.nmax == jm.nmax
    np.testing.assert_array_equal(tm.pad_map.numpy(), np.asarray(jm.pad_map))
    for name in ("nfeats", "whs", "feats", "valids"):
        for t_arr, j_arr in zip(getattr(tm.bank, name), getattr(jm, name)):
            assert t_arr.shape == j_arr.shape, name
            np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
    assert tm.bank.kernels is None
    assert tm.bank.kdims == tuple(tuple(k.shape[-2:]) for k in jm.kernels)
    for t_arr, j_arr in zip(tm.bank.without_features().kernels, jm.kernels):
        assert t_arr.shape == j_arr.shape and t_arr.dtype == torch.int8
        np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))


@pytest.mark.parametrize("threshold", [70.0, 40.0])
def test_match_multiclass_core_matches_jax(three_class, threshold):
    jdet, tdet = three_class
    jm, tm = JMatcher(jdet), MultiClassMatcher(tdet, device="cpu")
    want = jm.match_arrays(_scene(), None, threshold)
    got = tm.match_arrays(_scene(), None, threshold)
    assert got[0].shape == (3, 16)
    assert _assert_same_live(want, got) >= 2


def test_multiclass_match_matches_jax(three_class):
    jdet, tdet = three_class
    key = lambda m: (m.class_id, m.template_id, m.x, m.y, m.similarity)  # noqa: E731
    want = JMatcher(jdet).match(_scene(), None, 70.0)
    got = MultiClassMatcher(tdet, device="cpu").match(_scene(), None, 70.0)
    assert [key(m) for m in got] == [key(m) for m in want]
    assert {"disc", "square"} <= {m.class_id for m in got}
    # The per-class matcher finds the same matches (tests/test_multiclass.py).
    assert sorted(map(key, got)) == sorted(map(key, tdet.match(_scene(), None, 70.0)))


def test_one_class_equals_detector(three_class):
    """A one-class MultiClassMatcher equals the plain matcher, arrays and
    matches alike."""
    _, tdet = three_class
    mc = MultiClassMatcher(tdet, class_ids=["disc"], device="cpu")
    for thr in (70.0, 30.0):
        rows = mc.match_arrays(_scene(), None, thr)
        plain = tdet.match_arrays(_scene(), None, thr, "disc")
        for a, b in zip(rows, plain):
            assert torch.equal(a[0], b)
    key = lambda m: (m.template_id, m.x, m.y, m.similarity)  # noqa: E731
    assert [key(m) for m in mc.match(_scene(), None, 70.0)] == [
        key(m) for m in tdet.match(_scene(), None, 70.0, class_ids=["disc"])
    ]


def test_multiclass_empty_scene(three_class):
    _, tdet = three_class
    assert MultiClassMatcher(tdet, device="cpu").match(np.zeros((96, 128, 3), np.uint8), None, 70.0) == []


def test_matmul_branch_gives_the_dense_result(three_class, monkeypatch):
    """The feature-list superbank, however small, takes the feature-list
    scorer at the coarse level; its scale-1 integers are the conv's, so it
    gives the live results of its ``without_features()`` twin (the dense
    conv, then the grouped conv) and of the JAX matcher (dense at this
    size)."""
    jdet, tdet = three_class
    want = JMatcher(jdet).match_arrays(_scene(), None, 40.0)
    tm = MultiClassMatcher(tdet, device="cpu")
    taken = []
    scorer = TD.similarity_multiscale_auto
    monkeypatch.setattr(TD, "similarity_multiscale_auto", lambda *a: taken.append(1) or scorer(*a))
    got = tm.match_arrays(_scene(), None, 40.0)
    assert _assert_same_live(want, got) >= 2
    assert taken == [1]
    twin = match_multiclass_core(tm.response_pyramid(_scene(), None), tm.bank.without_features(), tm.pad_map,
                                 tuple(tm.cfg.t_at_level), 40.0, tm.cfg.top_k, tm.cfg.nms_iou)
    assert taken == [1]
    assert _assert_same_live(got, twin) >= 2


def test_match_multiclass_core_without_nms_keeps_every_live_slot(three_class):
    _, tdet = three_class
    tm = MultiClassMatcher(tdet, device="cpu")
    pyr = tm.response_pyramid(_scene(), None)
    args = (pyr, tm.bank, tm.pad_map, tuple(tm.cfg.t_at_level), 40.0, tm.cfg.top_k, tm.cfg.nms_iou)
    with_nms = match_multiclass_core(*args)
    without = match_multiclass_core(*args, apply_nms=False)
    for a, b in zip(with_nms[:4], without[:4]):
        assert torch.equal(a, b)
    assert torch.equal(without[4], without[3] >= 0)
    assert int(with_nms[4].sum()) < int(without[4].sum())


def test_multiclass_bank_of_numpy_levels_takes_either_package(three_class):
    """``multiclass_bank_from_numpy`` takes the JAX BankLevels as well as the port's,
    of either kind: the feature-list superbanks carry the same lists,
    counts, extents and no kernels; those of ``without_features`` levels the
    same kernels, counts, extents and no lists."""
    jdet, tdet = three_class
    for prep, fields, absent in ((list, ("nfeats", "whs", "feats", "valids"), "kernels"),
                                 (without_features, ("kernels", "nfeats", "whs"), "feats")):
        from_j = multiclass_bank_from_numpy([prep(jdet.bank.finalized(c)) for c in KINDS], "cpu")
        from_t = multiclass_bank_from_numpy([prep(tdet.bank.finalized(c)) for c in KINDS], "cpu")
        assert torch.equal(from_j.pad_map, from_t.pad_map) and from_j.nmax == from_t.nmax == 2
        assert from_j.bank.kdims == from_t.bank.kdims
        assert getattr(from_j.bank, absent) is None and getattr(from_t.bank, absent) is None
        for name in fields:
            for a, b in zip(getattr(from_j.bank, name), getattr(from_t.bank, name)):
                assert a.dtype == b.dtype and torch.equal(a, b), name


def test_planted_mc_golden_match_on_cpu():
    """The JAX multi-class golden of tools/torch_port_mc_golden.py (VGA
    scene with two planted objects, a three-class bank saved by the JAX
    TemplateBank.save): the port on the CPU gives the same live entries,
    and each planted class's top match is its planted one."""
    g = np.load(os.path.join(TESTDATA, "planted_mc_golden.npz"))
    det = TDetector.read_classes(
        os.path.join(TESTDATA, "planted_mc_bank.npz"),
        DetectorConfig(t_at_level=tuple(int(v) for v in g["t_at_level"])),
        device="cpu",
    )
    mc = MultiClassMatcher(det, device="cpu")
    assert mc.class_ids == list(g["class_ids"])
    rgb, depth = synthetic.planted_scene_multi([tuple(p) for p in g["placements"].tolist()], seed=int(g["scene_seed"]))
    out = mc.match_arrays(rgb, depth, float(g["threshold"]))
    _assert_same_live([g[k] for k in ("tid", "x", "y", "score", "keep")], out)
    tid, x, y, score, keep = (a.numpy() for a in out)
    for (ci, _, _), exp in zip(g["placements"], g["expected_xy"]):
        top = np.flatnonzero(keep[ci] & (score[ci] >= 0))[0]
        assert (tid[ci, top], x[ci, top], y[ci, top]) == (0, *exp)
