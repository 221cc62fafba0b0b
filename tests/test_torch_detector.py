"""Port parity for the slice as a whole: models/detector.py (torch) against
the JAX package, on the CPU at 128x96.

Parity is defined on live entries (score >= 0) for tid, x, y and score, and
on all entries for keep and for score < 0: the port's kernel contract
zeroes dead candidates in the refinement, as the TPU kernels do, while the
JAX function on the CPU scores them, so the argmax-derived x, y of a dead
slot may differ.  Everything compared is an integer or a float32 computed
by the same operations, so it compares for equality.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.config import ColorGradientConfig as JColor
from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.models import detector as JD
from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import ColorGradientConfig, DetectorConfig
from sixdpose_tpu_torch.models import detector as TD

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")


def _object(seed=3, s=48):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:s, 0:s]
    r2 = ((yy - s / 2) ** 2 + (xx - s / 2) ** 2) / (s / 2 - 4) ** 2
    m = r2 < 1
    obj = np.zeros((s, s, 3), np.uint8)
    obj[m] = (60, 170, 230)
    obj[m & (xx > s / 2)] = (230, 90, 30)
    obj[m & (yy > s / 2) & (xx <= s / 2)] = (120, 230, 60)
    obj = np.clip(obj + rng.integers(0, 20, (s, s, 3)), 0, 255).astype(np.uint8)
    height = (40 * np.sqrt(np.clip(1 - r2, 0, 1))).astype(np.int32)
    return obj, height, m


def _frame(variant, x, y, seed=None, h=96, w=128):
    """The object (variant: 0 as is, 1 rotated, 2 mirrored) at (x, y) on a
    black or (with a seed) noisy canvas, on a plane at 900 mm."""
    obj, height, m = _object()
    obj, height, m = [np.rot90(a) if variant == 1 else a[:, ::-1] if variant == 2 else a for a in (obj, height, m)]
    if seed is None:
        rgb = np.zeros((h, w, 3), np.uint8)
        depth = np.full((h, w), 900, np.uint16)
    else:
        r = np.random.default_rng(seed)
        rgb = r.integers(20, 60, (h, w, 3)).astype(np.uint8)
        depth = (900 + r.integers(-2, 3, (h, w))).astype(np.uint16)
    s = obj.shape[0]
    rgb[y : y + s, x : x + s][m] = obj[m]
    depth[y : y + s, x : x + s][m] = 850 - height[m]
    mask = np.zeros((h, w), np.uint8)
    mask[y : y + s, x : x + s] = m * 255
    return rgb, depth, mask


CONFIGS = {
    "color_t48": (dict(t_at_level=(4, 8), use_depth=False, top_k=16), dict(num_features=24)),
    "rgbd_t48": (dict(t_at_level=(4, 8), top_k=16), dict(num_features=24)),
    "rgbd_t58": (dict(t_at_level=(5, 8), top_k=32), dict(num_features=24)),
}


def _detectors(name):
    kw, ckw = CONFIGS[name]
    jcfg = JConfig(color=JColor(**ckw), **kw)
    tcfg = DetectorConfig(color=ColorGradientConfig(**ckw), **kw)
    jd, td = JD.Detector(jcfg), TD.Detector(tcfg, device="cpu")
    for variant in range(3):
        rgb, depth, mask = _frame(variant, 40, 24)
        dep = depth if kw.get("use_depth", True) else None
        assert jd.add_template("obj", rgb, dep, mask) == variant
        assert td.add_template("obj", rgb, dep, mask) == variant
    return jd, td, kw.get("use_depth", True)


def _assert_same(j, t):
    """Live entries identical, keep and deadness identical everywhere."""
    j = [np.asarray(a) for a in j]
    t = [a.cpu().numpy() for a in t]
    jt, jx, jy, js, jk = j
    tt, tx, ty, ts, tk = t
    live = js >= 0
    np.testing.assert_array_equal(ts >= 0, live)
    np.testing.assert_array_equal(tk, jk)
    for a, b in ((tt, jt), (tx, jx), (ty, jy), (ts, js)):
        np.testing.assert_array_equal(a[live], b[live])
    return int(live.sum())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_detect_frame_core_matches_jax(name):
    jd, td, use_depth = _detectors(name)
    rgb, depth, _ = _frame(1, 64, 30, seed=5)
    dep = depth if use_depth else None
    kernels, nfeats, whs = jd.device_bank("obj")
    feats, valids = jd._device_feats["obj"]
    n_live = 0
    for thr in (75.0, 30.0):
        j = JD.detect_frame_core(
            jnp.asarray(rgb), None if dep is None else jnp.asarray(dep), kernels, nfeats, whs,
            jd.cfg, thr, True, feats, valids,
        )
        t = TD.detect_frame_core(
            torch.from_numpy(rgb),
            None if dep is None else torch.from_numpy(dep.astype(np.int32)),
            td.device_bank("obj"), td.cfg, thr,
        )
        n_live += _assert_same(j, t)
    assert n_live > 3


@pytest.mark.parametrize("name", ["color_t48", "rgbd_t58"])
def test_detector_match_matches_jax(name):
    jd, td, use_depth = _detectors(name)
    for variant, (x, y) in enumerate([(64, 30), (12, 40), (70, 8)]):
        rgb, depth, _ = _frame(variant, x, y, seed=variant)
        dep = depth if use_depth else None
        jm = jd.match(rgb, dep, 60.0)
        tm = td.match(rgb, dep, 60.0)
        assert jm and [vars(m) for m in tm] == [vars(m) for m in jm]


def test_match_batch_arrays_equals_per_frame():
    jd, td, _ = _detectors("rgbd_t48")
    frames = [_frame(v, x, y, seed=10 + v) for v, (x, y) in enumerate([(64, 30), (16, 40)])]
    rgbs = np.stack([f[0] for f in frames])
    deps = np.stack([f[1] for f in frames])
    batch = td.match_batch_arrays(rgbs, deps, 50.0, "obj")
    assert batch[0].shape == (2, td.cfg.top_k)
    for b in range(2):
        single = td.match_arrays(rgbs[b], deps[b], 50.0, "obj")
        for a, s in zip(batch, single):
            assert torch.equal(a[b], s)
        _assert_same(jd.match_arrays(rgbs[b], deps[b], 50.0, "obj"), single)


def test_detector_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        assert TD.Detector().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TD.Detector()
    assert TD.Detector(device="cpu").device.type == "cpu"


def test_coarse_matmul_branch_not_ported():
    kern = torch.zeros((4000, 16, 81, 81), dtype=torch.int8)
    maps = torch.zeros((1, 16, 480, 640), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="multi-scale"):
        TD.coarse_scores([maps, maps], [kern, kern], [torch.ones(4000)] * 2, (4, 4))


def test_planted_golden_on_cpu():
    """The JAX golden of tools/torch_port_golden.py (VGA planted-object
    scene, bank saved by the JAX TemplateBank.save): the port on the CPU
    gives the same live entries, and its top match is the planted one."""
    g = np.load(os.path.join(TESTDATA, "planted_golden.npz"))
    det = TD.Detector.read_classes(
        os.path.join(TESTDATA, "planted_bank.npz"),
        DetectorConfig(t_at_level=tuple(int(v) for v in g["t_at_level"])),
        device="cpu",
    )
    rgb, depth = synthetic.planted_scene(*(int(v) for v in g["scene_xy"]), seed=int(g["scene_seed"]))
    out = det.match_arrays(rgb, depth, float(g["threshold"]), "planted")
    _assert_same([g[k] for k in ("tid", "x", "y", "score", "keep")], out)
    tid, x, y, score, keep = (a.numpy() for a in out)
    top = np.flatnonzero(keep & (score >= 0))[0]
    assert (tid[top], x[top], y[top]) == (0, *g["expected_xy"])
