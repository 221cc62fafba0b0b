"""Port parity: ops/quantize.py (torch) against the JAX package.

Same numpy inputs through both; every result is compared bit for bit.  The
one allowance (depth-normal azimuth) is stated in
``test_quantize_depth_normal``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.ops import quantize as JQ
from sixdpose_tpu_torch.ops import quantize as TQ


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(rng, h=96, w=128):
    """A smoothed random RGB image with blocks (strong, varied gradients)."""
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    rgb[20:60, 30:90] = (200, 40, 90)
    rgb[40:80, 60:110] = (30, 220, 120)
    return rgb


def _depth(rng, h=96, w=128):
    """A dome and a tilted plane with noise, a few invalid pixels, uint16."""
    yy, xx = np.mgrid[0:h, 0:w]
    d = 800.0 + 0.8 * xx - 0.5 * yy
    r2 = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2) / (0.35 * h) ** 2
    d = d - 80.0 * np.sqrt(np.clip(1 - r2, 0, 1))
    d = d + rng.normal(0, 3.0, (h, w))
    d[5:9, 100:110] = 2500  # beyond distance_threshold
    return np.clip(d, 0, 65535).astype(np.uint16)


def test_gaussian_blur_and_sobel(rng):
    rgb = _scene(rng)
    jb = np.asarray(JQ.gaussian_blur7_u8(jnp.asarray(rgb)))
    tb = TQ.gaussian_blur7_u8(_t(rgb)).numpy()
    np.testing.assert_array_equal(tb, jb)
    gray = rgb[..., 0]
    np.testing.assert_array_equal(
        TQ.gaussian_blur7_u8(_t(gray)).numpy(), np.asarray(JQ.gaussian_blur7_u8(jnp.asarray(gray)))
    )
    chw = np.moveaxis(jb, -1, 0)
    jdx, jdy = JQ._sobel3(jnp.asarray(chw))
    tdx, tdy = TQ._sobel3(_t(chw))
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(jdx))
    np.testing.assert_array_equal(tdy.numpy(), np.asarray(jdy))


def test_fast_atan2_bins_enumerated():
    """The pairs of tests/test_quantize.py (dense range, uniform samples over
    the Sobel range, 11.25-degree boundaries): bins identical to the JAX
    function's; raw degrees within float32 rounding."""
    dense = np.arange(-64, 65, dtype=np.float32)
    gx, gy = np.meshgrid(dense, dense)
    rng = np.random.default_rng(7)
    rand = rng.integers(-1020, 1021, (2, 200000)).astype(np.float32)
    ang = np.deg2rad(np.arange(0, 360, 11.25, dtype=np.float64))
    r = np.arange(1, 1021, 7, dtype=np.float64)
    bx = np.round(np.cos(ang)[None] * r[:, None]).astype(np.float32).ravel()
    by = np.round(np.sin(ang)[None] * r[:, None]).astype(np.float32).ravel()
    x = np.concatenate([gx.ravel(), rand[0], bx])
    y = np.concatenate([gy.ravel(), rand[1], by])

    jdeg = np.asarray(JQ.fast_atan2_deg(jnp.asarray(y), jnp.asarray(x)))
    tdeg = TQ.fast_atan2_deg(_t(y), _t(x)).numpy()
    k = np.float32(16.0 / 360.0)
    jbin = np.round(jdeg * k).astype(np.int32) & 15
    tbin = np.round(tdeg * k).astype(np.int32) & 15
    np.testing.assert_array_equal(tbin, jbin)
    assert float(np.abs(jdeg - tdeg).max()) < 1e-3


def test_exact_atan2_bins_enumerated():
    """Every integer Sobel pair (dx, dy) in [-1020, 1020]^2 (4.2M pairs):
    the ``phase="exact"`` bins, round(deg * 16/360) & 15, identical to the
    JAX function's.  The degrees themselves may differ by an ulp (two atan2
    implementations); no pair lies close enough to a bin boundary for that
    to move it."""
    r = np.arange(-1020, 1021, dtype=np.float32)
    gx, gy = np.meshgrid(r, r)
    x, y = gx.ravel(), gy.ravel()
    jdeg = np.asarray(jax.jit(JQ.exact_atan2_deg)(jnp.asarray(y), jnp.asarray(x)))
    tdeg = TQ.exact_atan2_deg(_t(y), _t(x)).numpy()
    k = np.float32(16.0 / 360.0)
    np.testing.assert_array_equal(np.round(tdeg * k).astype(np.int32) & 15, np.round(jdeg * k).astype(np.int32) & 15)


def test_exact_atan2(rng):
    x = rng.integers(-1020, 1021, 5000).astype(np.float32)
    y = rng.integers(-1020, 1021, 5000).astype(np.float32)
    j = np.asarray(JQ.exact_atan2_deg(jnp.asarray(y), jnp.asarray(x)))
    t = TQ.exact_atan2_deg(_t(y), _t(x)).numpy()
    # IEEE atan2 of two libraries: equal to a few float32 ulps of 360.
    assert float(np.abs(j - t).max()) < 1e-4


@pytest.mark.parametrize("phase", ["cv", "exact"])
def test_quantize_color_gradient(rng, phase):
    rgb = _scene(rng)
    jq, jm = JQ.quantize_color_gradient(jnp.asarray(rgb), 10.0, phase)
    tq, tm = TQ.quantize_color_gradient(_t(rgb), 10.0, phase)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_quantize_color_gradient_batched(rng):
    """A leading batch dimension gives the per-frame results."""
    rgbs = np.stack([_scene(rng, 48, 64) for _ in range(2)])
    tq, _ = TQ.quantize_color_gradient(_t(rgbs), 10.0)
    for i in range(2):
        jq, _ = JQ.quantize_color_gradient(jnp.asarray(rgbs[i]), 10.0)
        np.testing.assert_array_equal(tq[i].numpy(), np.asarray(jq))


def _azimuth_near_half_bin(depth, focal=1150.0, difference_threshold=50):
    """Pixels whose (JAX-side, float64-recomputed) normal azimuth*4/pi lies
    within 1e-5 of a half-integer: the only ones where atan2's last ulp
    can choose the bin."""
    h, w = depth.shape
    r = 5
    d = depth.astype(np.float64)
    p = np.pad(d, r)
    acc = {k: np.zeros((h, w)) for k in ("a00", "a01", "a11", "b0", "b1")}
    for dy, dx in [(-r, -r), (-r, 0), (-r, r), (0, -r), (0, r), (r, -r), (r, 0), (r, r)]:
        delta = p[r + dy : h + r + dy, r + dx : w + r + dx] - d
        f = (np.abs(delta) < difference_threshold).astype(np.float64)
        acc["a00"] += f * dx * dx
        acc["a01"] += f * dx * dy
        acc["a11"] += f * dy * dy
        acc["b0"] += f * dx * delta
        acc["b1"] += f * dy * delta
    ddx = acc["a11"] * acc["b0"] - acc["a01"] * acc["b1"]
    ddy = -acc["a01"] * acc["b0"] + acc["a00"] * acc["b1"]
    a = np.arctan2(focal * ddy, focal * ddx) * 4.0 / np.pi
    return np.abs(np.abs(a - np.floor(a)) - 0.5) < 1e-5


@pytest.mark.parametrize("lut_parity", [False, True])
def test_quantize_depth_normal(rng, lut_parity):
    """Bit equality, except that a differing pixel is allowed within the
    5x5 median neighbourhood of a pixel whose azimuth*4/pi lies within 1e-5
    of a half-integer (torch's and XLA's atan2 may differ by an ulp there).
    None is expected."""
    depth = _depth(rng)
    j = np.asarray(JQ.quantize_depth_normal(jnp.asarray(depth), lut_parity=lut_parity))
    t = TQ.quantize_depth_normal(_t(depth.astype(np.int32)), lut_parity=lut_parity).numpy()
    diff = j != t
    if diff.any():
        near = _azimuth_near_half_bin(depth)
        from scipy import ndimage

        allowed = ndimage.binary_dilation(near, structure=np.ones((5, 5), bool))
        assert not (diff & ~allowed).any(), np.argwhere(diff & ~allowed)[:5]
    assert (j != 0).mean() > 0.3  # the dome and plane give normals


def test_medians(rng):
    onehot = (1 << rng.integers(0, 8, (40, 52))).astype(np.uint8)
    onehot[rng.random((40, 52)) < 0.3] = 0
    np.testing.assert_array_equal(
        TQ.median5x5_onehot_u8(_t(onehot)).numpy(),
        np.asarray(JQ.median5x5_onehot_u8(jnp.asarray(onehot))),
    )
    img = rng.integers(0, 256, (40, 52)).astype(np.uint8)
    np.testing.assert_array_equal(
        TQ.median5x5_u8(_t(img)).numpy(), np.asarray(JQ.median5x5_u8(jnp.asarray(img)))
    )


def test_pyramid_downsampling(rng):
    rgb = _scene(rng, 96, 128)
    np.testing.assert_array_equal(
        TQ.pyr_down_rgb(_t(rgb)).numpy(), np.asarray(JQ.pyr_down_rgb(jnp.asarray(rgb)))
    )
    np.testing.assert_array_equal(
        TQ.pyr_down_rgb(_t(rgb[..., 1])).numpy(), np.asarray(JQ.pyr_down_rgb(jnp.asarray(rgb[..., 1])))
    )
    depth = _depth(rng)
    np.testing.assert_array_equal(
        TQ.pyr_down_depth(_t(depth.astype(np.int32))).numpy(),
        np.asarray(JQ.pyr_down_depth(jnp.asarray(depth))).astype(np.int32),
    )
    q = (1 << rng.integers(0, 8, (96, 128))).astype(np.uint8)
    np.testing.assert_array_equal(TQ.nn_down2(_t(q)).numpy(), np.asarray(JQ.nn_down2(jnp.asarray(q))))


def test_pyramids(rng):
    rgb = _scene(rng)
    for (jq, jm), (tq, tm) in zip(
        JQ.color_gradient_pyramid(jnp.asarray(rgb), 2), TQ.color_gradient_pyramid(_t(rgb), 2)
    ):
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    depth = _depth(rng)
    for jq, tq in zip(
        JQ.depth_normal_pyramid(jnp.asarray(depth), 3),
        TQ.depth_normal_pyramid(_t(depth.astype(np.int32)), 3),
    ):
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_quantize_depth_normal_lut_parity_on_norms_torch_rounds_wrong(rng, monkeypatch):
    """The ``lut_parity`` bins divide by the normal's norm.  On this depth
    some squared norms are inputs where torch's CPU float32 sqrt is off by
    an ulp; the port's correctly rounded sqrt gives JAX's norms there, and
    the bins equal JAX's to the bit."""
    seen = []
    real = TQ.sqrt32

    def spy(x):
        seen.append(x.clone())
        return real(x)

    monkeypatch.setattr(TQ, "sqrt32", spy)
    depth = _depth(rng)
    t = TQ.quantize_depth_normal(_t(depth.astype(np.int32)), lut_parity=True).numpy()
    j = np.asarray(JQ.quantize_depth_normal(jnp.asarray(depth), lut_parity=True))
    sq = torch.cat([s.reshape(-1) for s in seen])
    off = torch.sqrt(sq) != real(sq)
    assert int(off.sum()) > 10, int(off.sum())
    assert np.array_equal(real(sq[off]).numpy(), np.asarray(jnp.sqrt(jnp.asarray(sq[off].numpy()))))
    assert np.array_equal(t, j)


PYRAMID_CFGS = {
    "cells": dict(t_at_level=(5, 8)),
    "stock_lut_parity": dict(t_at_level=(4, 8), response_lut="stock", depth=dict(lut_parity=True)),
    "colour_binary45": dict(t_at_level=(4, 8), response_lut="binary45", use_depth=False),
    "depth_three_levels": dict(t_at_level=(5, 8, 3), use_color=False),
}


def _pyramid_cfg(name):
    from sixdpose_tpu_torch.config import DepthNormalConfig, DetectorConfig

    kw = dict(PYRAMID_CFGS[name])
    return DetectorConfig(depth=DepthNormalConfig(**kw.pop("depth", {})), **kw)


@pytest.mark.parametrize("name", list(PYRAMID_CFGS))
def test_response_pyramid_on_cpu_is_the_plain_version(rng, name):
    """``_build_response_pyramid`` on CPU tensors runs the plain version:
    the same bytes as ``_build_response_pyramid_plain``, the kernels'
    launcher never called (its counter unmoved)."""
    from sixdpose_tpu_torch.models import detector as D
    from sixdpose_tpu_torch.ops import response_pyramid as RP

    cfg = _pyramid_cfg(name)
    rgb = _t(np.stack([_scene(rng, 48, 64) for _ in range(2)]))
    depth = _t(np.stack([_depth(rng, 48, 64) for _ in range(2)]).astype(np.int32))
    before = RP.response_pyramid_cuda.launches
    got = D._build_response_pyramid(rgb, depth, cfg)
    want = D._build_response_pyramid_plain(rgb, depth, cfg)
    assert RP.response_pyramid_cuda.launches == before
    assert [tuple(g.shape) for g in got] == [(2, 8 * cfg.num_modalities) + s for s in
                                              RP.level_shapes(48, 64, len(cfg.t_at_level))]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(int((g != 0).sum()) > 0 for g in got)


REFUSED = {
    "cpu_tensors": (dict(), ValueError, "takes CUDA tensors"),
    "float_rgb": (dict(rgb=torch.float32), TypeError, "rgb must be torch.uint8"),
    "int64_depth": (dict(depth=torch.int64, cfg=dict(use_color=False)), TypeError, "depth must be torch.int32"),
    "rgb_without_channels": (dict(rgb_shape=(2, 48, 64)), ValueError, "rgb must be"),
    "unknown_lut": (dict(cfg=dict(response_lut="cosine")), ValueError, "unknown response LUT"),
    "no_modality": (dict(cfg=dict(use_color=False, use_depth=False)), ValueError, "needs a modality"),
    "t_zero": (dict(cfg=dict(t_at_level=(0, 8))), ValueError, "t >= 1"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_response_pyramid_cuda_refuses_what_the_kernels_do_not_take(name):
    """The card wrapper raises a clear error for CPU tensors, wrong dtypes
    and shapes and settings the kernels do not take, and launches
    nothing."""
    from sixdpose_tpu_torch.config import DetectorConfig
    from sixdpose_tpu_torch.ops import response_pyramid as RP

    over, err, match = REFUSED[name]
    rgb = torch.zeros(over.get("rgb_shape", (2, 48, 64, 3)), dtype=over.get("rgb", torch.uint8))
    depth = torch.zeros((2, 48, 64), dtype=over.get("depth", torch.int32))
    before = RP.response_pyramid_cuda.launches
    with pytest.raises(err, match=match):
        RP.response_pyramid_cuda(rgb, depth, DetectorConfig(**over.get("cfg", {})))
    assert RP.response_pyramid_cuda.launches == before
