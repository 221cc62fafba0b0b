"""Port parity: ops/spread.py and ops/similarity.py (torch) against JAX.

Same numpy inputs through both.  Spread and response maps are bytes and
compare bit for bit; similarities are sums of small integers in float32,
exact in both packages, so they compare for equality too.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.ops import similarity as JS
from sixdpose_tpu.ops import spread as JP
from sixdpose_tpu_torch.ops import similarity as TS
from sixdpose_tpu_torch.ops import spread as TP


def _t(a):
    return torch.from_numpy(np.array(a))


def _onehot(rng, h=96, w=128):
    q = (1 << rng.integers(0, 8, (h, w))).astype(np.uint8)
    q[rng.random((h, w)) < 0.6] = 0
    return q


@pytest.mark.parametrize("t", [4, 5, 8])
@pytest.mark.parametrize("lut", ["levelup", "stock", "binary45"])
def test_spread_and_response(rng, t, lut):
    q = _onehot(rng)
    js = np.asarray(JP.spread_orientations(jnp.asarray(q), t))
    ts = TP.spread_orientations(_t(q), t).numpy()
    np.testing.assert_array_equal(ts, js)
    jr = np.asarray(JP.compute_response_maps(jnp.asarray(js), lut))
    tr = TP.compute_response_maps(_t(js), lut).numpy()
    np.testing.assert_array_equal(tr, jr)


def _bank(rng, n=5, f=40, size=30, channels=16):
    feats = np.stack(
        [rng.integers(0, size, (n, f)), rng.integers(0, size, (n, f)), rng.integers(0, channels, (n, f))],
        -1,
    ).astype(np.int32)
    valid = rng.random((n, f)) < 0.85
    return feats, valid


def test_kernels_and_s2d(rng):
    feats, valid = _bank(rng)
    kern = TS.build_template_kernels(feats, valid, 31, 29, 16)
    np.testing.assert_array_equal(kern, JS.build_template_kernels(feats, valid, 31, 29, 16))
    for t in (4, 5, 8):
        np.testing.assert_array_equal(
            TS._s2d_kernels(_t(kern), t).numpy(), np.asarray(JS._s2d_kernels(jnp.asarray(kern), t))
        )
        np.testing.assert_array_equal(TS.s2d_kernels_host(kern, t), JS.s2d_kernels_host(kern, t))
        maps = rng.integers(0, 5, (16, 93, 122)).astype(np.uint8)
        np.testing.assert_array_equal(
            TS._s2d_maps(_t(maps), t).numpy(), np.asarray(JS._s2d_maps(jnp.asarray(maps), t))
        )


@pytest.mark.parametrize("t", [4, 5, 8])
def test_similarity_dense(rng, t):
    feats, valid = _bank(rng)
    kern = JS.build_template_kernels(feats, valid, 31, 29, 16)
    maps = rng.integers(0, 5, (16, 96, 128)).astype(np.uint8)
    j = np.asarray(JS.similarity_dense(jnp.asarray(maps), jnp.asarray(kern), t))
    tt = TS.similarity_dense(_t(maps), _t(kern), t).numpy()
    np.testing.assert_array_equal(tt, j)
    # Batched frames give the per-frame results.
    tb = TS.similarity_dense(_t(np.stack([maps, maps[:, ::-1].copy()])), _t(kern), t).numpy()
    np.testing.assert_array_equal(tb[0], j)
    j2 = np.asarray(JS.similarity_dense(jnp.asarray(maps[:, ::-1].copy()), jnp.asarray(kern), t))
    np.testing.assert_array_equal(tb[1], j2)


@pytest.mark.parametrize("t", [4, 5])
def test_similarity_local(rng, t):
    feats, valid = _bank(rng, n=6)
    kern = JS.build_template_kernels(feats, valid, 31, 29, 16)
    maps = rng.integers(0, 5, (16, 96, 128)).astype(np.uint8)
    org = (rng.integers(0, 96 // t, (6, 2)) * t).astype(np.int32)
    j = np.asarray(JS.similarity_local(jnp.asarray(maps), jnp.asarray(kern), jnp.asarray(org), t))
    tt = TS.similarity_local(_t(maps), _t(kern), _t(org), t).numpy()
    np.testing.assert_array_equal(tt, j)


def test_score_normalize(rng):
    raw = rng.integers(0, 400, (7, 5, 6)).astype(np.float32)
    nf = rng.integers(0, 120, 7).astype(np.int32)
    np.testing.assert_array_equal(
        TS.score_normalize(_t(raw), _t(nf)).numpy(),
        np.asarray(JS.score_normalize(jnp.asarray(raw), jnp.asarray(nf))),
    )
