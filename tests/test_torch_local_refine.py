"""Port parity: the local-refine dispatch and its plain version against the
JAX ``similarity_local_sparse``, at the cases of tests/test_pallas.py with
maps cut to 128x96 pixels.

Scores are sums of small integers in float32 and counts are integers, so
both compare for equality.  The JAX function on the CPU ignores ``active``;
the port's zeroes inactive candidates (the TPU kernels' contract), so with
``active`` the live rows compare equal and the dead rows must be zero.  The
kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.ops.similarity import similarity_local_sparse as jax_sparse
from sixdpose_tpu_torch.ops import local_refine as LR
from sixdpose_tpu_torch.ops.similarity import (
    similarity_local_sparse,
    similarity_local_sparse_auto,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, t, c, h, w, k, f, xmax, ymax, chans):
    maps = rng.integers(0, 5, (c, h, w)).astype(np.uint8)
    feats = np.stack(
        [rng.integers(0, xmax, (k, f)), rng.integers(0, ymax, (k, f)), rng.integers(0, chans, (k, f))], -1
    ).astype(np.int32)
    valid = rng.random((k, f)) < 0.9
    org = (rng.integers(0, max(1, min(h, w) // t - 4), (k, 2)) * t).astype(np.int32)
    return maps, feats, valid, org


def _jax(maps, feats, valid, org, t, window=16, scale=None):
    s, c = jax_sparse(
        jnp.asarray(maps), jnp.asarray(feats), jnp.asarray(valid), jnp.asarray(org), t, window,
        None if scale is None else jnp.asarray(scale),
    )
    return np.asarray(s), np.asarray(c)


@pytest.mark.parametrize("fn", [similarity_local_sparse, similarity_local_sparse_auto])
@pytest.mark.parametrize("t,f", [(5, 64), (4, 61)])
def test_scale_cases(rng, fn, t, f):
    """test_pallas.py's first case (t=5, scale) and a t=4 one whose F is not
    a multiple of 8; features reach past the map's right and bottom edge."""
    maps, feats, valid, org = _case(rng, t, 16, 96, 128, 16, f, 120, 110, 16)
    sc = rng.uniform(0.4, 1.3, 16).astype(np.float32)
    js, jc = _jax(maps, feats, valid, org, t, scale=sc)
    ts, tc = fn(_t(maps), _t(feats), _t(valid), _t(org), t, scale=_t(sc))
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tc.numpy(), jc)


@pytest.mark.parametrize("window", [16, 11])
def test_active_and_padded_tails(rng, window):
    """test_pallas.py's active-mask case: (8, 128, 96) maps at t=4, K=8,
    F=16 with padded feature tails; also a window below 16."""
    maps, feats, valid, org = _case(rng, 4, 8, 96, 128, 8, 16, 30, 30, 8)
    valid[:, 10:] = False
    active = np.array([True, False] * 4)
    js, jc = _jax(maps, feats, valid, org, 4, window)
    ts, tc = similarity_local_sparse_auto(
        _t(maps), _t(feats), _t(valid), _t(org), 4, window, active=_t(active)
    )
    ts = ts.numpy()
    np.testing.assert_array_equal(ts[active], js[active])
    assert (ts[~active] == 0).all()
    np.testing.assert_array_equal(tc.numpy(), jc)  # counts unaffected


def test_batched_frames(rng):
    """A leading batch of frames equals the per-frame calls."""
    cases = [_case(rng, 5, 16, 96, 128, 12, 40, 60, 60, 16) for _ in range(3)]
    stack = [np.stack(a) for a in zip(*cases)]
    active = rng.random((3, 12)) < 0.7
    ts, tc = similarity_local_sparse_auto(*(_t(a) for a in stack), 5, active=_t(active))
    for b, (maps, feats, valid, org) in enumerate(cases):
        js, jc = _jax(maps, feats, valid, org, 5)
        np.testing.assert_array_equal(ts[b].numpy()[active[b]], js[active[b]])
        np.testing.assert_array_equal(tc[b].numpy(), jc)


def test_cpu_wrapper_runs_plain_version_uncounted(rng):
    maps, feats, valid, org = _case(rng, 5, 16, 96, 128, 4, 20, 60, 60, 16)
    before = LR.similarity_local_sparse_cuda.launches
    a = LR.similarity_local_sparse_cuda(_t(maps), _t(feats), _t(valid), _t(org), 5)
    b = similarity_local_sparse(_t(maps), _t(feats), _t(valid), _t(org), 5)
    assert LR.similarity_local_sparse_cuda.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

