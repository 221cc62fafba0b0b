"""The port's one square root (``ops/sqrt.py``) against numpy's and
``jnp.sqrt``, on the inputs where PyTorch's vectorised CPU ``torch.sqrt``
is off by an ulp.  All three are correctly rounded, so they agree to the
bit; the search shows that such inputs exist on this CPU."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu_torch.ops.sqrt import sqrt32, sqrt64  # noqa: E402


def _off_by_an_ulp(dtype, n=200_000, seed=0):
    """Seeded positive inputs over twelve decades where torch's CPU sqrt
    differs from numpy's."""
    rng = np.random.default_rng(seed)
    x = (rng.random(n) * 10.0 ** rng.integers(-6, 7, n)).astype(dtype)
    off = torch.sqrt(torch.from_numpy(x)).numpy() != np.sqrt(x)
    return x[off]


@pytest.mark.parametrize("dtype,helper", [(np.float32, sqrt32), (np.float64, sqrt64)])
def test_sqrt_equals_numpy_and_jax_where_torch_is_off(dtype, helper):
    x = _off_by_an_ulp(dtype)
    assert len(x) > 100, len(x)  # about 0.7% of inputs
    got = helper(torch.from_numpy(x)).numpy()
    assert got.dtype == dtype
    assert np.array_equal(got, np.sqrt(x))
    with jax.enable_x64(True):
        assert np.array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(x))))


def test_sqrt32_of_float64_rounds_once():
    """A float32 input through float64: each of 100,000 results equals the
    float32 nearest to the float64 root, which equals numpy's float32 root."""
    x = np.random.default_rng(1).random(100_000).astype(np.float32) * 1e4
    got = sqrt32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.sqrt(x.astype(np.float64)).astype(np.float32))
    assert np.array_equal(got, np.sqrt(x))


@pytest.mark.parametrize("dtype,helper", [(np.float32, sqrt32), (np.float64, sqrt64)])
def test_sqrt_special_values(dtype, helper):
    x = np.array([0.0, -0.0, 1.0, 4.0, np.inf, -1.0, np.nan, np.finfo(dtype).tiny, np.finfo(dtype).max], dtype)
    got = helper(torch.from_numpy(x)).numpy()
    want = torch.sqrt(torch.from_numpy(x)).numpy()  # exact at these
    assert np.array_equal(got, want, equal_nan=True)
    real = ~np.isnan(want)
    assert np.array_equal(np.signbit(got[real]), np.signbit(want[real]))
