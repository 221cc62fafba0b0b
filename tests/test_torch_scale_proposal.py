"""Port parity of ops/scale_proposal.py (depth-histogram scale proposals)
against the JAX package, on the CPU.

Counts and bin indices are integers and depths are bin centres, so every
comparison is exact.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.ops import scale_proposal as JP
from sixdpose_tpu_torch.ops import scale_proposal as TP


def _planes(rows, shape=(120, 160), noise=0.0, seed=0):
    """Horizontal bands of constant depth from (first row, depth) pairs,
    plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    d = np.zeros(shape, np.float64)
    for row, mm in rows:
        d[row:] = mm
    return np.clip(np.round(d + noise * rng.standard_normal(shape)), 0, 65535).astype(np.uint16)


def _tied():
    """Bins 3 and 9 with the same count: the lower bin comes first."""
    d = np.zeros((100, 100), np.uint16)
    d[:30] = 750
    d[30:60] = 1350
    d[60:70] = 1700  # a third, smaller peak
    return d


def _out_of_range():
    """Depths at and past both ends of the range: 0, 399 and 2000 and above
    never count; 400 and 1999 fall in the first and last bins."""
    d = np.zeros((100, 100), np.uint16)
    d[:10] = 399
    d[10:25] = 400
    d[25:40] = 1999
    d[40:50] = 2000
    d[50:60] = 65535
    d[60:75] = 1000
    return d


def _min_pixels():
    """One bin of 150 pixels (below min_pixels 200) and one of 250."""
    d = np.zeros((100, 100), np.uint16)
    d[0, :100] = 900
    d[1, :50] = 900
    d[2:5, :83] = 1500
    d[5, :1] = 1500
    return d


CASES = {
    "two_peaks_and_low": lambda: _planes([(0, 800), (50, 1200), (80, 30)], (100, 100)),
    "noisy_planes": lambda: _planes([(0, 650), (30, 950), (60, 1250), (90, 1650)], noise=15.0),
    "adjacent_peaks_nms": lambda: _planes([(0, 850), (40, 1050), (90, 1150)], noise=3.0, seed=2),
    "tied_counts": _tied,
    "out_of_range": _out_of_range,
    "min_pixels": _min_pixels,
    "random": lambda: np.random.default_rng(5).integers(0, 2600, (96, 128)).astype(np.uint16),
    "empty": lambda: np.zeros((64, 64), np.uint16),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kw", [{}, {"num_scales": 3, "nms_radius": 1}, {"num_scales": 7, "min_pixels": 100}])
def test_proposals_match_jax(name, kw):
    depth = CASES[name]()
    want_d, want_c = (np.asarray(a) for a in JP.propose_depths(jnp.asarray(depth), **kw))
    want_b = np.asarray(JP.propose_depth_bins(jnp.asarray(depth), **kw)[0])
    t = torch.from_numpy(depth.astype(np.int32))
    got_d, got_c = TP.propose_depths(t, **kw)
    got_b, got_d2, got_c2 = TP.propose_depth_bins(t, **kw)
    assert got_d.dtype == torch.float32 and got_c.dtype == torch.int32 and got_b.dtype == torch.int32
    for got, want in ((got_d, want_d), (got_c, want_c), (got_b, want_b), (got_d2, want_d), (got_c2, want_c)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_tied_peaks_keep_the_lower_bin_first():
    got_b, got_d, got_c = TP.propose_depth_bins(torch.from_numpy(_tied().astype(np.int32)), num_scales=4)
    assert got_b.tolist() == [3, 9, 13, 0]
    assert got_c.tolist() == [3000, 3000, 1000, 0]
    assert got_d.tolist() == [750.0, 1350.0, 1750.0, 0.0]


def test_min_pixels_and_out_of_range():
    _, counts = TP.propose_depths(torch.from_numpy(_min_pixels().astype(np.int32)), num_scales=2)
    assert counts.tolist() == [250, 0]
    depths, counts = TP.propose_depths(torch.from_numpy(_out_of_range().astype(np.int32)), num_scales=4)
    assert counts.tolist() == [1500, 1500, 1500, 0]  # 400, 1000 and 1999; nothing from 0, 399 or >= 2000
    assert depths.tolist() == [450.0, 1050.0, 1950.0, 0.0]


@pytest.mark.parametrize("kw", [{}, {"bin_mm": 50, "lo_mm": 300, "hi_mm": 1500}])
def test_bin_centers_match_jax(kw):
    np.testing.assert_array_equal(TP.bin_centers(**kw), JP.bin_centers(**kw))


def test_other_bins_match_jax():
    depth = CASES["noisy_planes"]()
    kw = dict(bin_mm=50, lo_mm=300, hi_mm=1800, nms_radius=3, min_pixels=50)
    want = [np.asarray(a) for a in JP.propose_depth_bins(jnp.asarray(depth), **kw)]
    got = TP.propose_depth_bins(torch.from_numpy(depth.astype(np.int32)), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
