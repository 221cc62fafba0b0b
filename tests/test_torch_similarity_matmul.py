"""Port parity of the coarse scorer's plain version
(``ops/similarity.py::similarity_multiscale_sparse``, the route of CPU
tensors, and ``bucket_table``, which places its features) and of
``coarse_scores``' feature-list route against the JAX package's
shift-bucketed matmul route (``similarity_multiscale_matmul``,
``matmul_shift_sum`` and its weight build) and the dense conv, on the CPU.

Every value is a sum of small integers in float32 or an integer count, so
every comparison is exact.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.models import detector as JD
from sixdpose_tpu.ops import similarity as JS
from sixdpose_tpu_torch.convert import DeviceBank
from sixdpose_tpu_torch.models import detector as TD
from sixdpose_tpu_torch.ops import similarity as TS

from coarse_cases import EDGE_CASES, edge_case


def _case(seed, c=16, h=96, w=128, n=23, f=37, kh=33, kw=41, b=None, spill=6):
    """Random maps in 0..4 and feature lists reaching ``spill`` pixels past
    the kernel extent (clipped there), with padded tails."""
    rng = np.random.default_rng(seed)
    shape = (c, h, w) if b is None else (b, c, h, w)
    maps = rng.integers(0, 5, shape).astype(np.uint8)
    feats = np.stack(
        [rng.integers(0, kw + spill, (n, f)), rng.integers(0, kh + spill, (n, f)), rng.integers(0, c, (n, f))], -1
    ).astype(np.int32)
    valid = rng.random((n, f)) < 0.85
    valid[3, :] = False  # a template without features
    valid[5, f // 2 :] = False
    return maps, feats, valid


def _jax(maps, feats, valid, scales, t, kh, kw):
    raw, nf = JS.similarity_multiscale_matmul(
        jnp.asarray(maps), jnp.asarray(feats), jnp.asarray(valid), jnp.asarray(scales, jnp.float32), t, kh, kw
    )
    return np.asarray(raw), np.asarray(nf)


def _torch(maps, feats, valid, scales, t, kh, kw):
    raw, nf = TS.similarity_multiscale_sparse(
        torch.from_numpy(maps), torch.from_numpy(feats), torch.from_numpy(valid),
        torch.tensor(scales, dtype=torch.float32), t, kh, kw,
    )
    return raw.numpy(), nf.numpy()


@pytest.mark.parametrize(
    "scales,t",
    [([1.0], 8), ([1.0], 4), ([0.7, 1.0, 1.3], 8), ([1.0, 0.0, 0.55], 4), ([0.0], 8), ([0.83, 1.17], 5)],
)
def test_multiscale_matmul_matches_jax(scales, t):
    maps, feats, valid = _case(int(t * 10 + len(scales)))
    want_raw, want_nf = _jax(maps, feats, valid, scales, t, 33, 41)
    got_raw, got_nf = _torch(maps, feats, valid, scales, t, 33, 41)
    assert got_raw.dtype == np.float32 and got_nf.dtype == np.int32
    np.testing.assert_array_equal(got_nf, want_nf)
    np.testing.assert_array_equal(got_raw, want_raw)
    if 0.0 in scales:  # an invalid proposal scores nothing
        s0 = scales.index(0.0) * feats.shape[0]
        assert not got_nf[s0 : s0 + feats.shape[0]].any() and not got_raw[s0 : s0 + feats.shape[0]].any()


def test_chunked_build_equals_one_chunk(monkeypatch):
    """Row chunks of the plain version's gather (here 7 rows of a 3 x
    23-row sweep) give the result of one chunk."""
    maps, feats, valid = _case(3)
    scales = [0.9, 1.0, 1.1]
    whole = _torch(maps, feats, valid, scales, 8, 33, 41)
    row_bytes = 37 * 8 * 11 * (8 + 1)  # F x placements x (index + gathered byte) bytes at t = 8, one frame
    monkeypatch.setattr(TS, "_W_CHUNK_BYTES", 7 * row_bytes)
    chunked = _torch(maps, feats, valid, scales, 8, 33, 41)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)


def test_batch_of_frames_equals_single_frames():
    maps, feats, valid = _case(4, b=3)
    raw_b, nf_b = _torch(maps, feats, valid, [1.0, 0.8], 8, 33, 41)
    assert raw_b.shape[0] == 3
    for i in range(3):
        raw, nf = _torch(maps[i], feats, valid, [1.0, 0.8], 8, 33, 41)
        np.testing.assert_array_equal(raw_b[i], raw)
        np.testing.assert_array_equal(nf_b, nf)


@pytest.mark.parametrize("t", [4, 8])
def test_scale_one_equals_dense_conv(t):
    """At scale 1 the plain scorer and the conv of the kernels built from
    the same features give the same integers."""
    maps, feats, valid = _case(5 + t)
    kern = TS.build_template_kernels(feats, valid, 33, 41, 16)
    dense = TS.similarity_dense(torch.from_numpy(maps), torch.from_numpy(kern), t).numpy()
    raw, nf = _torch(maps, feats, valid, [1.0], t, 33, 41)
    np.testing.assert_array_equal(raw, dense)
    np.testing.assert_array_equal(nf, kern.reshape(len(kern), -1).sum(1))


@pytest.mark.parametrize("scale", [1.0, 0.75])
def test_bucket_weights_and_shift_sum_match_jax(scale):
    """``bucket_table``'s counts, and the weights W scattered from it here,
    equal the JAX package's host build (``multiscale_weights_host_bin``),
    and the plain version gives the JAX contraction over those weights
    (``matmul_shift_sum``)."""
    maps, feats, valid = _case(9)
    t, kh, kw = 8, 33, 41
    w_j, nf_j = JS.multiscale_weights_host_bin(feats, valid, scale, t, kh, kw, 16)
    khb, kwb = -(-kh // t), -(-kw // t)
    table = TS.bucket_table(torch.from_numpy(feats), torch.from_numpy(valid), torch.tensor([scale]), t, kh, kw)
    bucket, cprime, ok = (a.numpy() for a in table)
    w_t = np.zeros((khb * kwb, feats.shape[0], 16 * t * t), np.int8)
    rows = np.broadcast_to(np.arange(feats.shape[0])[:, None], ok.shape)
    np.add.at(w_t, (bucket[ok], rows[ok], cprime[ok]), 1)
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(ok.sum(1), nf_j)
    want = np.asarray(JS.matmul_shift_sum(jnp.asarray(maps), jnp.asarray(w_j), t, khb, kwb))
    got_raw, got_nf = _torch(maps, feats, valid, [scale], t, kh, kw)
    np.testing.assert_array_equal(got_raw, want)
    np.testing.assert_array_equal(got_nf, nf_j)


def test_coarse_scores_matmul_branch_matches_jax():
    """The port's coarse_scores on a small feature-list bank (its one route
    for such a bank) against the JAX matmul branch computed explicitly:
    score_normalize(raw, max(nf, 1)), -1 where nf = 0."""
    maps, feats, valid = _case(11, n=17, spill=0)
    t_at_level = (4, 8)
    kern = TS.build_template_kernels(feats, valid, 33, 41, 16)
    raw, nf = JS.similarity_multiscale_matmul(
        jnp.asarray(maps), jnp.asarray(feats), jnp.asarray(valid), jnp.ones((1,), jnp.float32), 8, 33, 41
    )
    want = JS.score_normalize(raw, jnp.maximum(nf, 1))
    want = np.asarray(jnp.where(nf[:, None, None] > 0, want, -1.0))
    pyr = [None, torch.from_numpy(maps)]
    bank = DeviceBank(nfeats=(None, torch.from_numpy(valid.sum(1).astype(np.int32))), whs=(None, None),
                      kdims=(None, (33, 41)), feats=(None, torch.from_numpy(feats)), valids=(None, torch.from_numpy(valid)))
    got = TD.coarse_scores(pyr, bank, t_at_level)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[3] == -1).all()
    # The JAX dense branch on the same bank gives the same scores where a
    # template has features.
    dense = np.asarray(JD.coarse_scores((None, jnp.asarray(maps)), (None, jnp.asarray(kern)),
                                        (None, jnp.asarray(valid.sum(1).astype(np.int32))), t_at_level))
    has = valid.sum(1) > 0
    np.testing.assert_array_equal(got.numpy()[has], dense[has])


@pytest.mark.parametrize("name", EDGE_CASES)
def test_multiscale_sparse_equals_matmul(name):
    """The coarse-scorer kernel's plain version (``similarity_multiscale_sparse``)
    gives the JAX matmul route's raw sums and counts to the bit, frame
    batches included (each frame against JAX's single frame); the cases are
    the kernel's edge cases on the card."""
    maps, feats, valid, scales, t, kh, kw = edge_case(name)
    args = [torch.from_numpy(a) for a in (maps, feats, valid, scales)] + [t, kh, kw]
    got_raw, got_nf = TS.similarity_multiscale_sparse(*args)
    assert got_raw.dtype == torch.float32 and got_nf.dtype == torch.int32
    frames = maps if maps.ndim == 4 else maps[None]
    for i, frame in enumerate(frames):
        want_raw, want_nf = _jax(frame, feats, valid, scales, t, kh, kw)
        got = got_raw[i] if maps.ndim == 4 else got_raw
        assert got.shape == want_raw.shape
        np.testing.assert_array_equal(got.numpy(), want_raw)
        np.testing.assert_array_equal(got_nf.numpy(), want_nf)
    assert got_raw.any()
    for s in np.flatnonzero(scales == 0):  # an empty proposal scores nothing
        rows = slice(s * feats.shape[0], (s + 1) * feats.shape[0])
        assert not got_nf[rows].any() and not got_raw[..., rows, :, :].any()


def test_cpu_tensors_keep_the_matmul_route(monkeypatch):
    """On CPU tensors the coarse dispatch runs the plain version, as the
    local-refine and ICP wrappers run theirs, and never the kernel: its
    launch counter stays where it was."""
    from sixdpose_tpu_torch.ops import coarse_score as CS

    maps, feats, valid = _case(21)
    args = [torch.from_numpy(a) for a in (maps, feats, valid)] + [torch.tensor([1.0, 0.0, 0.8]), 8, 33, 41]
    taken = []
    plain = CS.similarity_multiscale_sparse
    monkeypatch.setattr(CS, "similarity_multiscale_sparse", lambda *a: taken.append(1) or plain(*a))
    before = CS.similarity_multiscale_cuda.launches
    raw, nf = TS.similarity_multiscale_auto(*args)
    assert taken == [1] and CS.similarity_multiscale_cuda.launches == before
    want = plain(*args)
    assert torch.equal(raw, want[0]) and torch.equal(nf, want[1])
