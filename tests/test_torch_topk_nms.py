"""Port parity: ops/topk_nms.py (torch) against the JAX package.

Selections are indices and masks: they must be identical.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.ops import topk_nms as JK
from sixdpose_tpu_torch.ops import topk_nms as TK


def _t(a):
    return torch.from_numpy(np.array(a))


def test_topk_tie_order():
    """Ties keep the lower flat index first, as jax.lax.top_k does."""
    s = np.array([3, 1, 3, 2, 3], np.float32).reshape(1, 1, 5)
    tid, y, x, score = TK.topk_candidates(_t(s), 0.5, 4)
    assert x.tolist() == [0, 2, 4, 3]
    jt = JK.topk_candidates(jnp.asarray(s), 0.5, 4)
    for a, b in zip((tid, y, x, score), jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("k", [16, 64])
def test_topk_candidates_with_ties(rng, k):
    """Scores on the 100/(4*nfeat) grid, so ties are common; a batch of two
    frames gives the per-frame selections."""
    nfeat = 25
    raw = rng.integers(0, 4 * nfeat + 1, (2, 6, 9, 11))
    s = (raw * (100.0 / (4 * nfeat))).astype(np.float32)
    tb = TK.topk_candidates(_t(s), 60.0, k)
    for b in range(2):
        jt = JK.topk_candidates(jnp.asarray(s[b]), 60.0, k, exact=True)
        for a, j in zip(tb, jt):
            np.testing.assert_array_equal(a[b].numpy(), np.asarray(j))


def _boxes(rng, k):
    xy = rng.integers(0, 60, (k, 2))
    wh = rng.integers(5, 30, (k, 2))
    boxes = np.concatenate([xy, wh], 1).astype(np.float32)
    score = np.sort(rng.uniform(0, 100, k).astype(np.float32))[::-1].copy()
    score[rng.random(k) < 0.2] = -1.0
    return boxes, np.sort(score)[::-1].copy()


@pytest.mark.parametrize("iou", [0.3, 0.5])
def test_nms_boxes(rng, iou):
    boxes, score = _boxes(rng, 48)
    keep = TK.nms_boxes(_t(boxes), _t(score), iou).numpy()
    np.testing.assert_array_equal(keep, np.asarray(JK.nms_boxes(jnp.asarray(boxes), jnp.asarray(score), iou)))
    assert 0 < keep.sum() < (score >= 0).sum()
    b2, s2 = _boxes(rng, 48)
    kb = TK.nms_boxes(_t(np.stack([boxes, b2])), _t(np.stack([score, s2])), iou).numpy()
    np.testing.assert_array_equal(kb[0], keep)
    np.testing.assert_array_equal(kb[1], np.asarray(JK.nms_boxes(jnp.asarray(b2), jnp.asarray(s2), iou)))


def test_dedupe_exact(rng):
    k = 40
    tids = rng.integers(0, 3, k).astype(np.int32)
    ys = rng.integers(0, 4, k).astype(np.int32)
    xs = rng.integers(0, 4, k).astype(np.int32)
    score = np.sort(rng.uniform(-5, 100, k).astype(np.float32))[::-1].copy()
    keep = TK.dedupe_exact(_t(tids), _t(ys), _t(xs), _t(score)).numpy()
    # The JAX function builds int64 keys, so it needs 64-bit mode.
    with jax.enable_x64(True):
        j = np.asarray(JK.dedupe_exact(jnp.asarray(tids), jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(score)))
    np.testing.assert_array_equal(keep, j)
    assert keep.sum() < (score >= 0).sum()
