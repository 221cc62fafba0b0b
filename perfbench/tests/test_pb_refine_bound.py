"""The copied byte count of the local-refine kernel reproduces the bounds
that the port's chip script read on the main paths (``PERF.md``, the
table of kernels): 0.00091 ms at the bench workload's B=1 level-0 call and
0.00097 ms at the multi-class K=1152 pool, both at threshold 30.  The
calls are recorded from the port's CPU path, which runs the same inputs
through the kernel's plain version."""

import numpy as np
import pytest
import torch

from perfbench.metrics.local_refine_roofline import refine_bound

LOW_THRESHOLD = 30.0


@pytest.fixture()
def recorded(monkeypatch):
    from sixdpose_tpu_torch.models import detector as D

    calls, orig = [], D.similarity_local_sparse_auto

    def rec(maps, feats, valid, origins, t, window=16, scale=None, active=None):
        calls.append(dict(maps=maps, feats=feats, valid=valid, origins=origins, t=t, window=window, scale=scale,
                          active=active))
        return orig(maps, feats, valid, origins, t, window, scale, active)

    monkeypatch.setattr(D, "similarity_local_sparse_auto", rec)
    return calls


def test_bound_at_bench_b1(recorded):
    from sixdpose_tpu_torch import synthetic
    from sixdpose_tpu_torch.config import DetectorConfig
    from sixdpose_tpu_torch.models.detector import Detector

    cid, templates, rgb, dep = synthetic.bench_bank()
    det = Detector(DetectorConfig(t_at_level=(5, 8)), device="cpu")
    for tl in templates:
        det.bank.add_template_levels(cid, tl)
    det.match_arrays(rgb ^ np.uint8(1), dep, LOW_THRESHOLD, cid)  # the chip script's last B=1 call
    b = refine_bound(recorded[-1])
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"], 5) == 0.00091


def test_bound_at_multiclass_pool(recorded):
    from sixdpose_tpu_torch import synthetic
    from sixdpose_tpu_torch.models.multiclass import MultiClassMatcher

    w = synthetic.multiclass_workload()
    mc = MultiClassMatcher(synthetic.multiclass_detector(w, "cpu"), device="cpu")
    mc.match(w["rgb"], w["depth"], LOW_THRESHOLD)
    call = recorded[-1]
    assert call["feats"].shape[0] == 1152
    b = refine_bound(call)
    assert round(b["bound_ms"], 5) == 0.00097


def test_bound_counts_each_touched_byte_once():
    maps = torch.zeros((2, 64, 64), dtype=torch.uint8)
    feats = torch.tensor([[[0, 0, 0], [0, 0, 0]]], dtype=torch.int32)  # one feature twice: one window read
    call = dict(maps=maps, feats=feats, valid=torch.ones((1, 2), dtype=torch.bool),
                origins=torch.zeros((1, 2), dtype=torch.int32), t=4, window=16, scale=None, active=None)
    b = refine_bound(call)
    per_cand = 2 * 12 + 2 + 8
    assert b["bytes"] == 16 * 16 + per_cand + 16 * 16 * 4 + 4
    assert b["ops"] == 2 * 16 * 16
