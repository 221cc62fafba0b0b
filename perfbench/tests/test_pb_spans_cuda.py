"""The stage metrics on the card, in each tiny cell: a traced run reads them,
every kernel of the traced frames was enqueued inside a stage span (none
outside every span, none in the frame's span alone), and the stages' kernel
counts add up to ``device.launches_per_frame``.  Run on the GPU machine with
``python -m pytest -p no:cacheprovider -m cuda perfbench/tests/test_pb_spans_cuda.py``."""

import time

import pytest
import torch

import pb_tiny
from perfbench.core import harness
from perfbench.core.spans import stage_totals

CELLS = ("tless.served", "linemod.match", "tless.match")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.tiny_root(tmp_path_factory.mktemp("pbspans"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_stages_hold_every_kernel_of_the_traced_frames(card, root, cell, monkeypatch):
    seen = {}
    real = harness.Context

    def keep(*a, **k):
        ctx = real(*a, **k)
        seen["totals"], seen["frames"] = stage_totals(ctx.trace, ctx.frames), ctx.frames
        return ctx

    monkeypatch.setattr(harness, "Context", keep)
    res = harness.run_cell(root, cell, pb_tiny.SEED, 1.0, True, card, time.perf_counter())
    assert res["correct"] is True
    m = res["metrics"]
    names = ["coarse.launches_per_frame", "coarse.device_ms"]
    if cell == "tless.served":
        names += ["icp.launches_per_frame", "icp.device_ms"]
    for name in names:
        assert m[name]["value"] > 0, name
    totals = seen["totals"]
    assert None not in totals and "frame" not in totals and "fused_dispatch" not in totals, totals
    kernels = sum(t["kernels"] for t in totals.values()) / seen["frames"]
    assert kernels == m["device.launches_per_frame"]["value"]
    assert m["coarse.launches_per_frame"]["value"] == totals["coarse"]["kernels"] / seen["frames"]
