"""The port's stage spans (``utils/timing.py``) on the CPU: one frame of each
route under ``torch.profiler`` records one ``sixdpose.frame`` span and one
span of each of its stages, nested inside it, as FUNCTION-scope host events
(no user annotation, so no copy on a card's timeline); the outputs are the
same bits with the profiler on and off; with no profiler a span is the
shared no-op context and nothing is recorded.

This pins torch's private names the spans rest on
(``torch._C._profiler._RecordFunctionFast``,
``torch.autograd.profiler._is_profiler_enabled``): an upgrade that drops
them fails here instead of losing the spans.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.models import detector as D
from sixdpose_tpu_torch.models.multiclass import MultiClassMatcher
from sixdpose_tpu_torch.models.multiscale import MultiScaleMultiClass
from sixdpose_tpu_torch.models.pipeline import FusedMultiClassPipeline
from sixdpose_tpu_torch.utils import timing

MATCH = ["upload", "pyramid", "coarse", "topk", "refine", "nms"]
STAGES = {
    "fused": MATCH + ["select", "icp", "verify"],
    "multiclass": MATCH + ["readback"],
    "multiclass_matmul": MATCH + ["readback"],
    "multiscale": MATCH[:2] + ["proposals"] + MATCH[2:] + ["readback"],
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def routes():
    """One frame of each route at a cut size: the fused multi-class frame,
    ``MultiClassMatcher.match`` (the dense coarse conv, and the matmul
    scorer of the benchmark's banks), ``MultiScaleMultiClass.match``; the
    matchers at thresholds that keep matches (142 and 17)."""
    w = synthetic.multiclass_workload(classes=3, views=6)
    det = synthetic.multiclass_detector(w, "cpu")
    args = dict(synthetic.multiclass_pipeline_args(w), max_refine=4, icp_seeds=2)
    pipe = FusedMultiClassPipeline(det, w["K"], device="cpu", **args)
    mc = MultiClassMatcher(det, device="cpu")
    ws = synthetic.multiscale_workload(classes=2, views=4)
    ms = MultiScaleMultiClass(synthetic.multiscale_detector(ws, "cpu"), ws["train_depth"],
                              num_scales=ws["num_scales"], device="cpu")

    @contextlib.contextmanager
    def matmul():
        macs, D._MATMUL_MACS = D._MATMUL_MACS, 0
        try:
            yield
        finally:
            D._MATMUL_MACS = macs

    return {
        "fused": (contextlib.nullcontext, lambda: pipe(w["rgb"], w["depth"], w["threshold"])),
        "multiclass": (contextlib.nullcontext, lambda: mc.match(w["rgb"], w["depth"], 40.0)),
        "multiclass_matmul": (matmul, lambda: mc.match(w["rgb"], w["depth"], 40.0)),
        "multiscale": (contextlib.nullcontext, lambda: ms.match(ws["rgb"], ws["depth"], 55.0)),
    }


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith(timing.SPAN_PREFIX)]


@pytest.mark.parametrize("route", sorted(STAGES))
def test_a_frame_records_one_span_of_each_stage_inside_its_frame(routes, route):
    ctx, run = routes[route]
    with ctx():
        run()  # warm
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
    spans = _spans(prof)
    counts = collections.Counter(e.name for e in spans)
    assert counts == collections.Counter(timing.SPAN_PREFIX + s for s in ["frame"] + STAGES[route])
    frame = next(e for e in spans if e.name == "sixdpose.frame")
    for e in spans:
        assert not e.is_user_annotation and e.device_type == torch.autograd.DeviceType.CPU
        if e is not frame:
            assert e.cpu_parent is frame  # a stage nests in the frame, not in another stage
            assert frame.time_range.start <= e.time_range.start <= e.time_range.end <= frame.time_range.end
    order = [e.name[len(timing.SPAN_PREFIX):] for e in sorted(spans, key=lambda e: e.time_range.start)]
    assert order == ["frame"] + STAGES[route]


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out.numpy()]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [np.asarray([getattr(out, k) for k in ("x", "y", "similarity", "template_id")], np.float64),
            np.asarray([str(out.class_id)])]


@pytest.mark.parametrize("route", sorted(STAGES))
def test_outputs_are_the_same_bits_with_the_profiler_on_and_off(routes, route):
    ctx, run = routes[route]
    with ctx():
        off = _flat(run())
        with profile(activities=[ProfilerActivity.CPU]):
            on = _flat(run())
    assert len(on) == len(off) and len(off) > 0
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_without_a_profiler_a_span_is_the_shared_no_op_and_records_nothing():
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert timing.span("coarse") is timing.span("icp") is timing._OFF
    calls = []

    @timing.frame_entry
    def entry(x):
        with timing.span("coarse"):
            calls.append(x)
        return x + 1

    @timing.stage("topk")
    def step(x):
        return x * 2

    assert entry(1) == 2 and step(3) == 6 and calls == [1]
    # A profile opened afterwards holds nothing from before it.
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timing.span("coarse") is not timing._OFF
    assert _spans(prof) == []


def test_an_entry_inside_an_entry_opens_no_second_frame():
    @timing.frame_entry
    def inner():
        with timing.span("coarse"):
            return torch.ones(2) + 1

    @timing.frame_entry
    def outer():
        with timing.span("upload"):
            torch.zeros(2)
        return inner()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outer()
        inner()
    names = [e.name for e in sorted(_spans(prof), key=lambda e: e.time_range.start)]
    assert names == ["sixdpose.frame", "sixdpose.upload", "sixdpose.coarse", "sixdpose.frame", "sixdpose.coarse"]


def test_stage_timer_keeps_its_totals_and_records_its_spans():
    timer = timing.StageTimer()
    with timer("match"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer("match"):
            pass
        with pytest.raises(ValueError):
            with timer("icp"):
                raise ValueError("a failed stage still counts")
    assert timer.counts == {"match": 2, "icp": 1} and set(timer.totals) == {"match", "icp"}
    assert timer.mean_ms("match") >= 0.0
    assert sorted(e.name for e in _spans(prof)) == ["sixdpose.icp", "sixdpose.match"]
