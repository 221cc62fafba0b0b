"""The stage attribution of ``core/spans.py`` and the four readers over it,
on hand-built traces: the i-th enqueuing call of a kind (by start) pairs
with the i-th device activity of that kind and goes to the innermost
``sixdpose.*`` span open at its start; a lost head of the trace pairs from
the end, and a count that differs otherwise raises; without device
activity or program spans nothing is read."""

import pytest

import pb_tiny
from perfbench.core import spans as S
from perfbench.core.harness import Context, _reader
from perfbench.core.peaks import H100
from perfbench.core.trace import Span, Trace

READERS = ("coarse.launches_per_frame", "coarse.device_ms", "icp.launches_per_frame", "icp.device_ms")


def _trace(frames=1, extra_call=False, device=True):
    """``frames`` frames of: a coarse stage with two kernels and a copy, a
    nested refine-in-coarse span with one kernel, and an icp stage with one
    kernel and a set; host ops and non-enqueuing CUDA calls around them.
    The lists are out of order, as nothing promises them sorted."""
    host, dev = [], []
    for f in range(frames):
        o = 1000.0 * f
        host += [
            Span("sixdpose.frame", o + 0, o + 100),
            Span("sixdpose.coarse", o + 10, o + 50),
            Span("aten::addmm", o + 11, o + 14),
            Span("cudaLaunchKernelExC", o + 12, o + 13),
            Span("cuLaunchKernelEx", o + 15, o + 16),
            Span("cudaMemcpyAsync", o + 20, o + 21),
            Span("sixdpose.refine", o + 30, o + 40),
            Span("cudaLaunchKernel", o + 31, o + 32),
            Span("cudaStreamSynchronize", o + 45, o + 46),
            Span("sixdpose.icp", o + 60, o + 90),
            Span("cudaLaunchKernel", o + 61, o + 62),
            Span("cudaMemsetAsync", o + 70, o + 71),
        ]
        # Each activity runs after its call, on one stream, in the order of
        # the calls; durations tell them apart.
        dev += [
            Span("sm80_xmma_gemm", o + 100, o + 101),
            Span("triton_kernel", o + 102, o + 104),
            Span("Memcpy DtoD (Device -> Device)", o + 105, o + 109),
            Span("local_refine_kernel", o + 110, o + 118),
            Span("icp_kernel", o + 120, o + 136),
            Span("Memset (Device)", o + 140, o + 172),
        ]
    if extra_call:
        host.append(Span("cudaLaunchKernel", 95.0, 96.0))  # a launch whose kernel the trace lost
    return Trace(list(reversed(dev)) if device else [], list(reversed(host)), 0.0, 1000.0 * frames)


def _ctx(trace, frames):
    return Context(trace, frames, 0.5, {}, [], H100)


def test_calls_pair_in_enqueue_order_with_the_innermost_span():
    pairs = S.attribute(_trace(), 1)
    assert [(stage, d.name) for stage, d in pairs] == [
        ("coarse", "sm80_xmma_gemm"), ("coarse", "triton_kernel"), ("refine", "local_refine_kernel"),
        ("icp", "icp_kernel"), ("coarse", "Memcpy DtoD (Device -> Device)"), ("icp", "Memset (Device)"),
    ]


def test_each_kind_pairs_on_its_own():
    """A copy enqueued between two launches pairs with the copy, whatever
    the device's timing of the kernels around it."""
    t = _trace()
    t.device = [Span("Memcpy DtoD (Device -> Device)", 101.5, 101.6) if s.name.startswith("Memcpy") else s
                for s in t.device]
    assert ("coarse", "Memcpy DtoD (Device -> Device)") in [(stage, d.name) for stage, d in S.attribute(t, 1)]


def test_a_call_outside_every_stage_goes_to_the_frame_or_to_none():
    t = _trace()
    t.host += [Span("cudaLaunchKernel", 5.0, 6.0), Span("cudaLaunchKernel", 200.0, 201.0)]
    t.device += [Span("early", 99.0, 99.5), Span("late", 300.0, 301.0)]
    stage = {d.name: st for st, d in S.attribute(t, 1)}
    assert stage["early"] == "frame" and stage["late"] is None


def test_stage_totals_count_kernels_as_the_device_metric_does_and_time_every_activity():
    totals = S.stage_totals(_trace(frames=2), 2)
    assert totals == {"coarse": {"kernels": 4, "device_ms": pytest.approx(0.014)},
                      "refine": {"kernels": 2, "device_ms": pytest.approx(0.016)},
                      "icp": {"kernels": 2, "device_ms": pytest.approx(0.096)}}
    assert sum(t["kernels"] for t in totals.values()) == len(_trace(frames=2).kernels)


@pytest.mark.parametrize("name, want", [("coarse.launches_per_frame", 2.0), ("coarse.device_ms", 0.007),
                                        ("icp.launches_per_frame", 1.0), ("icp.device_ms", 0.048)])
def test_readers_give_a_stage_a_frame(name, want):
    read = _reader(pb_tiny.REPO, name)
    assert read(_ctx(_trace(frames=2), 2)) == pytest.approx(want)


def test_a_stage_that_enqueued_nothing_reads_zero():
    t = _trace()
    t.host = [s for s in t.host if s.name != "sixdpose.icp"]
    assert S.per_frame(_ctx(t, 1), "icp", "kernels") == 0  # its work went to the frame
    assert S.stage_totals(t, 1)["frame"] == {"kernels": 1, "device_ms": pytest.approx(0.048)}


def _uploaded(frames=40):
    """``_trace`` whose frames each begin with an upload: a copy enqueued
    before any kernel, as the port's frames begin (8 calls a frame)."""
    t = _trace(frames)
    for f in range(frames):
        t.host.append(Span("cudaMemcpyAsync", 1000.0 * f + 1, 1000.0 * f + 2))
        t.device.append(Span("Memcpy HtoD (Pageable -> Device)", 1000.0 * f + 95, 1000.0 * f + 96))
    return t


def _drop(t, *names_at):
    t.device = [d for d in t.device if (d.name, d.start_us) not in names_at]
    return t


def test_a_lost_head_of_the_trace_pairs_from_the_end():
    """The records of a session's first operations missing: the rest pair
    as they would in the whole trace."""
    whole = S.attribute(_uploaded(), 40)
    head = S.attribute(_drop(_uploaded(), ("Memcpy HtoD (Pageable -> Device)", 95.0), ("sm80_xmma_gemm", 100.0)), 40)
    lost = [p for p in whole if p[1].start_us in (95.0, 100.0)]
    assert len(lost) == 2 and head == [p for p in whole if p not in lost]


@pytest.mark.parametrize("case", ["a record lost after the head", "a head of more than one call in a hundred",
                                  "an activity without a call"])
def test_calls_and_activities_that_differ_in_count_otherwise_raise(case):
    t = _uploaded()
    if case == "a record lost after the head":
        _drop(t, ("sm80_xmma_gemm", 20100.0))
    elif case == "a head of more than one call in a hundred":
        _drop(t, ("Memcpy HtoD (Pageable -> Device)", 95.0), ("sm80_xmma_gemm", 100.0), ("triton_kernel", 102.0),
              ("Memcpy DtoD (Device -> Device)", 105.0), ("local_refine_kernel", 110.0))
    else:
        t.device.append(Span("stray_kernel", 39990.0, 39991.0))
    match = "more than a lost head" if case != "an activity without a call" else "161 kernel activities .* 160 calls"
    with pytest.raises(RuntimeError, match=match):
        S.attribute(t, 40)
    for name in READERS:
        with pytest.raises(RuntimeError, match=match):
            _reader(pb_tiny.REPO, name)(_ctx(t, 40))


def test_a_lost_head_of_a_short_window_raises():
    with pytest.raises(RuntimeError, match="5 calls and 4 activities of a kernel .* more than a lost head"):
        S.attribute(_trace(extra_call=True), 1)


@pytest.mark.parametrize("frames", [1, 3])
def test_frame_spans_other_than_the_frames_raise(frames):
    with pytest.raises(RuntimeError, match="2 sixdpose.frame spans for"):
        S.attribute(_trace(frames=2), frames)
    for name in READERS:
        with pytest.raises(RuntimeError, match="sixdpose.frame"):
            _reader(pb_tiny.REPO, name)(_ctx(_trace(frames=2), frames))


@pytest.mark.parametrize("case", ["no trace", "no device activity", "no program span"])
def test_nothing_is_read_without_device_activity_or_program_spans(case):
    t = None if case == "no trace" else _trace(device=case != "no device activity")
    if case == "no program span":  # a program without spans: the readers stay silent, they do not raise
        t.host = [s for s in t.host if not s.name.startswith(S.PREFIX)]
    assert S.attribute(t, 1) is None and S.stage_totals(t, 1) is None
    for name in READERS:
        assert _reader(pb_tiny.REPO, name)(_ctx(t, 1)) is None
