"""Timing and profiling utilities.

Port of the JAX package's ``utils/timing.py``: a host wall-clock stage
timer (the reference's observability is ad-hoc wall-clock prints, test.cpp:
125-130, Timer_lchf in forest.h:19-36), and the program's stage spans on
``torch.profiler``'s own host timeline.

A span (``span``, ``frame_entry``, each ``StageTimer`` stage) is a
FUNCTION-scope record-function range named ``sixdpose.<stage>``: a host
event on the profiler's clock, beside the ops and CUDA calls it encloses,
with no copy on the card's timeline (``record_function``'s USER_SCOPE ranges
get one, which a trace reader would count as device work).  Spans are on
exactly while a ``torch.profiler`` profile records, and cost one global read
otherwise.
"""

from __future__ import annotations

import contextlib
import functools
import statistics
import threading
import time
from typing import Dict

import torch
import torch.autograd.profiler as _profiler

SPAN_PREFIX = "sixdpose."
_OFF = contextlib.nullcontext()


def span(name: str):
    """The stage span ``sixdpose.<name>`` around a ``with`` block while the
    profiler records; the shared no-op context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


def stage(name: str):
    """Decorator: every call of the function is the span ``sixdpose.<name>``."""

    def wrap(fn):
        @functools.wraps(fn)
        def staged(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return staged

    return wrap


_frames = threading.local()  # per host thread: whether a frame's entry is open


def frame_entry(fn):
    """Decorator of a frame's entry point: the whole call is the frame's
    ``sixdpose.frame`` span, the parent of its stage spans.  An entry called
    inside another (the service's frame calls a pipeline or a matcher) opens
    no second one."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if not _profiler._is_profiler_enabled or getattr(_frames, "open", False):
            return fn(*args, **kwargs)
        _frames.open = True
        try:
            with span("frame"):
                return fn(*args, **kwargs)
        finally:
            _frames.open = False

    return entry


class StageTimer:
    """Accumulating wall-clock stage timer (Timer_lchf analog); each stage
    is also the span of its name.

    >>> timer = StageTimer()
    >>> with timer("match"):
    ...     run_match()
    >>> timer.mean_ms("match")
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self, name: str) -> float:
        return 1000.0 * self.totals[name] / max(self.counts.get(name, 0), 1)


def ms_per_call(fn, reps: int, device) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` back-to-back calls: CUDA
    events around them on a card, the host clock on the CPU.  Warm up
    first."""
    if torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def median_ms_per_call(fn, reps: int, repeats: int, device) -> float:
    """The median of ``repeats`` windows of ``ms_per_call(fn, reps,
    device)``, after one warm-up call."""
    fn()
    return statistics.median(ms_per_call(fn, reps, device) for _ in range(repeats))


def device_ms_per_call(fn, reps: int) -> dict:
    """This process's device time per call of ``fn`` on the card and the
    wall time per call, over ``reps`` calls under ``torch.profiler`` (the
    sum of kernel self times: one stream, so they do not overlap; the
    profiler lengthens the wall time).  Warm up first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA]
    device = sum(getattr(r, "self_device_time_total", 0.0) for r in rows) / 1e3 / reps
    return {"device_ms": device, "wall_ms": wall, "kernels": sum(r.count for r in rows) / reps}
