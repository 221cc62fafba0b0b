"""Reduction of a ``torch.profiler`` trace of the traced window to what the
per-layer metrics read: the device's busy time (the union of every device
activity: kernels, copies, sets), the kernels by name, and the idle gaps
labelled by what the host was doing.

The busy-time arithmetic is the port's ``utils/timing.py::
device_ms_per_call`` (device time over wall time, one process on one
stream), taken as a union of intervals so that no overlap counts twice.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")
NAME_CHARS = 120  # a kernel's name in the breakdown is cut to this


@dataclasses.dataclass
class Span:
    name: str
    start_us: float
    end_us: float


@dataclasses.dataclass
class Trace:
    """The traced window: device activity and host ops (microseconds on
    the profiler's clock), and the window's bounds."""

    device: List[Span]
    host: List[Span]
    start_us: float
    end_us: float

    @property
    def kernels(self) -> List[Span]:
        return [s for s in self.device if not s.name.startswith(COPY_PREFIXES)]


def from_profiler(prof, window_name: str) -> Optional[Trace]:
    """The ``Trace`` of a finished ``torch.profiler.profile`` whose window
    is the host span ``window_name``; None when the span is missing."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.events():
        span = Span(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name == window_name:
            if e.device_type != DeviceType.CUDA:  # the span's copy on the card's timeline is no device work
                window = span
        elif e.device_type == DeviceType.CUDA:
            device.append(span)
        else:
            host.append(span)
    if window is None:
        return None
    inside = lambda s: s.end_us > window.start_us and s.start_us < window.end_us  # noqa: E731
    return Trace([s for s in device if inside(s)], [s for s in host if inside(s)], window.start_us, window.end_us)


def _union(spans: List[Span], lo: float, hi: float) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s in sorted(spans, key=lambda s: s.start_us):
        a, b = max(s.start_us, lo), min(s.end_us, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(trace: Trace) -> float:
    """Seconds in which some device activity ran inside the window."""
    return sum(b - a for a, b in _union(trace.device, trace.start_us, trace.end_us)) / 1e6


def device_ops(trace: Trace, top: int = 10) -> List[list]:
    """The device operations that took the most time: [name (its first
    ``NAME_CHARS`` characters), seconds]."""
    total: Dict[str, float] = defaultdict(float)
    for s in trace.device:
        total[s.name[:NAME_CHARS]] += (s.end_us - s.start_us) / 1e6
    return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Trace, top: int = 10) -> List[list]:
    """Idle device time inside the window by what the host was doing at
    the start of each gap (the innermost host op then; ``python`` where
    none was open): [label, seconds], the largest first."""
    busy = _union(trace.device, trace.start_us, trace.end_us)
    gaps, t = [], trace.start_us
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if trace.end_us > t:
        gaps.append((t, trace.end_us))
    host = sorted(trace.host, key=lambda s: s.start_us)
    total: Dict[str, float] = defaultdict(float)
    stack: List[Span] = []  # the host ops open at the sweep's time, innermost last
    i = 0
    for a, b in gaps:
        while i < len(host) and host[i].start_us <= a:
            while stack and stack[-1].end_us <= host[i].start_us:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end_us <= a:
            stack.pop()
        total[stack[-1].name[:NAME_CHARS] if stack else "python"] += (b - a) / 1e6
    return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
