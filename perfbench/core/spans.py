"""The program's stage spans in the traced window: each device operation
given to the stage that enqueued it.

The port names its stages with host spans ``sixdpose.<stage>``
(``sixdpose_tpu_torch/utils/timing.py``) on the profiler's own host
timeline.  A device operation is enqueued by one host call (``ENQUEUE``);
with one stream the card runs them in the order they were enqueued, so the
calls and the device activities of a kind (kernel, copy, set) pair in order
of their starts.  Each call belongs to the innermost ``sixdpose.*`` span open
at its start; a frame's stage spans nest inside its ``sixdpose.frame`` span.

A trace can miss the device records of the first operations of a profiling
session (on an H100 with torch 2.11, up to the first 3 ms of a tiny traced
window, in some sessions after the first of a process).  So each kind pairs
from its last call backwards, and calls left without an activity are
accepted only as such a head: before every paired call of any kind, and at
most one call in a hundred.  Anything else raises rather than give
activities to the wrong stages.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.core.trace import COPY_PREFIXES, Span, Trace

PREFIX = "sixdpose."
FRAME = PREFIX + "frame"
# The host calls that put an operation on the stream, as a card's trace
# names them, by the kind of device activity each enqueues: kernels (the
# CUDA runtime's and the CUDA driver API's launches), copies and sets.
ENQUEUE = {
    "kernel": ("cudaLaunchKernel", "cudaLaunchKernelExC"),
    "copy": ("cudaMemcpyAsync",),
    "set": ("cudaMemsetAsync",),
}
LAUNCH_PREFIX = "cuLaunchKernel"


def _call_kind(name: str) -> Optional[str]:
    if name.startswith(LAUNCH_PREFIX):
        return "kernel"
    return next((k for k, names in ENQUEUE.items() if name in names), None)


def _activity_kind(name: str) -> str:
    if not name.startswith(COPY_PREFIXES):
        return "kernel"
    return "copy" if name[:6].lower() == "memcpy" else "set"


def innermost(calls: List[Span], spans: List[Span]) -> List[Optional[str]]:
    """The name of the innermost span open at each call's start (None
    outside every span); ``calls`` and ``spans`` sorted by start."""
    out: List[Optional[str]] = []
    stack: List[Span] = []  # the spans open at the sweep's time, innermost last
    i = 0
    for c in calls:
        while i < len(spans) and spans[i].start_us <= c.start_us:
            while stack and stack[-1].end_us <= spans[i].start_us:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end_us <= c.start_us:
            stack.pop()
        out.append(stack[-1].name if stack else None)
    return out


def attribute(trace: Optional[Trace], frames: int) -> Optional[List[Tuple[Optional[str], Span]]]:
    """Each device activity of the window with the stage that enqueued it
    (the span's name without ``sixdpose.``, None outside every span), the
    kernels first, then the copies, then the sets.

    None where the window holds no device activity (the CPU) or no program
    span (a program without them).  Raises where the window's
    ``sixdpose.frame`` spans are not ``frames``, or where the calls and the
    device activities of a kind differ in count other than by a lost head."""
    if trace is None or not trace.device:
        return None
    spans = sorted((s for s in trace.host if s.name.startswith(PREFIX)), key=lambda s: s.start_us)
    if not spans:
        return None
    n_frames = sum(s.name == FRAME for s in spans)
    if n_frames != frames:
        raise RuntimeError(f"spans: the window holds {n_frames} {FRAME} spans for {frames} frames")
    kinds = {}
    for kind in ENQUEUE:
        calls = sorted((s for s in trace.host if _call_kind(s.name) == kind), key=lambda s: s.start_us)
        device = sorted((s for s in trace.device if _activity_kind(s.name) == kind), key=lambda s: s.start_us)
        if len(device) > len(calls):
            raise RuntimeError(f"spans: the window holds {len(device)} {kind} activities on the device but "
                               f"{len(calls)} calls that enqueue one ({_names(kind)})")
        kinds[kind] = (calls[: len(calls) - len(device)], calls[len(calls) - len(device):], device)
    lost = [c for head, _, _ in kinds.values() for c in head]
    if lost:
        paired = [calls[0].start_us for _, calls, _ in kinds.values() if calls]
        n_calls = len(lost) + sum(len(calls) for _, calls, _ in kinds.values())
        if not paired or max(c.start_us for c in lost) >= min(paired) or 100 * len(lost) > n_calls:
            counts = ", ".join(f"{len(h) + len(c)} calls and {len(d)} activities of a {k} ({_names(k)})"
                               for k, (h, c, d) in kinds.items())
            raise RuntimeError(f"spans: the window holds {counts}: more than a lost head of the trace")
    out: List[Tuple[Optional[str], Span]] = []
    for _, calls, device in kinds.values():
        out += [(n[len(PREFIX):] if n else None, d) for n, d in zip(innermost(calls, spans), device)]
    return out


def _names(kind: str) -> str:
    return ", ".join(ENQUEUE[kind] + ((LAUNCH_PREFIX + "*",) if kind == "kernel" else ()))


def stage_totals(trace: Optional[Trace], frames: int) -> Optional[Dict[Optional[str], dict]]:
    """Per stage, over the window: ``kernels`` (activities whose names do not
    start as a copy's or a set's, the rule of ``device.launches_per_frame``)
    and ``device_ms`` (the summed durations of every activity: kernels,
    copies and sets).  None as ``attribute``."""
    pairs = attribute(trace, frames)
    if pairs is None:
        return None
    out: Dict[Optional[str], dict] = defaultdict(lambda: {"kernels": 0, "device_ms": 0.0})
    for stage, d in pairs:
        out[stage]["kernels"] += not d.name.startswith(COPY_PREFIXES)
        out[stage]["device_ms"] += (d.end_us - d.start_us) / 1e3
    return dict(out)


def per_frame(ctx, stage: str, key: str) -> Optional[float]:
    """``key`` of ``stage`` a frame over the traced frames; 0 for a stage
    that enqueued nothing, None as ``attribute``."""
    totals = stage_totals(ctx.trace, ctx.frames)
    if totals is None or ctx.frames == 0:
        return None
    return totals.get(stage, {key: 0})[key] / ctx.frames
