"""``device.idle_share``: the share of a frame in which no operation runs on
the card: 1 - the device's busy time a frame in the traced frames
(``core/trace.py``: the union of kernels, copies and sets) over the wall
time a frame of the untraced window took.  The profiler slows the host and
not the card, so the traced frames' own wall time would count its cost as
idle."""

from perfbench.core.trace import busy_s


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.frames == 0 or ctx.frame_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(ctx.trace) / ctx.frames / ctx.frame_s)
