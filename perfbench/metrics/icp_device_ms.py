"""``icp.device_ms``: the card's time a frame on the operations enqueued
inside the program's ``sixdpose.icp`` span (kernels, copies and sets) in
the traced window (``core/spans.py``)."""

from perfbench.core.spans import per_frame


def read(ctx):
    return per_frame(ctx, "icp", "device_ms")
