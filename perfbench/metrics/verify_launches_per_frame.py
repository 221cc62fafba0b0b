"""``verify.launches_per_frame``: the kernels enqueued inside the program's
``sixdpose.verify`` span (on the host route, one verification call a
matched class) in the traced window, over the frames completed in it
(``core/spans.py``)."""

from perfbench.core.spans import per_frame


def read(ctx):
    return per_frame(ctx, "verify", "kernels")
