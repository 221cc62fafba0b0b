"""``coarse.launches_per_frame``: the kernels enqueued inside the program's
``sixdpose.coarse`` span (the coarse scorer, from the coarsest response
maps to the score grid handed to top-K) in the traced window, over the
frames completed in it (``core/spans.py``)."""

from perfbench.core.spans import per_frame


def read(ctx):
    return per_frame(ctx, "coarse", "kernels")
