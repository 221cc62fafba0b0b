"""``icp.launches_per_frame``: the kernels enqueued inside the program's
``sixdpose.icp`` span (seeding, the seed fan, the scene maps, batched ICP
and the pose composition) in the traced window, over the frames completed
in it (``core/spans.py``)."""

from perfbench.core.spans import per_frame


def read(ctx):
    return per_frame(ctx, "icp", "kernels")
