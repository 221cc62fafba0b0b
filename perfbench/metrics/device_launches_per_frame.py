"""``device.launches_per_frame``: the CUDA kernels that the profiler counts
in the traced window, over the frames completed in it."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or ctx.frames == 0:
        return None
    return len(ctx.trace.kernels) / ctx.frames
