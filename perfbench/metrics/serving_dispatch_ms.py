"""``serving.dispatch_ms``: the mean of the service's own ``fused_dispatch``
stage over the untraced window: the host's enqueue of a fused frame before
its readback (``serving.ServiceMetrics``)."""


def read(ctx):
    total, count = ctx.stages.get("fused_dispatch", (0.0, 0))
    if count == 0:
        return None
    return 1000.0 * total / count
