"""``serving.hypotheses_ms``: the mean of the service's own ``hypotheses``
stage over the untraced window: the host route's per-class budget and each
hypothesis's cloud and seed, built on the host (``serving.ServiceMetrics``;
one a host-route frame).  Nothing where the service has no such stage."""


def read(ctx):
    total, count = ctx.stages.get("hypotheses", (0.0, 0))
    if count == 0:
        return None
    return 1000.0 * total / count
