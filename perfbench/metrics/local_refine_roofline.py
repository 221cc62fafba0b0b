"""``local_refine.roofline``: the local-refine kernel's share of its
roofline over the traced window: the least time its launches could take,
over the time the profiler saw them take on the card.

The least time of one launch is the larger of its bytes over the card's
memory rate and its adds over the float32 rate (``core/peaks.py``).  Its
bytes are what these inputs need, each once: the map bytes that its live
in-range windows touch, its feature tables and its outputs; one add per
touched window cell (the count of ``chip_smoke.py``'s ``refine_bound``,
copied here with the refine contract's feature table so that the yardstick
does not move with the program).
"""

from __future__ import annotations

import torch

from perfbench.core.peaks import H100

KERNEL = "local_refine_kernel"


def _feature_table(feats, valid, origins, t: int, hb: int, wb: int, scale=None):
    """Per (candidate, feature): (ok, cprime, by, bx) of the refine
    contract (the port's ``ops/similarity.py::_feature_table``)."""
    x = feats[..., 0]
    y = feats[..., 1]
    if scale is not None:
        sc = scale[..., None].to(torch.float32)
        x = torch.round(x.to(torch.float32) * sc).to(torch.int32)
        y = torch.round(y.to(torch.float32) * sc).to(torch.int32)
    ch = feats[..., 2]
    ok = valid & (x >= 0) & (y >= 0)
    cprime = ch * (t * t) + (y % t) * t + (x % t)
    by = origins[..., 0:1] // t + y // t
    bx = origins[..., 1:2] // t + x // t
    ok = ok & (by < hb) & (bx < wb)
    return ok, cprime, by.clamp(0, hb - 1), bx.clamp(0, wb - 1)


def refine_bound(c: dict, peaks: dict = H100) -> dict:
    """Least bytes, adds and time (ms) of one local-refine call on its
    inputs ``c`` (maps, feats, valid, origins, t, window, scale, active)."""
    single = c["maps"].dim() == 3
    maps, feats, valid, origins, scale, active = (
        x[None] if single and x is not None else x
        for x in (c["maps"], c["feats"], c["valid"], c["origins"], c["scale"], c["active"])
    )
    b, ch, h, w = maps.shape
    t, win = c["t"], c["window"]
    hb, wb = -(-h // t), -(-w // t)
    ok, cprime, by, bx = _feature_table(feats, valid, origins, t, hb, wb, scale)
    if active is not None:
        ok = ok & active[..., None]
    chan, dy, dx = cprime // (t * t), (cprime % (t * t)) // t, cprime % t
    steps = torch.arange(win, device=maps.device)
    rows = (by[..., None] + steps) * t + dy[..., None]  # (B, K, F, win)
    cols = (bx[..., None] + steps) * t + dx[..., None]
    cell = ok[..., None, None] & (rows[..., :, None] < h) & (cols[..., None, :] < w)
    frame = torch.arange(b, device=maps.device).view(b, 1, 1, 1, 1)
    addr = (((frame * ch + chan[..., None, None]) * h + rows[..., :, None]) * w + cols[..., None, :]).long()
    touched = torch.zeros(maps.numel(), dtype=torch.bool, device=maps.device)
    touched[addr[cell]] = True
    k, f = feats.shape[1:3]
    per_cand = f * 12 + f + 8 + (4 if scale is not None else 0) + (1 if active is not None else 0)
    nbytes = int(touched.sum()) + b * k * per_cand + b * k * (win * win * 4 + 4)
    ops = int(cell.sum())
    t_bytes = nbytes / peaks["hbm_bytes_per_s"] * 1e3
    t_ops = ops / peaks["fp32_ops_per_s"] * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def read(ctx):
    """None where the traced frames launched no local-refine kernel; an
    error where the kernel ran but its calls were not all recorded (the
    program reaches it other than through ``models/detector.py``'s
    dispatch), so that the metric cannot go silent while the kernel runs."""
    if ctx.trace is None:
        return None
    launches = [s for s in ctx.trace.kernels if KERNEL in s.name]
    if not launches:
        return None
    if len(launches) != len(ctx.refine_calls):
        raise RuntimeError(f"local_refine.roofline: the trace holds {len(launches)} launches of {KERNEL} but "
                           f"{len(ctx.refine_calls)} calls were recorded through models/detector.py's dispatch")
    spent_ms = sum(s.end_us - s.start_us for s in launches) / 1e3
    least_ms = sum(refine_bound(c, ctx.peaks)["bound_ms"] for c in ctx.refine_calls)
    return 100.0 * least_ms / spent_ms
