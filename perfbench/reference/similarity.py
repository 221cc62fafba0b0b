"""Template similarity over response maps: the coarse scorer as
shift-bucketed matmuls and the plain local refinement (copy of the
port's ``ops/similarity.py``; the reference always runs the plain
version of the local refinement, never the port's CUDA kernel).
Scores are integers summed exactly in any order, then normalized
(``score_normalize``), which ``precision.rounded`` can lower for the
control.

Frozen at commit 354f402 as part of the benchmark's yardstick: later
changes to the port do not reach it.  Plain PyTorch and NumPy; imports
nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.precision import rounded

def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _s2d_maps(response_maps: torch.Tensor, t: int) -> torch.Tensor:
    """Space-to-depth: (..., C, H, W) -> (..., C*t*t, H/t, W/t), padding H
    and W up to multiples of t.  Channel order: c * t*t + dy * t + dx."""
    c, h, w = response_maps.shape[-3:]
    lead = response_maps.shape[:-3]
    hp, wp = _ceil_to(h, t), _ceil_to(w, t)
    r = F.pad(response_maps, (0, wp - w, 0, hp - h))
    r = r.reshape(*lead, c, hp // t, t, wp // t, t)
    n = len(lead)
    r = r.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
    return r.reshape(*lead, c * t * t, hp // t, wp // t)


# Bytes of one row chunk of the float32 shift-bucketed weights W.  An 80 GB
# H100 holds the 9 x 810-template bank's whole W (0.48 GB) and a 15 x
# 337-template VGA bank's (0.33 GB) in one chunk beside the bank and a fused
# frame's ICP buffers; larger sweeps (many scales) build and contract W a
# chunk at a time, so its peak stays at 1 GiB.
_W_CHUNK_BYTES = 1 << 30


def _bucket_slices(maps_s2d: torch.Tensor, khb: int, kwb: int) -> torch.Tensor:
    """The s2d maps (B, ct2, hb, wb) under each shift bucket b = dy * kwb + dx:
    (khb * kwb, ct2, B * ho * wo) float32, bucket b holding the window at
    (dy, dx) of every frame (column = frame * ho * wo + y * wo + x)."""
    b_n, ct2, hb, wb = maps_s2d.shape
    ho, wo = hb - khb + 1, wb - kwb + 1
    m = maps_s2d.to(torch.float32).transpose(0, 1)  # (ct2, B, hb, wb)
    return torch.stack(
        [m[:, :, dy : dy + ho, dx : dx + wo].reshape(ct2, b_n * ho * wo) for dy in range(khb) for dx in range(kwb)]
    )


def _bucket_weights(bucket: torch.Tensor, cprime: torch.Tensor, ok: torch.Tensor, bh: int, ct2: int) -> torch.Tensor:
    """The shift-bucketed weights of a row chunk: (rows, F) bucket ids,
    s2d channels and masks -> W (bh, rows, ct2) float32 with W[b, r, c] the
    number of valid features f of row r at (bucket, cprime) = (b, c).

    One scatter-add of the masks (masked features add 0 at a clamped
    index).  The JAX package builds W as a batched one-hot matmul because
    scatters are serial on the TPU; on the card a scatter-add is one
    parallel pass, and its float sums of 0/1 are exact in any order."""
    rows = bucket.shape[0]
    row = torch.arange(rows, device=bucket.device)[:, None]
    idx = (bucket.clamp(0, bh - 1).to(torch.int64) * rows + row) * ct2 + cprime.clamp(0, ct2 - 1).to(torch.int64)
    w = torch.zeros(bh * rows * ct2, dtype=torch.float32, device=bucket.device)
    w.scatter_add_(0, idx.reshape(-1), ok.to(torch.float32).reshape(-1))
    return w.reshape(bh, rows, ct2)


def _matmul_shift_sum_s2d(slices: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_b W[b] @ slices[b]: weights (bh, SN, ct2) and bucket slices (bh,
    ct2, P) -> (SN, P) float32, one matmul per shift bucket."""
    acc = torch.matmul(w[0].to(torch.float32), slices[0])
    for b in range(1, w.shape[0]):
        acc = torch.addmm(acc, w[b].to(torch.float32), slices[b])
    return acc


def bucket_table(feats: torch.Tensor, valid: torch.Tensor, scales: torch.Tensor, t: int, kh: int, kw: int):
    """Where each feature of each template falls at each scale in the
    shift-bucketed layout: (bucket, cprime, ok), each (S * N, F), row
    s * N + n for template n at scale s.

    Feature (x, y, c) at scale s sits at (round(x * s), round(y * s)) (one
    float32 multiply, rounded half to even); it counts (``ok``) only if
    valid, inside the (kh, kw) extent and s > 0, and falls in shift bucket
    (y // t) * ceil(kw / t) + x // t at s2d channel c * t * t + (y % t) * t
    + x % t."""
    n, f = feats.shape[:2]
    kwb = -(-kw // t)
    sc = scales.to(torch.float32)[:, None, None]
    xs = torch.round(feats[..., 0].to(torch.float32) * sc).to(torch.int32)  # (S, N, F)
    ys = torch.round(feats[..., 1].to(torch.float32) * sc).to(torch.int32)
    ok = valid & (xs >= 0) & (xs < kw) & (ys >= 0) & (ys < kh) & (sc > 0)
    cprime = feats[..., 2] * (t * t) + (ys % t) * t + xs % t
    bucket = (ys // t) * kwb + xs // t
    return (a.reshape(scales.shape[0] * n, f) for a in (bucket, cprime, ok))


def similarity_multiscale_matmul(
    response_maps: torch.Tensor,
    feats: torch.Tensor,
    valid: torch.Tensor,
    scales: torch.Tensor,
    t: int,
    kh: int,
    kw: int,
):
    """Coarse scoring of every template at every scale as shift-bucketed
    matmuls (the JAX package's ``similarity_multiscale_matmul``).

    Feature f of template n at scale s sits at (round(x * s), round(y * s))
    and counts only if valid, inside the (kh, kw) extent and s > 0; in the
    space-to-depth layout it falls in one shift bucket b at one channel
    (``bucket_table``), so with W[b, sn, c'] the number of row sn's
    features there,

        raw[sn] = sum_b W[b, sn] @ maps_s2d[:, dy_b : dy_b + Ho, dx_b : dx_b + Wo]

    W is built a row chunk at a time by one scatter-add
    (``_bucket_weights``, chunks of ``_W_CHUNK_BYTES``) and contracted by
    one matmul per bucket.

    Exact in float32: the operands are integers (responses 0..4, counts of
    coinciding features), which float32 and TF32 hold exactly, every
    product and partial sum is an integer no larger than 4 * F, far below
    2^24, so any summation order cuBLAS or the CPU picks gives the exact
    integer.  (bfloat16 or float16 outputs would not: they hold integers
    exactly only up to 256 or 2048.)

    Args:
      response_maps: (C, H, W) or (B, C, H, W) uint8.
      feats: (N, F, 3) int32 (x, y, channel); valid: (N, F) bool.
      scales: (S,) float32 feature-coordinate scales, 0 = no proposal.
      t: stride of this level; kh, kw: the kernel extent.

    Returns (raw ([B,] S * N, Ho, Wo) float32, nfeat (S * N,) int32), row
    s * N + n for template n at scale s; Ho = ceil(H / t) - ceil(kh / t) + 1.
    """
    single = response_maps.dim() == 3
    maps = _s2d_maps(response_maps[None] if single else response_maps, t)
    khb, kwb = -(-kh // t), -(-kw // t)
    bh, ct2 = khb * kwb, maps.shape[1]
    bucket, cprime, ok = bucket_table(feats, valid, scales, t, kh, kw)
    sn = bucket.shape[0]
    nfeat = ok.sum(-1).to(torch.int32)

    hb, wb = maps.shape[-2:]
    ho, wo = hb - khb + 1, wb - kwb + 1
    slices = _bucket_slices(maps, khb, kwb)
    chunk = max(1, min(sn, _W_CHUNK_BYTES // (bh * ct2 * 4)))
    parts = [
        _matmul_shift_sum_s2d(slices, _bucket_weights(bucket[i : i + chunk], cprime[i : i + chunk], ok[i : i + chunk], bh, ct2))
        for i in range(0, sn, chunk)
    ]
    raw = torch.cat(parts) if len(parts) > 1 else parts[0]
    raw = raw.reshape(sn, maps.shape[0], ho, wo).transpose(0, 1).contiguous()
    return (raw[0] if single else raw), nfeat


def _feature_table(feats, valid, origins, t: int, hb: int, wb: int, scale=None):
    """Per (candidate, feature): (ok, cprime, by, bx) of the refine
    contract.  cprime is the s2d channel c*t*t + (y%t)*t + (x%t); (by, bx)
    the s2d block of the window's corner, clipped into the map."""
    x = feats[..., 0]
    y = feats[..., 1]
    if scale is not None:
        # One float32 multiply, rounded half to even (jnp.round).
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


def similarity_local_sparse(
    response_maps: torch.Tensor,
    feats_sel: torch.Tensor,
    valid_sel: torch.Tensor,
    origins: torch.Tensor,
    t: int,
    window: int = 16,
    scale: torch.Tensor = None,
    active: torch.Tensor = None,
):
    """Feature-sparse local similarity: the plain version of the local-refine
    kernel (``ops/local_refine.py``), with the kernel family's contract.

    For each (candidate, feature) the window of stride-t placements reads
    ONE contiguous (window, window) block of the space-to-depth maps, at
    channel c*t*t + (y%t)*t + (x%t) and block (oy/t + y/t, ox/t + x/t), with
    zeros past the map; the scores are the sums of those blocks over the
    candidate's in-range valid features.

    Args:
      response_maps: (C, H, W) uint8, or (B, C, H, W) for a batch of frames.
      feats_sel: ([B,] K, F, 3) int32 per-candidate features (x, y, channel).
      valid_sel: ([B,] K, F) bool.
      origins: ([B,] K, 2) int32 (y, x) pixel coordinates, multiples of t.
      t: stride at this level.
      window: placements per side, at most 16.
      scale: optional ([B,] K) float32 feature-coordinate scale.
      active: optional ([B,] K) bool; inactive candidates score zeros (their
        counts are unchanged).

    Returns (scores ([B,] K, window, window) float32, counts ([B,] K) int32
    of in-range valid features).
    """
    c = response_maps.shape[-3]
    maps = _s2d_maps(response_maps, t)  # ([B,] C*t*t, Hb, Wb)
    hb, wb = maps.shape[-2:]
    # Zero channel and window + 1 zero rows/cols, so every masked or
    # edge-straddling window reads zeros.
    pads = F.pad(maps, (0, window + 1, 0, window + 1, 0, 1))
    ok, cprime, by, bx = _feature_table(feats_sel, valid_sel, origins, t, hb, wb, scale)
    cprime = torch.where(ok, cprime, c * t * t)
    hp, wp = pads.shape[-2:]
    start = (cprime.to(torch.int64) * hp + by) * wp + bx  # ([B,] K, F)
    win = torch.arange(window, device=maps.device)
    cell = (win[:, None] * wp + win[None, :]).reshape(-1)  # (window*window,)
    idx = start[..., None] + cell  # ([B,] K, F, window*window)
    if pads.dim() == 4:  # frame b's maps start at b * (one frame's size)
        frame = torch.arange(pads.shape[0], device=maps.device) * pads[0].numel()
        idx = idx + frame.view(-1, 1, 1, 1)
    flat = pads.reshape(-1)[idx]
    scores = flat.to(torch.int32).sum(dim=-2).to(torch.float32)
    scores = scores.reshape(*scores.shape[:-1], window, window)
    if active is not None:
        scores = torch.where(active[..., None, None], scores, torch.zeros_like(scores))
    return scores, ok.sum(dim=-1).to(torch.int32)


def score_normalize(raw: torch.Tensor, nfeat: torch.Tensor) -> torch.Tensor:
    """Similarity percentage: 100 * raw / (4 * nfeat)  (cpp:1841)."""
    denom = torch.clamp(4.0 * nfeat.to(torch.float32), min=1.0)
    # A true float32 division (a Python scalar over a tensor would become a
    # reciprocal times 100, which rounds differently from the JAX code).
    hundred = torch.full((), 100.0, dtype=torch.float32, device=raw.device)
    return rounded(raw * (hundred / denom.reshape(denom.shape + (1,) * (raw.dim() - denom.dim()))))
