"""Template similarity over response maps.

PyTorch port of the main-path functions of the JAX package's
``ops/similarity.py``.  The reference accumulates the response under each
template feature at every stride-T placement (linemodLevelup.cpp:1215-1354);
here that sum is

- ``similarity_dense``: one float32 convolution of the space-to-depth
  response maps with one-hot template kernels, for the coarse level of a
  bank of kernels (the dense-kernel route);
- ``similarity_multiscale_auto``: the same coarse sum over the feature
  lists of a bank that has them (optionally at several feature scales: the
  multi-scale matchers).  On a CUDA tensor it runs the hand-written
  gather-sum kernel of ``ops/coarse_score.py``; on a CPU tensor its plain
  version, ``similarity_multiscale_sparse``;
- ``similarity_dense_pre_s2d`` and ``build_kernels_scaled``: the same
  multi-scale sum as a conv of scaled one-hot kernels (references, off the
  main path);
- ``similarity_local_sparse``: a per-candidate gather-sum over a 16x16
  window of placements, for the pyramid refinement.  On a CUDA tensor it
  runs the hand-written kernel of ``ops/local_refine.py``; this module holds
  its plain version, which the CPU runs.

Score normalization matches cpp:1841: score = 100 * raw / (4 * nfeat).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def build_template_kernels(
    features: np.ndarray,
    valid: np.ndarray,
    kh: int,
    kw: int,
    num_channels: int,
) -> np.ndarray:
    """Densify per-template feature lists into conv kernels.

    Args:
      features: (N, F, 3) int array of (x, y, channel) per feature, where
        channel = modality * 8 + orientation_label.
      valid: (N, F) bool mask (templates have ragged feature counts).
      kh, kw: kernel extent (max template bbox + 1 at this level).
      num_channels: 8 * num_modalities.

    Returns:
      (N, num_channels, kh, kw) int8 kernel stack; coinciding features each
      count, as the reference adds one response per feature (cpp:1323-1353).
    """
    n, f, _ = features.shape
    kern = np.zeros((n, num_channels, kh, kw), dtype=np.int8)
    xs = features[..., 0]
    ys = features[..., 1]
    cs = features[..., 2]
    tid = np.broadcast_to(np.arange(n)[:, None], (n, f))
    m = valid & (xs >= 0) & (xs < kw) & (ys >= 0) & (ys < kh)
    np.add.at(kern, (tid[m], cs[m], ys[m], xs[m]), 1)
    return kern


def build_kernels_scaled(
    features: torch.Tensor,
    valid: torch.Tensor,
    scale,
    kh: int,
    kw: int,
    num_channels: int,
) -> torch.Tensor:
    """One-hot kernels of feature lists scaled by train_depth / scene_depth
    (the reference's multi-scale design, notes.md:44-58), built on the
    features' device by one scatter-add.

    Args:
      features: (N, F, 3) int32 (x, y, channel); valid: (N, F) bool.
      scale: float, or a float32 tensor that broadcasts against (N, F)
        (one scale per template: (N, 1)); multiplies feature coordinates
        (one float32 multiply, rounded half to even).
      kh, kw: output kernel extent (must cover the largest scale).
      num_channels: 8 * num_modalities.

    Returns (N, num_channels, kh, kw) float32 kernels; features that round
    onto one cell each count, as the reference adds one response per
    feature (cpp:1323-1353).
    """
    n, f, _ = features.shape
    sc = torch.as_tensor(scale, dtype=torch.float32, device=features.device)
    xs = torch.round(features[..., 0].to(torch.float32) * sc).to(torch.int64)
    ys = torch.round(features[..., 1].to(torch.float32) * sc).to(torch.int64)
    cs = features[..., 2].to(torch.int64)
    ok = valid & (xs >= 0) & (xs < kw) & (ys >= 0) & (ys < kh)
    tid = torch.arange(n, device=features.device)[:, None]
    flat = ((tid * num_channels + cs) * kh + ys) * kw + xs
    kern = torch.zeros(n * num_channels * kh * kw, dtype=torch.float32, device=features.device)
    # Masked features add 0 at index 0.
    kern.scatter_add_(0, torch.where(ok, flat, 0).reshape(-1), ok.to(torch.float32).reshape(-1))
    return kern.reshape(n, num_channels, kh, kw)


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


def _s2d_kernels(kernels: torch.Tensor, t: int) -> torch.Tensor:
    """Space-to-depth of a kernel stack: (N, C, KH, KW) ->
    (N, C*t*t, KH/t, KW/t), in the channel order of ``_s2d_maps``."""
    n, c, kh, kw = kernels.shape
    khp, kwp = _ceil_to(kh, t), _ceil_to(kw, t)
    k = F.pad(kernels, (0, kwp - kw, 0, khp - kh))
    k = k.reshape(n, c, khp // t, t, kwp // t, t)
    k = k.permute(0, 1, 3, 5, 2, 4)
    return k.reshape(n, c * t * t, khp // t, kwp // t)


def s2d_kernels_host(kernels: np.ndarray, t: int) -> np.ndarray:
    """Host-side space-to-depth of a kernel stack (layout of
    ``_s2d_kernels``), for prebuilding kernel tables."""
    n, c, kh, kw = kernels.shape
    khp, kwp = _ceil_to(kh, t), _ceil_to(kw, t)
    k = np.zeros((n, c, khp, kwp), kernels.dtype)
    k[:, :, :kh, :kw] = kernels
    k = k.reshape(n, c, khp // t, t, kwp // t, t)
    k = k.transpose(0, 1, 3, 5, 2, 4)
    return np.ascontiguousarray(k.reshape(n, c * t * t, khp // t, kwp // t))


def similarity_dense(response_maps: torch.Tensor, kernels: torch.Tensor, t: int) -> torch.Tensor:
    """Raw similarity of every template at every stride-T placement.

    The stride-T correlation factors exactly through space-to-depth into a
    stride-1 conv over t^2 times more channels with a t times smaller
    kernel.

    The conv runs in float32.  Its operands are small integers (responses
    0..4, kernel cells small counts), which TF32 and float32 both hold
    exactly, and every sum stays below 4 * 8191 < 2^24, so the exact result
    is an integer whatever the TF32 setting.  A transform-based conv
    algorithm (Winograd, FFT) may leave a rounding error far below 0.5 on
    it; rounding the output restores the exact integer.  (float16 or
    bfloat16 outputs would not: they hold integers exactly only up to 2048
    or 256.)

    Args:
      response_maps: (C, H, W) or (B, C, H, W) uint8 response maps.
      kernels: (N, C, KH, KW) int8 one-hot template kernels.
      t: sampling stride T at this pyramid level.

    Returns:
      (N, H_out, W_out) or (B, N, H_out, W_out) float32 raw scores with
      H_out = ceil(H/t) - ceil(KH/t) + 1; placement (y, x) is the template
      origin at pixel (y*t, x*t).
    """
    single = response_maps.dim() == 3
    maps = response_maps[None] if single else response_maps
    lhs = _s2d_maps(maps, t).to(torch.float32)
    rhs = _s2d_kernels(kernels, t).to(torch.float32)
    out = torch.round(F.conv2d(lhs, rhs))
    return out[0] if single else out


def similarity_dense_pre_s2d(response_maps: torch.Tensor, kernels_s2d: torch.Tensor, t: int) -> torch.Tensor:
    """``similarity_dense`` for kernels already in the space-to-depth layout
    ((N, C*t*t, KH/t, KW/t), ``s2d_kernels_host`` or ``_s2d_kernels``), as a
    float32 conv, exact for the reasons ``similarity_dense`` gives (the JAX
    package runs it as an int8 conv with int32 sums: the same integers)."""
    lhs = _s2d_maps(response_maps, t)[None].to(torch.float32)
    return torch.round(F.conv2d(lhs, kernels_s2d.to(torch.float32)))[0]


# Bytes of one row chunk of the plain coarse scorer's gather indices and
# gathered bytes: its peak stays near 1 GiB whatever the sweep.
_W_CHUNK_BYTES = 1 << 30


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


def similarity_multiscale_sparse(
    response_maps: torch.Tensor,
    feats: torch.Tensor,
    valid: torch.Tensor,
    scales: torch.Tensor,
    t: int,
    kh: int,
    kw: int,
):
    """Coarse scoring of every template at every scale as a feature-sparse
    gather-sum: the plain version of the coarse-scorer kernel
    (``ops/coarse_score.py``), with the integers of the JAX package's
    shift-bucketed matmul route.

    Feature f of template n at scale s sits at (round(x * s), round(y * s))
    (one float32 multiply, rounded half to even) and counts only if valid,
    inside the (kh, kw) extent and s > 0 (``bucket_table``).  Each counted
    (scale, template, feature) reads the space-to-depth maps (B, ct2, hb,
    wb) at one packed offset c' * hb * wb + (ys // t) * wb + xs // t (its
    shift bucket and s2d channel, c' clamped into the maps), plus y * wb + x
    at placement (y, x); the rows sum over features in int32, exactly.
    Work scales with the feature count, like the reference's linearized
    memories (cpp:1215-1243).  Rows are gathered a chunk at a time, so the
    index and gathered bytes stay within ``_W_CHUNK_BYTES``.  (The JAX
    package contracts shift-bucketed weights with one matmul per bucket, or
    gathers rows of an im2col with four byte lanes packed into 32-bit
    words: TPU workarounds the port does not need.)

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
    b, ct2, hb, wb = maps.shape
    khb, kwb = -(-kh // t), -(-kw // t)
    ho, wo = hb - khb + 1, wb - kwb + 1
    bucket, cprime, ok = bucket_table(feats, valid, scales, t, kh, kw)
    plane = hb * wb
    off = cprime.clamp(0, ct2 - 1).to(torch.int64) * plane + (bucket // kwb) * wb + bucket % kwb
    dev = maps.device
    base = (torch.arange(ho, device=dev)[:, None] * wb + torch.arange(wo, device=dev)).reshape(-1)
    flat = F.pad(maps.reshape(b, ct2 * plane), (0, 1))  # masked features read the zero past the maps
    sn, f = off.shape
    chunk = max(1, min(sn, _W_CHUNK_BYTES // max(f * base.numel() * (8 + b), 1)))
    parts = []
    for i in range(0, sn, chunk):
        idx = torch.where(ok[i : i + chunk, :, None], off[i : i + chunk, :, None] + base, ct2 * plane)
        parts.append(flat[:, idx].sum(dim=2, dtype=torch.int32))  # (B, rows, P)
    raw = torch.cat(parts, dim=1).reshape(b, sn, ho, wo).to(torch.float32)
    return (raw[0] if single else raw), ok.sum(-1).to(torch.int32)


def similarity_multiscale_auto(response_maps, feats, valid, scales, t: int, kh: int, kw: int):
    """Dispatch of the coarse scorer: the hand-written kernel for CUDA
    tensors, the plain version for CPU tensors (the kernel's wrapper makes
    that choice by device, and only by device).  Same contract as
    ``similarity_multiscale_sparse``."""
    # Imported here: ops/coarse_score.py imports this module.
    from sixdpose_tpu_torch.ops.coarse_score import similarity_multiscale_cuda

    return similarity_multiscale_cuda(response_maps, feats, valid, scales, t, kh, kw)


def _local_conv_operands(response_maps, kernels_sel, origins, t: int, window: int):
    """(lhs (1, B*K*C*t*t, hp, wp), rhs (B*K, C*t*t, kh, kw)) float32
    operands of the grouped conv of ``similarity_local``: candidate k of
    frame b's window of s2d maps is channel group b*K + k, its template's
    s2d kernel that group's filter.  Inputs carry a leading frame axis
    (B = 1 for one frame)."""
    b, k = kernels_sel.shape[:2]
    rhs = _s2d_kernels(kernels_sel.flatten(0, 1), t).to(torch.float32)
    ct2, kh, kw = rhs.shape[1:]
    maps = _s2d_maps(response_maps, t)  # (B, C*t*t, Hb, Wb)
    hp = window - 1 + kh
    wp = window - 1 + kw
    pads = F.pad(maps, (0, wp, 0, hp))
    # Window corners clamp into the padded maps, as dynamic_slice clamps.
    hb, wb = maps.shape[-2:]
    by = (origins[..., 0] // t).to(torch.int64).clamp(0, hb)
    bx = (origins[..., 1] // t).to(torch.int64).clamp(0, wb)
    rows = by[..., None] + torch.arange(hp, device=maps.device)  # (B, K, hp)
    cols = bx[..., None] + torch.arange(wp, device=maps.device)  # (B, K, wp)
    frame = torch.arange(b, device=maps.device)[:, None, None, None]
    patches = pads[frame, :, rows[..., :, None], cols[..., None, :]]  # (B, K, hp, wp, C*t*t)
    lhs = patches.permute(0, 1, 4, 2, 3).reshape(1, b * k * ct2, hp, wp).to(torch.float32)
    return lhs, rhs


def similarity_local(
    response_maps: torch.Tensor,
    kernels_sel: torch.Tensor,
    origins: torch.Tensor,
    t: int,
    window: int = 16,
) -> torch.Tensor:
    """Local similarity of one template per candidate over a window of
    placements, as one grouped convolution (``feature_group_count=K``): the
    reference's ``similarityLocal`` (cpp:1366-1428), and the JAX package's
    refinement of a bank without feature lists.  Same result as
    ``similarity_local_sparse``, which a bank with feature lists takes.

    A batch of frames folds into the group axis: the B * K candidates of B
    frames are the groups of one convolution.

    Args:
      response_maps: (C, H, W) uint8, or (B, C, H, W) for a batch of frames.
      kernels_sel: ([B,] K, C, KH, KW) int8, each candidate's template kernel.
      origins: ([B,] K, 2) int (y, x) pixel coordinates of each window's
        top-left placement, multiples of t.
      t: stride at this level.
      window: placements per side.

    Returns:
      ([B,] K, window, window) float32 raw scores (exact integers, as in
      ``similarity_dense``).
    """
    single = response_maps.dim() == 3
    if single:
        response_maps, kernels_sel, origins = response_maps[None], kernels_sel[None], origins[None]
    lhs, rhs = _local_conv_operands(response_maps, kernels_sel, origins, t, window)
    out = torch.round(F.conv2d(lhs, rhs, groups=rhs.shape[0]))[0]
    out = out.reshape(kernels_sel.shape[:2] + out.shape[-2:])
    return out[0] if single else out


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


def similarity_local_sparse_auto(
    response_maps, feats_sel, valid_sel, origins, t, window: int = 16,
    scale=None, active=None,
):
    """Dispatch of the local refinement: the hand-written kernel for CUDA
    tensors, the plain version for CPU tensors (the kernel's wrapper makes
    that choice by device, and only by device).  Same contract as
    ``similarity_local_sparse``."""
    # Imported here: ops/local_refine.py imports this module's plain version.
    from sixdpose_tpu_torch.ops.local_refine import similarity_local_sparse_cuda

    return similarity_local_sparse_cuda(
        response_maps, feats_sel, valid_sel, origins, t, window, scale, active
    )


def score_normalize(raw: torch.Tensor, nfeat: torch.Tensor) -> torch.Tensor:
    """Similarity percentage: 100 * raw / (4 * nfeat)  (cpp:1841)."""
    denom = torch.clamp(4.0 * nfeat.to(torch.float32), min=1.0)
    # A true float32 division (a Python scalar over a tensor would become a
    # reciprocal times 100, which rounds differently from the JAX code).
    hundred = torch.full((), 100.0, dtype=torch.float32, device=raw.device)
    return raw * (hundred / denom.reshape(denom.shape + (1,) * (raw.dim() - denom.dim())))
