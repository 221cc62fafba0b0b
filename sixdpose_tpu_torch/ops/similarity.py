"""Template similarity over response maps: the single-class part.

PyTorch port of the main-path functions of the JAX package's
``ops/similarity.py``.  The reference accumulates the response under each
template feature at every stride-T placement (linemodLevelup.cpp:1215-1354);
here that sum is

- ``similarity_dense``: one float32 convolution of the space-to-depth
  response maps with one-hot template kernels, for the coarse level;
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


def _local_conv_operands(response_maps, kernels_sel, origins, t: int, window: int):
    """(lhs (1, K*C*t*t, hp, wp), rhs (K, C*t*t, kh, kw)) float32 operands of
    the grouped conv of ``similarity_local``: candidate k's window of s2d
    maps is channel group k, its template's s2d kernel group k's filter."""
    k = kernels_sel.shape[0]
    rhs = _s2d_kernels(kernels_sel, t).to(torch.float32)
    ct2, kh, kw = rhs.shape[1:]
    maps = _s2d_maps(response_maps, t)  # (C*t*t, Hb, Wb)
    hp = window - 1 + kh
    wp = window - 1 + kw
    pads = F.pad(maps, (0, wp, 0, hp))
    # Window corners clamp into the padded maps, as dynamic_slice clamps.
    hb, wb = maps.shape[-2:]
    by = (origins[:, 0] // t).to(torch.int64).clamp(0, hb)
    bx = (origins[:, 1] // t).to(torch.int64).clamp(0, wb)
    rows = by[:, None] + torch.arange(hp, device=maps.device)  # (K, hp)
    cols = bx[:, None] + torch.arange(wp, device=maps.device)  # (K, wp)
    patches = pads[:, rows[:, :, None], cols[:, None, :]]  # (C*t*t, K, hp, wp)
    lhs = patches.transpose(0, 1).reshape(1, k * ct2, hp, wp).to(torch.float32)
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
    reference's ``similarityLocal`` (cpp:1366-1428).  Same result as
    ``similarity_local_sparse``, which the main path uses instead.

    Args:
      response_maps: (C, H, W) uint8.
      kernels_sel: (K, C, KH, KW) int8, each candidate's template kernel.
      origins: (K, 2) int (y, x) pixel coordinates of each window's
        top-left placement, multiples of t.
      t: stride at this level.
      window: placements per side.

    Returns:
      (K, window, window) float32 raw scores (exact integers, as in
      ``similarity_dense``).
    """
    lhs, rhs = _local_conv_operands(response_maps, kernels_sel, origins, t, window)
    return torch.round(F.conv2d(lhs, rhs, groups=rhs.shape[0]))[0]


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
