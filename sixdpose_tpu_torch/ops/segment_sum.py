"""Ordered per-segment sums: the plain version and ``csrc/segment_sum.cu``.

``segment_sum(vals, seg, num_segments)`` computes, for every segment s and
channel c, ``out[s, c] = sum of vals[i, c] over the i with seg[i] == s``,
added in ascending i in float32 from +0.0: what XLA's ``segment_sum``
computes on the CPU (its scatter-add walks the updates in order).  Float
addition does not associate, so the order is part of the result, and
CUDA's ``index_add_`` (atomics) promises none.

Both versions first sort the rows stably by id (the CSR layout: each
segment's rows in ascending order, and its start).  The plain version
takes the layout from ``torch.argsort`` and then adds one rank at a time,
every segment's r-th row at once.  On the card one call to the C library
makes the layout with a counting sort of its own and then sums each
segment in one block (``csrc/segment_sum.cu`` says how).  A CPU tensor
runs the plain version, a CUDA tensor the kernel or raises; it never falls
back.  Ids outside [0, num_segments) are dropped.
"""

from __future__ import annotations

import ctypes

import torch

from sixdpose_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {  # the stream handle last
    "segment_sum_launch": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "segment_layout_launch": [_P, _I, _I, _I, _I, _P, _P],
    "segment_sums_launch": [_P, _P, _P, _I, _I, _P, _P],
}
WARP_ROWS = 1024  # ids one warp of the layout ranks (kWarpRows)
SMEM_LIMIT = 232448  # a block's shared memory on the H100
MAX_SEGMENTS = SMEM_LIMIT // 4  # one warp's counters in shared memory
MAX_CHANNELS = 1024 - 224  # one chain lane per channel beside seven loader warps, in one block


def csr_layout(seg: torch.Tensor, num_segments: int):
    """(order, starts, counts): the rows of the kept ids sorted stably by id
    (int64), and each segment's start in ``order`` and length (int64)."""
    seg = seg.reshape(-1).to(torch.int64)
    keep = (seg >= 0) & (seg < num_segments)
    key = torch.where(keep, seg, torch.full_like(seg, num_segments))
    order = torch.argsort(key, stable=True)
    # Integer counts by scatter-add (exact in any order, and no wait for the
    # device, which bincount's size check would be).
    counts = torch.zeros(num_segments + 1, dtype=torch.int64, device=seg.device)
    counts = counts.scatter_add_(0, key, torch.ones_like(key))[:num_segments]
    starts = torch.cumsum(counts, 0) - counts
    return order, starts, counts


def segment_sum_plain(vals: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(N, C) float32 values, (N,) ids -> (num_segments, C) ordered sums,
    one rank at a time."""
    order, starts, counts = csr_layout(seg, num_segments)
    c = vals.shape[1]
    out = torch.zeros((num_segments, c), dtype=torch.float32, device=vals.device)
    if num_segments == 0 or vals.shape[0] == 0:
        return out
    longest = int(counts.max())
    for r in range(longest):
        live = torch.nonzero(counts > r).reshape(-1)
        out[live] = out[live] + vals[order[starts[live] + r]]
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("segment_sum")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _tiles(n: int, num_segments: int):
    """(warps per layout tile, tiles): up to eight warps, as many as one
    block's shared memory holds counters for."""
    warps = max(1, min(8, SMEM_LIMIT // (4 * num_segments)))
    return warps, -(-n // (warps * WARP_ROWS))


def _check_ids(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    if seg.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"seg must be int32 or int64, got {seg.dtype}")
    if not 0 < num_segments <= MAX_SEGMENTS:
        raise ValueError(f"num_segments {num_segments} outside the kernel's (0, {MAX_SEGMENTS}]")
    if seg.numel() >= 2**31:
        raise ValueError(f"{seg.numel()} ids: the kernel indexes rows with int32")
    return seg.contiguous()


def _scratch_len(n: int, num_segments: int):
    """(warps per layout tile, tiles, int32 words of layout scratch: tile
    counts, order, starts)."""
    warps, tiles = _tiles(n, num_segments)
    words = tiles * num_segments + n + num_segments + 1
    if words >= 2**31:
        raise ValueError(f"layout of {n} rows into {num_segments} segments too large for int32 positions")
    return warps, tiles, words


def segment_layout(seg: torch.Tensor, num_segments: int):
    """The card's layout alone, for timing and tests: (order (N,) int32,
    whose first ``starts[-1]`` entries are the kept rows sorted stably by
    id; starts (num_segments + 1,) int32).  CUDA tensors only."""
    if not seg.is_cuda:
        raise ValueError("segment_layout runs on the card; csr_layout is its plain version")
    seg = _check_ids(seg.reshape(-1), num_segments)
    n = seg.numel()
    warps, tiles, words = _scratch_len(n, num_segments)
    scratch = torch.empty(words, dtype=torch.int32, device=seg.device)
    _build.launch(seg.device, _library().segment_layout_launch, seg.data_ptr(), seg.element_size(), n, num_segments,
                  warps, scratch.data_ptr())
    segment_layout.launches += 1
    base = tiles * num_segments
    return scratch[base: base + n], scratch[base + n:]


def segment_sums(vals: torch.Tensor, order: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The card's sums alone, from ``segment_layout``'s (order, starts):
    (len(starts) - 1, C) float32.  CUDA tensors only."""
    if not vals.is_cuda:
        raise ValueError("segment_sums runs on the card; segment_sum_plain is its plain version")
    n_seg, c = starts.numel() - 1, vals.shape[1]
    _check_channels(vals)
    vals = vals.contiguous()
    out = torch.empty((n_seg, c), dtype=torch.float32, device=vals.device)
    _build.launch(vals.device, _library().segment_sums_launch, vals.data_ptr(), order.data_ptr(), starts.data_ptr(),
                  n_seg, c, out.data_ptr())
    segment_sums.launches += 1
    return out


def _check_channels(vals: torch.Tensor) -> None:
    n, c = vals.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"{c} channels above the kernel's {MAX_CHANNELS}")
    if n * c >= 2**31:
        raise ValueError(f"vals {tuple(vals.shape)} too large: the kernel indexes with int32")


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Ordered per-segment sums of ``vals`` ((N, C) float32) by ``seg``
    ((N,) integer ids): (num_segments, C) float32."""
    if vals.dim() != 2 or seg.shape != vals.shape[:1]:
        raise ValueError(f"need vals (N, C) and seg (N,), got {tuple(vals.shape)} and {tuple(seg.shape)}")
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if seg.device != vals.device:
        raise ValueError(f"seg is on {seg.device}, vals on {vals.device}")
    if not vals.is_cuda:
        return segment_sum_plain(vals, seg, num_segments)
    n, c = vals.shape
    dev = vals.device
    if num_segments * c == 0:
        return torch.empty((num_segments, c), dtype=torch.float32, device=dev)
    seg = _check_ids(seg, num_segments)
    _check_channels(vals)
    vals = vals.contiguous()
    warps, _, words = _scratch_len(n, num_segments)
    # One allocation: the sums, then (16-byte aligned) the layout's scratch.
    head = -(-(num_segments * c) // 4) * 4
    buf = torch.empty(head + words, dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    _build.launch(dev, _library().segment_sum_launch, vals.data_ptr(), seg.data_ptr(), seg.element_size(), n,
                  num_segments, c, warps, ptr + 4 * head, ptr)
    segment_sum.launches += 1
    return buf.as_strided((num_segments, c), (c, 1))


segment_sum.launches = 0  # kernel launches, for chip runs to read
segment_layout.launches = 0
segment_sums.launches = 0
