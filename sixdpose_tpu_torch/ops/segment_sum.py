"""Ordered per-segment sums: the plain version and ``csrc/segment_sum.cu``.

``segment_sum(vals, seg, num_segments)`` computes, for every segment s and
channel c, ``out[s, c] = sum of vals[i, c] over the i with seg[i] == s``,
added in ascending i in float32 from +0.0: what XLA's ``segment_sum``
computes on the CPU (its scatter-add walks the updates in order).  Float
addition does not associate, so the order is part of the result, and
CUDA's ``index_add_`` (atomics) promises none.

Both versions first sort the ids stably (the CSR layout: each segment's
rows in ascending order, and its start and length).  The plain version
then adds one rank at a time, every segment's r-th row at once; the CUDA
kernel walks each (segment, channel) in one thread.  A CPU tensor runs
the plain version, a CUDA tensor the kernel or raises; it never falls
back.  Ids outside [0, num_segments) are dropped.
"""

from __future__ import annotations

import ctypes

import torch

from sixdpose_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


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
    fn = lib.segment_sum_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


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
    if n * c >= 2**31:
        raise ValueError(f"vals {tuple(vals.shape)} too large: the kernel indexes with int32")
    vals = vals.contiguous()
    order, starts, counts = csr_layout(seg, num_segments)
    out = torch.empty((num_segments, c), dtype=torch.float32, device=vals.device)
    if num_segments * c:
        lib = _library()
        dev = vals.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.segment_sum_launch(vals.data_ptr(), order.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                                        num_segments, c, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"segment_sum kernel launch failed: cudaError {rc}")
        segment_sum.launches += 1
    return out


segment_sum.launches = 0  # kernel launches, for chip runs to read
