"""Wrapper of the local-refine CUDA kernel (``csrc/local_refine.cu``).

The kernel replaces the five Pallas TPU kernels of the JAX package's
``ops/pallas/local_refine.py`` (v1 to v5, one contract); the source note
in the ``.cu`` file says what bounds it and how it is laid out.  Its plain
PyTorch version is ``ops.similarity.similarity_local_sparse``, which the
wrapper runs for tensors on the CPU.  For CUDA tensors it launches the
kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from sixdpose_tpu_torch.ops import _build
from sixdpose_tpu_torch.ops.similarity import similarity_local_sparse

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = _build.load("local_refine")
    fn = lib.local_refine_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the maps on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def similarity_local_sparse_cuda(
    maps: torch.Tensor,
    feats: torch.Tensor,
    valid: torch.Tensor,
    origins: torch.Tensor,
    t: int,
    window: int = 16,
    scale: torch.Tensor = None,
    active: torch.Tensor = None,
):
    """Local-refine window scores; the contract of
    ``ops.similarity.similarity_local_sparse``.

    Args:
      maps: (C, H, W) uint8 response maps, or (B, C, H, W) for a batch of
        frames (one launch for the whole batch).
      feats: ([B,] K, F, 3) int32 (x, y, channel), channel in [0, C).
      valid: ([B,] K, F) bool.
      origins: ([B,] K, 2) int32 (y, x), multiples of t.
      t: stride; window: placements per side, 1..16.
      scale: optional ([B,] K) float32; active: optional ([B,] K) bool.

    Returns (scores ([B,] K, window, window) float32, counts ([B,] K) int32).
    A CPU tensor runs the plain version; a CUDA tensor the kernel.
    """
    if not maps.is_cuda:
        return similarity_local_sparse(maps, feats, valid, origins, t, window, scale, active)
    single = maps.dim() == 3
    if single:
        maps, feats, valid, origins = maps[None], feats[None], valid[None], origins[None]
        scale = scale[None] if scale is not None else None
        active = active[None] if active is not None else None
    if maps.dim() != 4:
        raise ValueError(f"maps must be (C, H, W) or (B, C, H, W), got {tuple(maps.shape)}")
    if not 1 <= window <= 16 or t < 1:
        raise ValueError(f"need 1 <= window <= 16 and t >= 1, got window={window}, t={t}")
    b, c, h, w = maps.shape
    if c * h * w >= 2**31 or b > 65535:
        raise ValueError(f"maps {tuple(maps.shape)} too large: the kernel indexes a frame with int32, frames by grid.y")
    if feats.dim() != 4:
        raise ValueError(f"feats must be ([B,] K, F, 3), got {tuple(feats.shape)}")
    k, f = feats.shape[1], feats.shape[2]
    dev = maps.device
    _check("maps", maps, torch.uint8, (b, c, h, w), dev)
    _check("feats", feats, torch.int32, (b, k, f, 3), dev)
    _check("valid", valid, torch.bool, (b, k, f), dev)
    _check("origins", origins, torch.int32, (b, k, 2), dev)
    if scale is not None:
        _check("scale", scale, torch.float32, (b, k), dev)
    if active is not None:
        _check("active", active, torch.bool, (b, k), dev)

    scores = torch.empty((b, k, window, window), dtype=torch.float32, device=dev)
    counts = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b * k > 0:
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.local_refine_launch(
                maps.data_ptr(), feats.data_ptr(), valid.data_ptr(), origins.data_ptr(),
                scale.data_ptr() if scale is not None else None,
                active.data_ptr() if active is not None else None,
                scores.data_ptr(), counts.data_ptr(),
                b, c, h, w, k, f, t, window, stream,
            )
        if rc != 0:
            raise RuntimeError(f"local_refine kernel launch failed: cudaError {rc}")
        similarity_local_sparse_cuda.launches += 1
    if single:
        return scores[0], counts[0]
    return scores, counts


similarity_local_sparse_cuda.launches = 0  # kernel launches, for chip runs to read
