"""Wrapper of the coarse-scorer CUDA kernel (``csrc/coarse_score.cu``).

The kernel scores every (scale, template) row of a bank at every stride-t
placement of the coarsest level by a feature-sparse gather-sum over the
space-to-depth maps; the source note in the ``.cu`` file says why it was
added, what bounds it and how it is laid out.  Its plain PyTorch version,
whose contract it has, is ``ops.similarity.similarity_multiscale_sparse``.
For tensors on the CPU the wrapper runs the plain version, as the
local-refine and ICP wrappers run theirs; for CUDA tensors it launches the
kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from sixdpose_tpu_torch.ops import _build
from sixdpose_tpu_torch.ops.similarity import _s2d_maps, similarity_multiscale_sparse

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_MAX_TILES = 65535  # placement tiles of 128 run on grid.y, frames on grid.z


def _launcher():
    fn = _build.load("coarse_score").coarse_score_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the maps on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def similarity_multiscale_cuda(
    response_maps: torch.Tensor,
    feats: torch.Tensor,
    valid: torch.Tensor,
    scales: torch.Tensor,
    t: int,
    kh: int,
    kw: int,
):
    """Coarse scores of every template at every scale; the contract of
    ``ops.similarity.similarity_multiscale_sparse``.

    Args:
      response_maps: (C, H, W) or (B, C, H, W) uint8 (one launch for the
        whole batch).
      feats: (N, F, 3) int32 (x, y, channel); valid: (N, F) bool.
      scales: (S,) float32 feature-coordinate scales, 0 = no proposal.
      t: stride of this level; kh, kw: the kernel extent.

    Returns (raw ([B,] S * N, Ho, Wo) float32, nfeat (S * N,) int32).  A CPU
    tensor runs the plain version; a CUDA tensor the kernel.
    """
    if not response_maps.is_cuda:
        return similarity_multiscale_sparse(response_maps, feats, valid, scales, t, kh, kw)
    single = response_maps.dim() == 3
    if response_maps.dim() not in (3, 4):
        raise ValueError(f"maps must be (C, H, W) or (B, C, H, W), got {tuple(response_maps.shape)}")
    if response_maps.dtype != torch.uint8:
        raise TypeError(f"maps must be torch.uint8, got {response_maps.dtype}")
    if t < 1 or kh < 1 or kw < 1:
        raise ValueError(f"need t, kh, kw >= 1, got t={t}, kh={kh}, kw={kw}")
    dev = response_maps.device
    maps = _s2d_maps(response_maps[None] if single else response_maps, t).contiguous()
    b, ct2, hb, wb = maps.shape
    ho, wo = hb - (-(-kh // t)) + 1, wb - (-(-kw // t)) + 1
    if ho < 0 or wo < 0:
        raise ValueError(f"the ({kh}, {kw}) extent does not fit the maps {tuple(response_maps.shape)} at t={t}")
    if ct2 * hb * wb >= 2**31 or b > 65535 or -(-ho * wo // 128) > _MAX_TILES:
        raise ValueError(f"maps {tuple(response_maps.shape)} too large for the kernel's int32 offsets and grid")
    if feats.dim() != 3 or scales.dim() != 1:
        raise ValueError(f"need feats (N, F, 3) and scales (S,), got {tuple(feats.shape)} and {tuple(scales.shape)}")
    n, f = feats.shape[:2]
    s = scales.shape[0]
    _check("feats", feats, torch.int32, (n, f, 3), dev)
    _check("valid", valid, torch.bool, (n, f), dev)
    _check("scales", scales, torch.float32, (s,), dev)
    if s * n >= 2**31:
        raise ValueError(f"{s} x {n} rows: the kernel indexes rows with int32")

    raw = torch.empty((b, s * n, ho, wo), dtype=torch.float32, device=dev)
    nfeat = torch.empty((s * n,), dtype=torch.int32, device=dev)
    if s * n > 0:
        _build.launch(dev, _launcher(), maps.data_ptr(), feats.data_ptr(), valid.data_ptr(), scales.data_ptr(),
                      raw.data_ptr(), nfeat.data_ptr(), b, n, f, s, ct2, hb, wb, ho, wo, t, kh, kw)
        similarity_multiscale_cuda.launches += 1
    return (raw[0] if single else raw), nfeat


similarity_multiscale_cuda.launches = 0  # kernel launches, for chip runs to read
