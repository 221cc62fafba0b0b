"""Wrapper of the ICP CUDA kernel (``csrc/icp.cu``).

The kernel runs every Gauss-Newton iteration of ``models.refine.icp_batch``
and its final fitness and rmse in one launch, one block per candidate,
with the bits of the plain version ``models.refine.icp_batch_plain``; the
source note in the ``.cu`` file says why it was added, what bounds it and
how it is laid out.  ``icp_batch`` runs the plain version for tensors on
the CPU and this wrapper for CUDA tensors, which launches the kernel or
raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from sixdpose_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
# The kernel's limits (``csrc/icp.cu`` refuses larger sizes only as a backstop):
MAX_ITERS_IN_ARGS = 128  # iterations whose schedule rides in the launch arguments; a longer one is read on the card
MAX_POINTS = 2**24  # points a candidate: 2**16 a thread of a 256-thread block, the kernel's tree counter


def _launcher():
    fn = _build.load("icp").icp_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=64)
def icp_schedule(max_iters: int, corr_dist: float, coarse_gate_mult: float, color_weight: float,
                 chroma_scale: float) -> np.ndarray:
    """The per-iteration float32 scalars of the plain step, one row each:
    the correspondence gate, the colour weight and the colour divisor
    (``sigma * chroma_scale``), computed on the host as the step computes
    them.  (3, max_iters) float32, contiguous; read-only (cached)."""
    out = np.zeros((3, max_iters), np.float32)
    for i in range(max_iters):
        frac = np.float32(i) / np.float32(max(max_iters - 1, 1))
        out[0, i] = np.float32(corr_dist) * np.float32(coarse_gate_mult) ** (np.float32(1.0) - frac)
        out[1, i] = np.float32(color_weight) * frac
        sigma = np.float32(0.5) * np.float32(0.2) ** frac
        out[2, i] = sigma * np.float32(chroma_scale)
    out.flags.writeable = False
    return out


def pack_scene(scene_pts: torch.Tensor, scene_nrm: torch.Tensor) -> torch.Tensor:
    """The (H*W, 7) table that ICP's association gathers from: points |
    normals | valid (z > 0), so a tap is one row."""
    valid = (scene_pts[..., 2:3] > 0).to(torch.float32)
    return torch.cat([scene_pts, scene_nrm, valid], dim=-1).reshape(-1, 7)


def pack_chroma(chroma_maps) -> torch.Tensor:
    """The (H*W, 6) table of ``scene_chroma``'s maps: c | du | dv."""
    return torch.cat(list(chroma_maps), dim=-1).reshape(-1, 6)


@lru_cache(maxsize=16)
def _schedule_on(device: torch.device, *key) -> torch.Tensor:
    """``icp_schedule(*key)`` on ``device``, uploaded once: the table a
    schedule longer than ``MAX_ITERS_IN_ARGS`` is read from."""
    return torch.tensor(icp_schedule(*key).copy(), device=device)


def _check(name, x, dtype, shape, device, contiguous=True):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the model points on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def icp_cuda(model_pts, model_valid, scene_pts, scene_nrm, scene_K, init_T, *, corr_dist, max_iters,
             coarse_gate_mult, model_chroma, chroma_maps, color_weight, chroma_scale, point_weight, lm_damping,
             bilinear_iters, coarse_points):
    """``models.refine.icp_batch`` on the card in one kernel launch: the
    arguments and results of ``icp_batch`` (which holds the defaults), the
    same bits as its plain version.  Every tensor must lie on one CUDA
    device; the model points, validity, chroma, intrinsics and start poses
    must be contiguous (``icp_batch`` makes them so).  The scene maps are
    packed as the plain version packs them (``pack_scene``,
    ``pack_chroma``)."""
    dev = model_pts.device
    if model_pts.dim() != 3 or model_pts.shape[-1] != 3:
        raise ValueError(f"model_pts must be (K, N, 3), got {tuple(model_pts.shape)}")
    k, n = model_pts.shape[:2]
    _check("model_pts", model_pts, torch.float32, (k, n, 3), dev)
    _check("model_valid", model_valid, torch.bool, (k, n), dev)
    _check("init_T", init_T, torch.float32, (k, 4, 4), dev)
    _check("scene_K", scene_K, torch.float32, (3, 3), dev)
    if scene_pts.dim() != 3 or scene_pts.shape[-1] != 3:
        raise ValueError(f"scene_pts must be (H, W, 3), got {tuple(scene_pts.shape)}")
    h, w = scene_pts.shape[:2]
    _check("scene_pts", scene_pts, torch.float32, (h, w, 3), dev, contiguous=False)
    _check("scene_nrm", scene_nrm, torch.float32, (h, w, 3), dev, contiguous=False)
    use_color = model_chroma is not None and chroma_maps is not None
    if use_color:
        _check("model_chroma", model_chroma, torch.float32, (k, n, 2), dev)
        if len(chroma_maps) != 3:
            raise ValueError(f"chroma_maps must be (c, du, dv), got {len(chroma_maps)} maps")
        for name, m in zip(("chroma", "chroma du", "chroma dv"), chroma_maps):
            _check(name, m, torch.float32, (h, w, 2), dev, contiguous=False)
    if dev.type != "cuda":
        raise ValueError(f"icp_cuda takes CUDA tensors, got {dev}: icp_batch runs the plain version on the CPU")
    if max_iters < 0:
        raise ValueError(f"max_iters must not be negative, got {max_iters}")
    if n > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} model points a candidate, got {n}")
    if h * w * 7 >= 2**31:
        raise ValueError(f"a {h} x {w} scene is too large for the kernel's int32 pixel indices")

    T = torch.empty((k, 4, 4), dtype=torch.float32, device=dev)
    fitness = torch.empty((k,), dtype=torch.float32, device=dev)
    rmse = torch.empty((k,), dtype=torch.float32, device=dev)
    if k == 0:
        return T, fitness, rmse
    packed = pack_scene(scene_pts, scene_nrm)
    chroma = pack_chroma(chroma_maps) if use_color else None
    n_bi = max(0, min(int(bilinear_iters), max_iters))
    stride = max(1, n // max(coarse_points, 8))
    key = (int(max_iters), float(corr_dist), float(coarse_gate_mult), float(color_weight), float(chroma_scale))
    on_card = max_iters > MAX_ITERS_IN_ARGS
    sched = _schedule_on(dev, *key) if on_card else icp_schedule(*key)
    _build.launch(dev, _launcher(), packed.data_ptr(), chroma.data_ptr() if use_color else None,
                  model_pts.data_ptr(), model_valid.data_ptr(), model_chroma.data_ptr() if use_color else None,
                  scene_K.data_ptr(), init_T.data_ptr(), T.data_ptr(), fitness.data_ptr(), rmse.data_ptr(),
                  None if on_card else sched.ctypes.data, sched.data_ptr() if on_card else None, k, n, h, w,
                  int(max_iters), int(max_iters) - n_bi, stride, point_weight, lm_damping, chroma_scale, corr_dist)
    icp_cuda.launches += 1
    return T, fitness, rmse


icp_cuda.launches = 0  # kernel launches, for chip runs and tests to read
