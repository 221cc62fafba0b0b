"""Wrapper of the response-pyramid CUDA kernels (``csrc/response_pyramid.cu``).

The kernels build every level's response maps of a batch of frames
(colour quantization, pyrDown, depth normals and their median, spread and
the response LUT) with the bytes of the plain version
``models.detector._build_response_pyramid_plain``; one call of the C
launcher enqueues all of them.  The source note in the ``.cu`` file says
why they were added, what bounds them and how they are laid out.
``_build_response_pyramid`` runs the plain version for tensors on the CPU
and this wrapper for CUDA tensors, which launches the kernels or raises;
it never falls back.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.ops import _build

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
             + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
LUTS = {"levelup": 0, "stock": 1, "binary45": 2}


def _launcher():
    fn = _build.load("response_pyramid").response_pyramid_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def level_shapes(h: int, w: int, levels: int) -> list:
    """(H_l, W_l) of each level: halved, rounded up (pyrDown and nn_down2)."""
    out = [(h, w)]
    for _ in range(1, levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w))
    return out


def workspace_bytes(b: int, h: int, w: int, levels: int, use_color: bool, use_depth: bool) -> int:
    """Bytes of the kernels' scratch: level 0's quantized normals, and each
    level's quantized colour with its RGB above level 0 (the launcher's
    layout)."""
    n = b * h * w if use_depth else 0
    if use_color:
        for l, (hl, wl) in enumerate(level_shapes(h, w, levels)):
            n += b * hl * wl * (4 if l else 1)
    return n


def _check(name, x, dtype, dims, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() < len(dims) or (dims[-1] == "3" and x.shape[-1] != 3):
        raise ValueError(f"{name} must be ([B,] {', '.join(dims)}), got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"response_pyramid_cuda takes CUDA tensors, got {name} on {x.device}: "
                         "_build_response_pyramid runs the plain version on the CPU")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, the other image on {device}")


def response_pyramid_cuda(rgb, depth, cfg: DetectorConfig) -> list:
    """``_build_response_pyramid`` on the card in one call of the kernels'
    launcher: the arguments and results of the plain version, the same
    bytes.  ``rgb`` ([B,] H, W, 3) uint8 and ``depth`` ([B,] H, W) int32
    on one CUDA device (the one whose modality is off may be None; any
    strides).  Returns per level ([B,] 8 * modalities, H_l, W_l) uint8,
    colour maps first."""
    if not (cfg.use_color or cfg.use_depth):
        raise ValueError("the response pyramid needs a modality: use_color and use_depth are both off")
    if cfg.response_lut not in LUTS:
        raise ValueError(f"unknown response LUT {cfg.response_lut!r}")
    ts = [int(t) for t in cfg.t_at_level]
    if not ts or min(ts) < 1:
        raise ValueError(f"t_at_level must hold one t >= 1 a level, got {tuple(cfg.t_at_level)}")
    dev = None
    if cfg.use_color:
        _check("rgb", rgb, torch.uint8, ("H", "W", "3"), None)
        dev, frame = rgb.device, tuple(rgb.shape[:-1])
    if cfg.use_depth:
        _check("depth", depth, torch.int32, ("H", "W"), dev)
        if dev is not None and tuple(depth.shape) != frame:
            raise ValueError(f"depth {tuple(depth.shape)} and rgb {tuple(rgb.shape)} differ in frame shape")
        dev, frame = depth.device, tuple(depth.shape)
    lead, (h, w) = frame[:-2], frame[-2:]
    b = math.prod(lead)
    levels = len(ts)
    modalities = int(cfg.use_color) + int(cfg.use_depth)
    shapes = level_shapes(h, w, levels)
    outs = [torch.empty((*lead, 8 * modalities, hl, wl), dtype=torch.uint8, device=dev) for hl, wl in shapes]
    if b * h * w == 0:
        return outs
    rgb_c = rgb.reshape(b, h, w, 3).contiguous() if cfg.use_color else None
    dep_c = depth.reshape(b, h, w).contiguous() if cfg.use_depth else None
    work = torch.empty((workspace_bytes(b, h, w, levels, cfg.use_color, cfg.use_depth),), dtype=torch.uint8,
                       device=dev)
    out_ptrs = (ctypes.c_void_p * levels)(*[o.data_ptr() for o in outs])
    t_arr = (ctypes.c_int * levels)(*ts)
    _build.launch(dev, _launcher(), rgb_c.data_ptr() if rgb_c is not None else None,
                  dep_c.data_ptr() if dep_c is not None else None, work.data_ptr(), out_ptrs, t_arr, levels, b, h, w,
                  int(cfg.use_color), int(cfg.use_depth), LUTS[cfg.response_lut], int(cfg.depth.lut_parity),
                  float(np.float32(cfg.color.weak_threshold * cfg.color.weak_threshold)),
                  math.ceil(cfg.depth.distance_threshold), float(np.float32(cfg.depth.difference_threshold)),
                  float(np.float32(cfg.depth.focal)))
    response_pyramid_cuda.launches += 1
    return outs


response_pyramid_cuda.launches = 0  # calls of the kernels' launcher, for chip runs and tests to read
