"""Floyd-Steinberg density seeding: the scan on the CPU and on the card.

``floyd_steinberg(density)`` places DASP's seeds by serpentine error
diffusion (FloydSteinberg.cpp:35-138): float64 error over a float32
density, a seed where the diffused value reaches 0.5, the classic 7/16,
3/16, 5/16, 1/16 kernel.  A CPU tensor runs the plain version, a numpy
copy of the JAX package's scan (equal to its native C++ scan); a CUDA
tensor runs ``csrc/floyd_steinberg.cu``, the same scan in one thread in
double precision, or raises.  It never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sixdpose_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]
_MAX_WIDTH = 232448 // 24  # three rows of doubles in one block's shared memory


def floyd_steinberg_plain(density: np.ndarray) -> np.ndarray:
    """The serial scan on the host: (S, 2) float64 (x, y) seeds in scan
    order.  Python floats are IEEE doubles, so each step rounds as the
    JAX package's numpy scan does."""
    err = np.asarray(density, np.float32).astype(np.float64).tolist()
    h = len(err)
    w = len(err[0]) if h else 0
    seeds = []
    for y in range(h):
        row = err[y]
        below = err[y + 1] if y + 1 < h else None
        sgn = 1 if y % 2 == 0 else -1
        for x in (range(w) if sgn > 0 else range(w - 1, -1, -1)):
            v = row[x]
            out = 1.0 if v >= 0.5 else 0.0
            if out > 0:
                seeds.append((x, y))
            e = v - out
            xn, xp = x + sgn, x - sgn
            if 0 <= xn < w:
                row[xn] += e * 7 / 16
            if below is not None:
                if 0 <= xp < w:
                    below[xp] += e * 3 / 16
                below[x] += e * 5 / 16
                if 0 <= xn < w:
                    below[xn] += e * 1 / 16
    return np.array(seeds, np.float64).reshape(-1, 2)


def _library() -> ctypes.CDLL:
    lib = _build.load("floyd_steinberg")
    fn = lib.floyd_steinberg_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def floyd_steinberg(density: torch.Tensor):
    """Seeds of an (H, W) float32 density.

    Returns (seeds (S, 2) float32 (x, y) in scan order, on the density's
    device).  On the card the seed count is read back once, to cut the
    output to its length; the scan itself runs in one kernel launch.
    """
    if density.dim() != 2:
        raise ValueError(f"density must be (H, W), got {tuple(density.shape)}")
    if not density.is_cuda:
        seeds = floyd_steinberg_plain(density.numpy())
        return torch.from_numpy(seeds.astype(np.float32)).to(density.device)
    if density.dtype != torch.float32:
        raise TypeError(f"density must be float32, got {density.dtype}")
    density = density.contiguous()
    h, w = density.shape
    dev = density.device
    if w > _MAX_WIDTH:
        raise ValueError(f"density width {w} above the kernel's {_MAX_WIDTH} (three rows in shared memory)")
    cap = h * w  # a pixel holds at most one seed
    seeds = torch.empty((cap, 2), dtype=torch.float32, device=dev)
    count = torch.zeros((1,), dtype=torch.int32, device=dev)
    if h * w:
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.floyd_steinberg_launch(density.data_ptr(), h, w, seeds.data_ptr(), count.data_ptr(), cap,
                                            stream)
        if rc != 0:
            raise RuntimeError(f"floyd_steinberg kernel launch failed: cudaError {rc}")
        floyd_steinberg.launches += 1
    n = int(count.item())
    return seeds[:n]


floyd_steinberg.launches = 0  # kernel launches, for chip runs to read
