"""Floyd-Steinberg density seeding: the scan on the CPU and on the card.

``floyd_steinberg(density)`` places DASP's seeds by serpentine error
diffusion (FloydSteinberg.cpp:35-138): float64 error over a float32
density, a seed where the diffused value reaches 0.5, the classic 7/16,
3/16, 5/16, 1/16 kernel.  A CPU tensor runs the plain version, a numpy
copy of the JAX package's scan (equal to its native C++ scan); a CUDA
tensor runs ``csrc/floyd_steinberg.cu``, the same scan in one thread in
double precision (with the block's other warps staging the density and
compacting the seeds), or raises.  It never falls back.  ``chain_probe``
runs the scan's per-pixel chain alone on the card, to time its bound.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sixdpose_tpu_torch.ops import _build

_ARGTYPES = {
    "floyd_steinberg_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_void_p],
    "floyd_steinberg_chain_launch": [ctypes.c_int, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p],
}
SMEM_LIMIT = 232448  # a block's shared memory on the H100


def smem_bytes(w: int) -> int:
    """Shared memory of the kernel at width w: four rows of float64 (two
    of values, two of density), each with 16 spare elements on either
    side, and two rows of 32-bit seed words (``smem_bytes`` in the
    source)."""
    return 32 * (w + 32) + 8 * (-(-w // 32))


MAX_WIDTH = max(w for w in range(SMEM_LIMIT // 33, SMEM_LIMIT // 32) if smem_bytes(w) <= SMEM_LIMIT)


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
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
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
    if w > MAX_WIDTH:
        raise ValueError(f"density width {w} above the kernel's {MAX_WIDTH} (its rows in shared memory)")
    cap = h * w  # a pixel holds at most one seed
    seeds = torch.empty((cap, 2), dtype=torch.float32, device=dev)
    count = torch.zeros((1,), dtype=torch.int32, device=dev)
    if h * w:
        _build.launch(dev, _library().floyd_steinberg_launch, density.data_ptr(), h, w, seeds.data_ptr(),
                      count.data_ptr(), cap)
        floyd_steinberg.launches += 1
    n = int(count.item())
    return seeds[:n]


floyd_steinberg.launches = 0  # kernel launches, for chip runs to read


def chain_probe(n: int, device, value: float = 0.3) -> torch.Tensor:
    """One launch of the chain probe on the card: one thread runs the
    scan's per-pixel chain (add, compare, select, multiply by 0.4375) ``n``
    times on a pixel value ``value``, in registers.  Returns (2,) float64:
    the last carry and the seed count.  Its time is the scan's bound."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("chain_probe measures the card; it has no plain version")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty((2,), dtype=torch.float64, device=dev)
    _build.launch(dev, _library().floyd_steinberg_chain_launch, n, value, out.data_ptr())
    return out
