"""Correctly rounded square roots (copy of the port's ``ops/sqrt.py``).

Frozen at commit 354f402 as part of the benchmark's yardstick: later
changes to the port do not reach it.  Plain PyTorch and NumPy; imports
nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

def sqrt64(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 sqrt of a float64 tensor, on its device."""
    if x.is_cuda:
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):  # a negative input gives NaN, as torch.sqrt does
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (evaluated in float64 and rounded)."""
    return sqrt64(x.to(torch.float64)).to(torch.float32)
