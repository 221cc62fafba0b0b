"""The port's one square root: correctly rounded on every device.

IEEE 754 asks for a correctly rounded sqrt, and CUDA's (float32 and
float64) and XLA's are.  PyTorch's vectorised CPU ``torch.sqrt`` is not:
it is off by an ulp on about 0.7-0.9% of inputs, in float32 and in
float64.  numpy's is correctly rounded.  So on the CPU these helpers take
numpy's, and on the card CUDA's; both give ``jnp.sqrt``'s bits.

``sqrt32`` goes through float64: the correctly rounded float64 root of a
float32 rounds to the correctly rounded float32 root (a float64 has more
than twice a float32's significand bits plus two, so no double rounding
can occur).
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
