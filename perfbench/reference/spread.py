"""Orientation spreading and response maps (copy of the port's
``ops/spread.py``).

Frozen at commit 354f402 as part of the benchmark's yardstick: later
changes to the port do not reach it.  Plain PyTorch and NumPy; imports
nothing of the port.
"""

from __future__ import annotations

import torch

def spread_orientations(quantized: torch.Tensor, t: int) -> torch.Tensor:
    """OR each orientation byte over a t x t window anchored top-left.

    ``quantized``: (..., H, W) uint8 one-hot image -> (..., H, W) multi-hot.
    """
    h, w = quantized.shape[-2], quantized.shape[-1]
    p = torch.nn.functional.pad(quantized, (0, t, 0, t))
    out = torch.zeros_like(quantized)
    for r in range(t):
        for c in range(t):
            out = out | p[..., r : r + h, c : c + w]
    return out


def _rot_bits(x: int, k: int) -> int:
    """Rotate the 8 orientation bits of a byte left by k (cyclic)."""
    return ((x << k) | (x >> (8 - k))) & 0xFF if k else x


def compute_response_maps(spread: torch.Tensor, lut: str = "levelup") -> torch.Tensor:
    """Per-orientation response of a spread image.

    Args:
      spread: (..., H, W) uint8 multi-hot spread image.
      lut: "levelup" (exact -> 4, 45 deg -> 1, else 0), "stock" (4 minus
        the angular distance in bins) or "binary45" (exact or 45 deg -> 4,
        cxxLCHF's LUT, lchf.cpp:450-451).

    Returns:
      (..., 8, H, W) uint8 response maps, one per orientation bin.
    """
    s = spread
    maps = []
    for ori in range(8):
        bit = 1 << ori
        if lut == "binary45":
            near = (s & (bit | _rot_bits(bit, 1) | _rot_bits(bit, 7))) != 0
            resp = torch.where(near, 4, 0)
        elif lut == "levelup":
            exact = (s & bit) != 0
            adj = (s & (_rot_bits(bit, 1) | _rot_bits(bit, 7))) != 0
            resp = torch.where(exact, 4, torch.where(adj, 1, 0))
        elif lut == "stock":
            resp = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
            # Distance d in bin steps contributes 4 - d (cyclic distance <= 4).
            for d in range(4, -1, -1):
                hit = (s & (_rot_bits(bit, d) | _rot_bits(bit, (8 - d) % 8))) != 0
                resp = torch.where(hit, 4 - d, resp)
        else:
            raise ValueError(f"unknown response LUT {lut!r}")
        maps.append(resp.to(torch.uint8))
    return torch.stack(maps, dim=-3)
