"""Depth-histogram scale proposals (copy of the port's
``ops/scale_proposal.py``).

Frozen at commit 354f402 as part of the benchmark's yardstick: later
changes to the port do not reach it.  Plain PyTorch and NumPy; imports
nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

def propose_depth_bins(
    depth: torch.Tensor,
    num_scales: int = 5,
    bin_mm: int = 100,
    lo_mm: int = 400,
    hi_mm: int = 2000,
    nms_radius: int = 2,
    min_pixels: int = 200,
):
    """Like :func:`propose_depths`, with the proposals' histogram-bin
    indices, for selecting among tables prebuilt per depth bin.

    Returns (bin_idx (S,) int32, depths (S,) float32, counts (S,) int32);
    bin_idx and depth are 0 where there is no valid peak.
    """
    depths, counts, idx = _peaks(depth, num_scales, bin_mm, lo_mm, hi_mm, nms_radius, min_pixels)
    return torch.where(counts > 0, idx, torch.zeros_like(idx)), depths, counts


def _peaks(depth, num_scales, bin_mm, lo_mm, hi_mm, nms_radius, min_pixels):
    """(depths, counts, bin index) of the ``num_scales`` strongest peaks."""
    nb = (hi_mm - lo_mm) // bin_mm
    d = depth.reshape(-1).to(torch.int32)
    ok = (d >= lo_mm) & (d < hi_mm)
    bins = torch.clamp((d - lo_mm) // bin_mm, 0, nb - 1)
    hist = torch.zeros(nb, dtype=torch.int32, device=depth.device)
    hist.scatter_add_(0, bins.to(torch.int64), ok.to(torch.int32))

    # 1-D NMS: a bin survives if it is the max over +-nms_radius bins.
    padded = F.pad(hist, (nms_radius, nms_radius))
    windows = torch.stack([padded[i : i + nb] for i in range(2 * nms_radius + 1)])
    local_max = hist >= windows.max(dim=0).values
    peak_counts = torch.where(local_max & (hist >= min_pixels), hist, torch.zeros_like(hist))

    top_counts, top_idx = torch.sort(peak_counts, descending=True, stable=True)
    top_counts, top_idx = top_counts[:num_scales], top_idx[:num_scales].to(torch.int32)
    centers = lo_mm + (top_idx.to(torch.float32) + 0.5) * bin_mm
    depths = torch.where(top_counts > 0, centers, torch.zeros_like(centers))
    return depths, top_counts, top_idx


def bin_centers(bin_mm: int = 100, lo_mm: int = 400, hi_mm: int = 2000) -> np.ndarray:
    """The depth-bin centres of ``propose_depth_bins`` (float64, mm)."""
    nb = (hi_mm - lo_mm) // bin_mm
    return lo_mm + (np.arange(nb) + 0.5) * bin_mm
