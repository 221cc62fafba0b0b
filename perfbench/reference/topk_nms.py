"""Fixed-K candidate selection and box NMS (copy of the port's
``ops/topk_nms.py``).

Frozen at commit 354f402 as part of the benchmark's yardstick: later
changes to the port do not reach it.  Plain PyTorch and NumPy; imports
nothing of the port.
"""

from __future__ import annotations

import torch

def topk_candidates(scores: torch.Tensor, threshold: float, k: int):
    """Top-k (template, y, x) candidates above a score threshold.

    Ties keep the lower flat index first, as ``jax.lax.top_k`` does
    (``torch.topk`` gives no such order), by a stable descending sort.

    Args:
      scores: (..., N, H, W) float32 normalized scores.
      threshold: minimum score (reference ``score > threshold``, cpp:1843).
      k: fixed candidate budget, at most N*H*W.

    Returns:
      tid, y, x: (..., k) int32 indices; score: (..., k) float32 (-1 where
      invalid).
    """
    n, h, w = scores.shape[-3:]
    flat = scores.reshape(*scores.shape[:-3], n * h * w)
    flat = torch.where(flat > threshold, flat, torch.full_like(flat, -1.0))
    top_scores, top_idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    tid = top_idx // (h * w)
    rem = top_idx % (h * w)
    valid = top_scores > threshold
    zero = torch.zeros_like(top_idx)
    return (
        torch.where(valid, tid, zero).to(torch.int32),
        torch.where(valid, rem // w, zero).to(torch.int32),
        torch.where(valid, rem % w, zero).to(torch.int32),
        torch.where(valid, top_scores, torch.full_like(top_scores, -1.0)),
    )


def nms_boxes(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy box NMS over fixed-size candidate sets.

    Args:
      boxes: (..., K, 4) float32 (x, y, w, h).
      scores: (..., K) float32, invalid entries < 0, sorted descending.
      iou_threshold: suppress overlaps above this IoU.

    Returns:
      keep: (..., K) bool mask of surviving boxes.
    """
    k = boxes.shape[-2]
    x1 = boxes[..., 0]
    y1 = boxes[..., 1]
    x2 = boxes[..., 0] + boxes[..., 2]
    y2 = boxes[..., 1] + boxes[..., 3]
    area = boxes[..., 2].clamp(min=0) * boxes[..., 3].clamp(min=0)

    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    iou = inter / union.clamp(min=1e-9)

    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    overlaps = (iou > iou_threshold) & later  # [i, j]: j > i overlaps i
    keep = scores >= 0
    # Greedy and sequential: a box suppresses later ones only if it is kept.
    for i in range(k):
        keep = keep & ~(overlaps[..., i, :] & keep[..., i : i + 1])
    return keep
