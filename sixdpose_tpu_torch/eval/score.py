"""Scoring: VOC-2010 AP and pose matching.

Reference: pysixd/score.py (ap:6-38) and pysixd/pose_matching.py
(match_poses:4-36).  A numpy copy of the JAX package's ``eval/score.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def ap(rec, pre) -> float:
    """PASCAL VOC 2010+ Average Precision: area under the monotonically
    decreasing precision/recall curve (score.py:6-38)."""
    i = np.argsort(rec)
    mrec = np.concatenate(([0.0], np.asarray(rec, float)[i], [1.0]))
    mpre = np.concatenate(([0.0], np.asarray(pre, float)[i], [0.0]))
    for j in range(mpre.size - 3, -1, -1):
        mpre[j] = max(mpre[j], mpre[j + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def match_poses(
    errs: List[dict],
    error_thresh: float,
    max_ests_count: int = -1,
    gt_valid_mask: Optional[List[bool]] = None,
) -> List[dict]:
    """Greedy score-ordered matching of estimates to GT poses
    (pose_matching.py:4-36).

    Each element of ``errs`` is {'est_id', 'score', 'errors': {gt_id: e}}.
    """
    errs_s = sorted(errs, key=lambda e: e["score"], reverse=True)
    if max_ests_count > 0:
        errs_s = errs_s[:max_ests_count]
    matches = []
    gt_matched: List[int] = []
    for e in errs_s:
        best_gt_id = -1
        best_error = float("inf")
        for gt_id, error in e["errors"].items():
            if (
                (not gt_valid_mask or gt_valid_mask[gt_id])
                and gt_id not in gt_matched
                and error < best_error
            ):
                best_gt_id = gt_id
                best_error = error
        if best_error < error_thresh:
            gt_matched.append(best_gt_id)
            matches.append(
                {
                    "est_id": e["est_id"],
                    "gt_id": best_gt_id,
                    "score": e["score"],
                    "error": best_error,
                    "error_norm": best_error / float(error_thresh),
                }
            )
    return matches
