"""Evaluation layer: pose errors, scoring, SIXD-2017 localization protocol.

Port of the JAX package's ``eval`` (reference: pysixd/pose_error.py,
visibility.py, score.py, pose_matching.py and tools/eval_calc_errors.py,
eval_loc.py).
"""

from sixdpose_tpu_torch.eval import loc, misc, pose_error
from sixdpose_tpu_torch.eval.score import ap, match_poses

__all__ = ["misc", "pose_error", "loc", "ap", "match_poses"]
