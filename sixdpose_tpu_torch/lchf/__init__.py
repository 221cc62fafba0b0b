"""Latent-Class Hough Forest (reference: cxxLCHF/, LCHF_test.py).

Port of the JAX package's ``lchf``, with the same names.  Patch features
reuse the detector's quantization/response ops with cxxLCHF's own binary
LUT; the forest trains on patch similarities (host numpy, or the whole
matrix on the device with ``on_device=True``); scenes walk the trees on
the host or on the device; Hough votes accumulate on the device in a
fixed order; leaf pose modes come from mean-shift clustering; vote bins
decode to 6D poses refined by the batched ICP of ``models.refine``.
"""

from sixdpose_tpu_torch.lchf.feature import (
    LchfConfig,
    PatchFeature,
    PatchSet,
    construct_response,
    extract_patch_feature,
    similarity_one_to_many,
)
from sixdpose_tpu_torch.lchf.forest import Forest, Node, Tree
from sixdpose_tpu_torch.lchf.meanshift import cluster_leaf_infos, cluster_modes, mean_shift
from sixdpose_tpu_torch.lchf.model import (
    LchfModel,
    make_training_patches,
    predict_scene,
    scene_roi_set,
    train_forest,
)
from sixdpose_tpu_torch.lchf.voting import (
    accumulate_votes,
    assemble_votes,
    dense_rois,
    hough_vote,
    leaf_mode_map,
)
from sixdpose_tpu_torch.lchf.eval import evaluate_recall
from sixdpose_tpu_torch.lchf.pose import (
    decode_bin_poses,
    evaluate_pose_recall,
    lchf_pose_hypotheses,
    refine_lchf_poses,
)

__all__ = [
    "LchfConfig",
    "PatchFeature",
    "PatchSet",
    "construct_response",
    "extract_patch_feature",
    "similarity_one_to_many",
    "Forest",
    "Node",
    "Tree",
    "mean_shift",
    "cluster_modes",
    "cluster_leaf_infos",
    "LchfModel",
    "make_training_patches",
    "train_forest",
    "scene_roi_set",
    "predict_scene",
    "accumulate_votes",
    "assemble_votes",
    "dense_rois",
    "hough_vote",
    "leaf_mode_map",
    "evaluate_recall",
    "decode_bin_poses",
    "lchf_pose_hypotheses",
    "refine_lchf_poses",
    "evaluate_pose_recall",
]
