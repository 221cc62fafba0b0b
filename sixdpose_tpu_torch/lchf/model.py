"""LCHF model API: training-set construction, forest train/predict on scenes.

Port of the JAX package's ``lchf/model.py``.  Reference: namespace lchf_model
(cxxLCHF/forest.h:551-567, forest.cpp:14-129, 240-289) and the LCHF_test.py
driver's render_train patch slicing (LCHF_test.py:122-258: 50x50 patches
at stride 10 from views rendered at radius 500; label = view rpy + patch
offset from the object center).

``on_device`` chooses the route, as ``device`` does in the JAX package:
False is the host numpy route (float64 similarities), True the device
route (the whole training matrix, or the forest walk, in float32 on the
device).  ``device`` is where the image ops and the device route run:
CUDA unless ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.geometry.transform import euler_from_matrix
from sixdpose_tpu_torch.lchf.feature import (
    LchfConfig,
    PatchFeature,
    PatchSet,
    _depth_tensor,
    _rgb_tensor,
    construct_response_tensor,
    extract_patch_feature,
    mean_depth_5x5_tensor,
    similarity_one_to_many,
)
from sixdpose_tpu_torch.lchf.forest import Forest


@dataclasses.dataclass
class LchfModel:
    """Trained forest + its training patches/labels."""

    forest: Forest
    patches: List[PatchFeature]
    patch_set: PatchSet
    rpy: np.ndarray   # (N, 3)
    t: np.ndarray     # (N, 3) patch offset labels

    def leaf_feats_map(self):
        return self.forest.leaf_feats_map()

    # -- persistence: the JAX package's files, so a model saved by either
    #    package loads into the other ------------------------------------

    def save(self, prefix: str) -> None:
        """Write <prefix>.forest.npz and <prefix>.patches.npz."""
        self.forest.save(prefix + ".forest.npz")
        payload = {
            "rpy": self.rpy,
            "t": self.t,
            "set_responses": self.patch_set.responses,
            "set_zavg": self.patch_set.z_avg,
            "set_center": self.patch_set.center,
        }
        for i, p in enumerate(self.patches):
            payload[f"p{i}|features"] = p.features
            payload[f"p{i}|z_rel"] = p.z_rel
            payload[f"p{i}|meta"] = np.array(
                [p.center_dep, p.shape[0], p.shape[1]], np.float64
            )
        np.savez_compressed(prefix + ".patches.npz", **payload)

    @classmethod
    def load(cls, prefix: str) -> "LchfModel":
        forest = Forest.load(prefix + ".forest.npz")
        with np.load(prefix + ".patches.npz") as z:
            pset = PatchSet(z["set_responses"], z["set_zavg"], z["set_center"])
            patches: List[PatchFeature] = []
            i = 0
            while f"p{i}|features" in z:
                meta = z[f"p{i}|meta"]
                patches.append(
                    PatchFeature(
                        features=z[f"p{i}|features"],
                        z_rel=z[f"p{i}|z_rel"],
                        center_dep=float(meta[0]),
                        responses=None,
                        z_avg=None,
                        shape=(int(meta[1]), int(meta[2])),
                    )
                )
                i += 1
            return cls(
                forest=forest,
                patches=patches,
                patch_set=pset,
                rpy=z["rpy"],
                t=z["t"],
            )


def make_training_patches(
    rgb: np.ndarray,
    depth: np.ndarray,
    mask: np.ndarray,
    R: np.ndarray,
    cfg: LchfConfig = LchfConfig(),
    patch: int = 50,
    stride: int = 10,
    device=None,
):
    """Slice one rendered view into labeled training patches
    (LCHF_test.py:170-245).

    Returns (features, rpy_labels, t_labels): label rpy is the view's euler
    angles; label t is the patch top-left offset from the rendered object
    center (px, px, mm) so votes can be cast back to the center.
    """
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return [], [], []
    device = resolve_device(device)
    cx, cy = xs.mean(), ys.mean()
    rpy = np.array(euler_from_matrix(R), np.float32)
    feats, rpys, ts = [], [], []
    h, w = depth.shape
    for y0 in range(max(ys.min() - patch // 2, 0), min(ys.max(), h - patch), stride):
        for x0 in range(max(xs.min() - patch // 2, 0), min(xs.max(), w - patch), stride):
            sub_mask = mask[y0 : y0 + patch, x0 : x0 + patch]
            if sub_mask.sum() < 0.2 * patch * patch:
                continue
            f = extract_patch_feature(
                rgb[y0 : y0 + patch, x0 : x0 + patch],
                depth[y0 : y0 + patch, x0 : x0 + patch],
                sub_mask,
                cfg,
                with_responses=True,
                device=device,
            )
            if f is None:
                continue
            feats.append(f)
            rpys.append(rpy)
            ts.append(np.array([x0 - cx, y0 - cy, 0.0], np.float32))
    return feats, rpys, ts


def train_forest(
    patches: Sequence[PatchFeature],
    rpy: np.ndarray,
    t: np.ndarray,
    cfg: LchfConfig = LchfConfig(),
    num_trees: int = 5,
    train_ratio: float = 0.8,
    seed: int = 0,
    on_device: bool = False,
    device=None,
    **tree_kw,
) -> LchfModel:
    """lchf_model_train (forest.cpp:14-18): bagged forest over patch
    similarities.

    ``on_device=True`` computes the full N x N similarity matrix on the
    device first (training's hot loop is similarity(pivot -> cohort) per
    split attempt); every split then reads array rows.  The splits
    themselves are host numpy either way.
    """
    pset = PatchSet.from_features(patches)

    if on_device:
        from sixdpose_tpu_torch.lchf.device import similarity_matrix_device

        sim_matrix = similarity_matrix_device(patches, pset, cfg.z_check, device)

        def similarity_rows(pivot: int, members: np.ndarray) -> np.ndarray:
            return sim_matrix[pivot, np.asarray(members)]
    else:
        def similarity_rows(pivot: int, members: np.ndarray) -> np.ndarray:
            return similarity_one_to_many(
                patches[pivot], pset, members, cfg.z_check
            )

    forest = Forest(num_trees=num_trees, train_ratio=train_ratio, seed=seed, **tree_kw)
    forest.train(similarity_rows, np.asarray(rpy, np.float32))
    return LchfModel(
        forest=forest,
        patches=list(patches),
        patch_set=pset,
        rpy=np.asarray(rpy, np.float32),
        t=np.asarray(t, np.float32),
    )


def scene_roi_set(
    rgb: np.ndarray,
    depth: np.ndarray,
    rois: np.ndarray,
    cfg: LchfConfig = LchfConfig(),
    device=None,
) -> PatchSet:
    """Whole-scene response computed ONCE, cropped per ROI — the key
    inference trick (get_feats_from_scene, forest.cpp:253-289)."""
    device = resolve_device(device)
    rgb_t, dep_t = _rgb_tensor(rgb, device), _depth_tensor(depth, device)
    responses = construct_response_tensor(rgb_t, dep_t, cfg).cpu().numpy()  # (16, Hp, Wp)
    zavg = mean_depth_5x5_tensor(dep_t).cpu().numpy()
    m = len(rois)
    p = int(max(rois[:, 2].max(), rois[:, 3].max()))
    resp = np.zeros((m, 16, p, p), np.uint8)
    za = np.zeros((m, p, p), np.float32)
    center = np.zeros((m,), np.float32)
    h, w = depth.shape
    for i, (x, y, rw, rh, d) in enumerate(rois):
        x2, y2 = min(x + rw, w), min(y + rh, h)
        resp[i, :, : y2 - y, : x2 - x] = responses[:, y:y2, x:x2]
        za[i, : y2 - y, : x2 - x] = zavg[y:y2, x:x2]
        center[i] = d
    return PatchSet(resp, za, center)


def predict_scene(
    model: LchfModel,
    roi_set: PatchSet,
    cfg: LchfConfig = LchfConfig(),
    on_device: bool = False,
    device=None,
) -> List[List[int]]:
    """Leaf id per (roi, tree) (lchf_model_predict, forest.cpp:20-28).

    ROIs traverse each tree level-synchronously so every node's pivot
    similarity is computed for its whole cohort in one vectorized call.
    ``on_device=True`` runs the whole tree walk on the device
    (``lchf.device.DeviceForest``): every ROI carries its node id and each
    level gathers its own pivot's features, with no host round trips
    between levels.
    """
    m = roi_set.responses.shape[0]
    if on_device:
        from sixdpose_tpu_torch.lchf.device import DeviceForest

        return DeviceForest(model, cfg.z_check, device).predict(roi_set).tolist()
    out = np.zeros((m, len(model.forest.trees)), np.int64)
    for ti, tree in enumerate(model.forest.trees):
        cohort = {0: np.arange(m)}
        leaves = np.zeros(m, np.int64)
        while cohort:
            nxt = {}
            for nid, idxs in cohort.items():
                node = tree.nodes[nid]
                if node.isleafnode:
                    leaves[idxs] = nid
                    continue
                sims = similarity_one_to_many(
                    model.patches[node.split_feat_idx], roi_set, idxs, cfg.z_check
                )
                go_left = sims <= node.simi_thresh
                li, ri = node.cnodes
                if go_left.any():
                    nxt.setdefault(li, []).append(idxs[go_left])
                if (~go_left).any():
                    nxt.setdefault(ri, []).append(idxs[~go_left])
            cohort = {
                k: np.concatenate(v) for k, v in nxt.items()
            }
        out[:, ti] = leaves
    return out.tolist()
