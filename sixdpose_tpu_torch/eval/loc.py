"""SIXD-2017 6D localization evaluation.

Reference: tools/eval_calc_errors.py (per-estimate errors) and
tools/eval_loc.py (GT matching, recall, LINEMOD/Occlusion split).
Protocol (eval_loc.py:7-14, 205-216): n_top=1, VSD delta=15 tau=20
cost='step' threshold 0.3; ADD/ADI threshold 0.1 x object diameter;
GT valid when visib_fract >= 0.1.

A numpy copy of the JAX package's ``eval/loc.py`` over the port's
``pose_error``; ``calc_errors`` renders on ``device`` (CUDA by default).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from sixdpose_tpu_torch.eval import pose_error
from sixdpose_tpu_torch.eval.score import match_poses


def calc_errors(
    ests: List[dict],
    gts: List[dict],
    model: dict,
    depth_test: Optional[np.ndarray],
    K: Optional[np.ndarray],
    error_type: str = "vsd",
    vsd_delta: float = 15.0,
    vsd_tau: float = 20.0,
    vsd_cost: str = "step",
    n_top: int = 1,
    adi_max_pts: Optional[int] = 4096,
    device=None,
) -> List[dict]:
    """Per-estimate errors against every GT pose in an image
    (tools/eval_calc_errors.py:52-190).

    Args:
      ests: [{'score', 'R', 't'}], sorted or not (top n_top by score kept).
      gts: [{'obj_id', 'cam_R_m2c', 'cam_t_m2c'}].

    Returns [{'est_id', 'score', 'errors': {gt_id: err}}].
    """
    ests_s = sorted(enumerate(ests), key=lambda p: p[1]["score"], reverse=True)
    if n_top > 0:
        ests_s = ests_s[:n_top]
    out = []
    for est_id, est in ests_s:
        errors = {}
        for gt_id, gt in enumerate(gts):
            R_g, t_g = gt["cam_R_m2c"], gt["cam_t_m2c"]
            R_e, t_e = est["R"], est["t"]
            if error_type == "vsd":
                e = pose_error.vsd(
                    R_e, t_e, R_g, t_g, model, depth_test, K,
                    vsd_delta, vsd_tau, vsd_cost, device=device,
                )
            elif error_type == "add":
                e = pose_error.add(R_e, t_e, R_g, t_g, model, device=device)
            elif error_type == "adi":
                e = pose_error.adi(R_e, t_e, R_g, t_g, model, max_pts=adi_max_pts, device=device)
            elif error_type == "cou":
                im_size = (depth_test.shape[1], depth_test.shape[0])
                e = pose_error.cou(R_e, t_e, R_g, t_g, model, im_size, K, device=device)
            elif error_type == "re":
                e = pose_error.re(R_e, R_g)
            elif error_type == "te":
                e = pose_error.te(t_e, t_g)
            else:
                raise ValueError(f"unknown error type {error_type!r}")
            errors[gt_id] = float(e)
        out.append({"est_id": est_id, "score": est["score"], "errors": errors})
    return out


def match_scene(
    gts: Dict[int, List[dict]],
    gt_visib: Dict[int, List[float]],
    errs_by_im: Dict[int, Dict[int, List[dict]]],
    scene_id: int,
    error_threshs: Dict[int, float],
    n_top: int = 1,
    visib_gt_min: float = 0.1,
) -> List[dict]:
    """Match estimates to GT across one scene (tools/eval_loc.py:27-78).

    errs_by_im: im_id -> obj_id -> calc_errors output.
    gt_visib: im_id -> visib_fract per gt.
    """
    matches = []
    for im_id, gts_im in gts.items():
        matches_im = []
        for gt_id, gt in enumerate(gts_im):
            valid = gt_visib[im_id][gt_id] >= visib_gt_min
            matches_im.append(
                {
                    "scene_id": scene_id,
                    "im_id": im_id,
                    "obj_id": gt["obj_id"],
                    "gt_id": gt_id,
                    "est_id": -1,
                    "score": -1.0,
                    "error": -1.0,
                    "error_norm": -1.0,
                    "valid": int(valid),
                }
            )
        gt_valid_mask = [bool(m["valid"]) for m in matches_im]
        for obj_id in {gt["obj_id"] for gt in gts_im}:
            errs = errs_by_im.get(im_id, {}).get(obj_id)
            if not errs:
                continue
            ms = match_poses(errs, error_threshs[obj_id], n_top, gt_valid_mask)
            for m in ms:
                g = matches_im[m["gt_id"]]
                g.update(
                    est_id=m["est_id"],
                    score=m["score"],
                    error=m["error"],
                    error_norm=m["error_norm"],
                )
        matches += matches_im
    return matches


def calc_scores(
    scene_ids: Sequence[int],
    obj_ids: Sequence[int],
    matches: List[dict],
    n_top: int = 1,
    do_print: bool = False,
) -> dict:
    """Total / per-object / per-scene recall (tools/eval_loc.py:88-172)."""
    insts = {i: {j: defaultdict(int) for j in scene_ids} for i in obj_ids}
    for m in matches:
        if m["valid"]:
            insts[m["obj_id"]][m["scene_id"]][m["im_id"]] += 1

    tars = 0
    obj_tars = {i: 0 for i in obj_ids}
    scene_tars = {j: 0 for j in scene_ids}
    for obj_id, obj_insts in insts.items():
        for scene_id, scene_insts in obj_insts.items():
            if n_top > 0:
                count = sum(min(n_top, c) for c in scene_insts.values())
            else:
                count = sum(scene_insts.values())
            tars += count
            obj_tars[obj_id] += count
            scene_tars[scene_id] += count

    tps = 0
    obj_tps = {i: 0 for i in obj_ids}
    scene_tps = {j: 0 for j in scene_ids}
    for m in matches:
        if m["valid"] and m["est_id"] != -1:
            tps += 1
            obj_tps[m["obj_id"]] += 1
            scene_tps[m["scene_id"]] += 1

    recall = lambda tp, n: (tp / float(n)) if n else 0.0
    obj_recalls = {i: recall(obj_tps[i], obj_tars[i]) for i in obj_ids}
    scene_recalls = {j: recall(scene_tps[j], scene_tars[j]) for j in scene_ids}
    scores = {
        "total_recall": recall(tps, tars),
        "obj_recalls": obj_recalls,
        "mean_obj_recall": float(np.mean(list(obj_recalls.values()))) if obj_recalls else 0.0,
        "scene_recalls": scene_recalls,
        "mean_scene_recall": float(np.mean(list(scene_recalls.values()))) if scene_recalls else 0.0,
        "gt_count": len(matches),
        "targets_count": tars,
        "tp_count": tps,
    }
    if do_print:
        print(
            "GT {gt_count}  targets {targets_count}  TP {tp_count}  "
            "total recall {total_recall:.4f}  mean obj {mean_obj_recall:.4f}  "
            "mean scene {mean_scene_recall:.4f}".format(**scores)
        )
    return scores


def split_hinterstoisser(matches: List[dict]):
    """LINEMOD (scene==obj) / Occlusion (scene 2, 9 objects) split
    (tools/eval_loc.py:305-337)."""
    linemod = [m for m in matches if m["scene_id"] == m["obj_id"]]
    occlusion = [m for m in matches if m["scene_id"] == 2]
    occlusion_obj_ids = [1, 2, 5, 6, 8, 9, 10, 11, 12]
    return linemod, occlusion, occlusion_obj_ids
