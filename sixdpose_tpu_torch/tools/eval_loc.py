"""6D localization scores from calculated errors.

Twin of the JAX package's ``tools/eval_loc.py`` (reference:
tools/eval_loc.py).  Protocol (eval_loc.py:7-14, 205-216): n_top=1, VSD
threshold 0.3, ADD/ADI threshold 0.1 x object diameter, GT valid when
visib_fract >= 0.1.  For 'hinterstoisser', also reports the LINEMOD
(scene == obj) and Occlusion (scene 2, 9 objects) splits.

Example:
  python -m sixdpose_tpu_torch.tools.eval_loc --dataset hinterstoisser \
      --errors eval/sixdpose/error=vsd_ntop=1_delta=15_tau=20_cost=step
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from sixdpose_tpu_torch.eval.loc import calc_scores, match_scene, split_hinterstoisser


def error_threshold(etype: str, obj_id: int, diameters: Dict[int, float], threshold: Optional[float] = None) -> float:
    """The correctness threshold of an error type for an object
    (eval_loc.py:205-216)."""
    if threshold is not None:
        return threshold
    if etype == "vsd":
        return 0.3
    if etype in ("add", "adi"):
        return 0.1 * diameters.get(obj_id, 100.0)
    return {"cou": 0.5, "re": 5.0, "te": 50.0}.get(etype, 0.3)


def localization_scores(
    scenes: Sequence[Tuple[int, List[dict], Dict[int, List[dict]], Dict[int, List[float]]]],
    etype: str,
    diameters: Dict[int, float],
    threshold: Optional[float] = None,
    n_top: int = 1,
    visib_gt_min: float = 0.1,
    hinterstoisser: bool = False,
    do_print: bool = False,
) -> dict:
    """Recall over scenes given as (scene_id, error entries, ground truth,
    visible fractions per image, ``{}`` for fully visible).

    Returns ``{"all": scores}``, plus ``"linemod"`` and, when scene 2 has
    matches, ``"occlusion"`` for the hinterstoisser splits
    (``eval.loc.calc_scores``' dicts).
    """
    matches, scene_ids, obj_ids = [], [], set()
    for scene_id, errors, gts, visib in scenes:
        scene_ids.append(scene_id)
        gt_visib = {im: visib.get(im, [1.0] * len(lst)) for im, lst in gts.items()}
        errs_by_im, threshs = {}, {}
        for e in errors:
            errs_by_im.setdefault(e["im_id"], {}).setdefault(e["obj_id"], []).append(e)
            obj_ids.add(e["obj_id"])
            threshs[e["obj_id"]] = error_threshold(etype, e["obj_id"], diameters, threshold)
        for lst in gts.values():
            for g in lst:
                obj_ids.add(g["obj_id"])
                threshs.setdefault(g["obj_id"], error_threshold(etype, g["obj_id"], diameters, threshold))
        matches += match_scene(gts, gt_visib, errs_by_im, scene_id, threshs, n_top=n_top, visib_gt_min=visib_gt_min)
    obj_ids = sorted(obj_ids)
    if do_print:
        print("== all scenes ==")
    out = {"all": calc_scores(scene_ids, obj_ids, matches, n_top, do_print=do_print)}
    if hinterstoisser:
        lm, occ, occ_objs = split_hinterstoisser(matches)
        if do_print:
            print("== LINEMOD split (scene == obj) ==")
        out["linemod"] = calc_scores(scene_ids, obj_ids, lm, n_top, do_print=do_print)
        if occ:
            if do_print:
                print("== Occlusion split (scene 2) ==")
            out["occlusion"] = calc_scores([2], occ_objs, occ, n_top, do_print=do_print)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="hinterstoisser")
    ap.add_argument("--base-path", default=None)
    ap.add_argument("--errors", required=True, help="error dir from eval_calc_errors")
    ap.add_argument("--error-type", default=None, help="inferred from dir name")
    ap.add_argument("--threshold", type=float, default=None)
    ap.add_argument("--visib-gt-min", type=float, default=0.1)
    ap.add_argument("--n-top", type=int, default=1)
    args = ap.parse_args(argv)

    import yaml

    from sixdpose_tpu_torch.data import get_dataset_params, inout

    dp = get_dataset_params(args.dataset, base_path=args.base_path)
    etype = args.error_type or os.path.basename(os.path.normpath(args.errors)).split("_")[0].split("=")[1]
    diameters = {}
    if etype in ("add", "adi") and os.path.exists(dp["models_info_path"]):
        with open(dp["models_info_path"]) as f:
            diameters = {int(k): float(v["diameter"]) for k, v in yaml.safe_load(f).items()}
    scenes = []
    for err_path in sorted(glob.glob(os.path.join(args.errors, "errors_*.yml"))):
        scene_id = int(os.path.basename(err_path)[7:9])
        stats_path = dp["scene_gt_stats_mpath"].format(scene_id, 15)
        visib = {}
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                visib = {int(im): [g["visib_fract"] for g in lst] for im, lst in yaml.safe_load(f).items()}
        scenes.append((scene_id, inout.load_errors(err_path), inout.load_gt(dp["scene_gt_mpath"].format(scene_id)),
                       visib))
    localization_scores(scenes, etype, diameters, args.threshold, args.n_top, args.visib_gt_min,
                        hinterstoisser=args.dataset == "hinterstoisser", do_print=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
