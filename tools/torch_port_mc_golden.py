"""Record the JAX package's multi-class match and fused multi-class frame on
a planted two-object scene, as the golden the PyTorch port is held to.

The scene and the training views come from ``sixdpose_tpu_torch.synthetic``
(numpy seeds), so the port regenerates them without JAX.  The script:

1. trains three classes with the JAX ``Detector`` at ``t_at_level=(5, 8)``,
   one template each from the planted shapes (disc, ellipse, rounded
   square), with the refine infos of ``tools/torch_port_golden.py``'s
   ``view_info``;
2. pastes the disc and the rounded square into one cluttered VGA scene
   (``synthetic.planted_scene_multi``), each with its template origin on
   the level-0 stride grid and the coarse grid;
3. matches with the JAX ``MultiClassMatcher`` at threshold 75 and checks
   that each planted class's top kept match is its template at its planted
   position;
4. runs the JAX ``FusedMultiClassPipeline`` on the same scene with the
   settings of the single-class refine golden (threshold 60, 8 hypotheses
   per class, 3 seeds with the flip, 16 ICP iterations, each class verified
   with its template's own points and colours) and checks that each
   planted class's top active pose moves that class's cloud centroid by its
   planted shift;
5. writes ``sixdpose_tpu_torch/testdata/planted_mc_bank.npz`` (the JAX
   ``TemplateBank.save``, infos included) and ``planted_mc_golden.npz``
   (the scene, the settings, and both outputs as (C, K) and (C, R) arrays).

Run from the repository root on the CPU:

    JAX_PLATFORMS=cpu python tools/torch_port_mc_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import sixdpose_tpu.models.templates as JT  # noqa: E402
import torch_port_golden as G  # noqa: E402
from sixdpose_tpu.config import DetectorConfig, IcpConfig  # noqa: E402
from sixdpose_tpu.models.detector import Detector, _offset  # noqa: E402
from sixdpose_tpu.models.multiclass import MultiClassMatcher  # noqa: E402
from sixdpose_tpu.models.pipeline import FusedMultiClassPipeline  # noqa: E402
from sixdpose_tpu_torch import synthetic  # noqa: E402

CLASSES = ("disc", "ellipse", "square")  # shapes 0, 1 and 2 of synthetic.planted_object
PLANTED = ((0, (341, 157)), (2, (90, 350)))  # (class index, nominal top-left (x, y))
FUSED = ("tid", "x", "y", "score", "R", "t_mm", "fitness", "verify", "active")


def main() -> int:
    cfg = DetectorConfig(t_at_level=(5, 8))
    det = Detector(cfg)
    # Record each template's level-0 bbox corner that crop_template_levels
    # subtracts.
    seen = []
    crop = JT.crop_template_levels

    def recording_crop(levels):
        seen.append(levels)
        return crop(levels)

    JT.crop_template_levels = recording_crop
    try:
        for shape, cid in enumerate(CLASSES):
            rgb, depth, mask = synthetic.training_view(shape, at=G.TRAIN_AT)
            if det.add_template(cid, rgb, depth, mask, G.view_info(rgb, depth, mask)) != 0:
                print(f"class {cid} failed to extract", file=sys.stderr)
                return 1
    finally:
        JT.crop_template_levels = crop

    placements, expected, shifts = [], [], []
    for ci, (nx, ny) in PLANTED:
        pts = [(f[:, 0] << l, f[:, 1] << l) for l, mods in enumerate(seen[ci]) for f in mods]
        min_x = int(min(x.min() for x, _ in pts))
        min_y = int(min(y.min() for _, y in pts))
        ox, oy = min_x - min_x % 2 - G.TRAIN_AT[0], min_y - min_y % 2 - G.TRAIN_AT[1]
        # Template origin on the level-0 stride grid (t=5) and the coarse
        # grid of level 1 (2 * 8 pixels at level 0).
        px, py = nx - (nx + ox) % 80, ny - (ny + oy) % 80
        placements.append((ci, px, py))
        expected.append((px + ox + _offset(5), py + oy + _offset(5)))
        _, train_depth, train_mask = synthetic.training_view(ci, at=G.TRAIN_AT)
        shifts.append(G.planted_shift_mm((px - G.TRAIN_AT[0], py - G.TRAIN_AT[1]), train_depth, train_mask))
    scene_rgb, scene_depth = synthetic.planted_scene_multi(placements, seed=G.SCENE_SEED)

    mc = MultiClassMatcher(det)
    tid, x, y, score, keep = (np.asarray(a) for a in mc.match_arrays(scene_rgb, scene_depth, G.THRESHOLD))
    for (ci, _), exp in zip(PLANTED, expected):
        live = np.flatnonzero(keep[ci] & (score[ci] >= 0))
        top = [(int(tid[ci, i]), int(x[ci, i]), int(y[ci, i]), float(score[ci, i])) for i in live[:3]]
        print(f"{CLASSES[ci]}: expected top match (0, {exp}); {len(live)} kept, top {top}")
        if not len(live) or top[0][:3] != (0, *exp):
            print("the JAX multi-class matcher misses a planted object; fixture not written", file=sys.stderr)
            return 1

    infos = [det.bank.infos[cid][0] for cid in CLASSES]
    vpts = {cid: (info["icp_points"] * 1000.0).astype(np.float32) for cid, info in zip(CLASSES, infos)}
    vcols = {cid: info["icp_colors"].astype(np.float32) for cid, info in zip(CLASSES, infos)}
    pipe = FusedMultiClassPipeline(det, synthetic.BENCH_K, icp=IcpConfig(max_iters=G.ICP_ITERS),
                                   verify_pts=vpts, verify_colors=vcols, **G.REFINE)
    fused = [np.asarray(a) for a in pipe(scene_rgb, scene_depth, G.REFINE_THRESHOLD)]
    for (ci, _), shift in zip(PLANTED, shifts):
        active = fused[8][ci]
        top = int(np.flatnonzero(active)[0]) if active.any() else -1
        moved = G.centroid_shift_mm(fused[4][ci, top], fused[5][ci, top], infos[ci]["icp_points"])
        print(f"{CLASSES[ci]} fused: {int(active.sum())} active, fitness {np.round(fused[6][ci][active], 3).tolist()}, "
              f"verify {np.round(fused[7][ci][active], 3).tolist()}; top pose moves the centroid by "
              f"{np.round(moved, 2).tolist()} mm, planted shift {np.round(shift, 2).tolist()} mm")
        if top < 0 or fused[0][ci, top] != 0 or np.linalg.norm(moved - shift) > G.TRANSLATION_TOL_MM:
            print("the JAX fused multi-class pipeline misses a planted pose; fixture not written", file=sys.stderr)
            return 1

    p_max = max(len(v) for v in vpts.values())
    pad = lambda a: np.pad(a, ((0, p_max - len(a)), (0, 0)))  # noqa: E731
    os.makedirs(G.OUT_DIR, exist_ok=True)
    det.write_classes(os.path.join(G.OUT_DIR, "planted_mc_bank.npz"))
    np.savez(
        os.path.join(G.OUT_DIR, "planted_mc_golden.npz"),
        class_ids=np.array(CLASSES),
        placements=np.array(placements, np.int32),
        expected_xy=np.array(expected, np.int32),
        scene_seed=np.int32(G.SCENE_SEED),
        t_at_level=np.array(cfg.t_at_level, np.int32),
        threshold=np.float32(G.THRESHOLD),
        tid=tid.astype(np.int32), x=x.astype(np.int32), y=y.astype(np.int32),
        score=score.astype(np.float32), keep=keep.astype(bool),
        refine_threshold=np.float32(G.REFINE_THRESHOLD),
        K=synthetic.BENCH_K,
        icp_max_iters=np.int32(G.ICP_ITERS),
        max_refine=np.int32(G.REFINE["max_refine"]),
        num_points=np.int32(G.REFINE["num_points"]),
        icp_seeds=np.int32(G.REFINE["icp_seeds"]),
        seed_flip=np.bool_(G.REFINE["seed_flip"]),
        verify_pts=np.stack([pad(vpts[c]) for c in CLASSES]),
        verify_colors=np.stack([pad(vcols[c]) for c in CLASSES]),
        verify_count=np.array([len(vpts[c]) for c in CLASSES], np.int32),
        planted_shift_mm=np.array(shifts, np.float32),
        translation_tol_mm=np.float32(G.TRANSLATION_TOL_MM),
        **{f"fused_{name}": a for name, a in zip(FUSED, fused)},
    )
    print(f"wrote {G.OUT_DIR}/planted_mc_bank.npz and planted_mc_golden.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
