"""Record the JAX package's detections and refined poses on the synthetic
planted-object scene, as the golden the PyTorch port is held to on the GPU.

The scene and the training views come from ``sixdpose_tpu_torch.synthetic``
(numpy seeds), so the port regenerates them without JAX.  The script:

1. trains a bank of three templates (disc, ellipse, rounded square) with the
   JAX ``Detector.add_template`` at ``t_at_level=(5, 8)``; each template's
   info carries the refine inputs of its own training view: the
   backprojected object pixels (``icp_points``, camera ``synthetic.BENCH_K``)
   and their colours, an identity pose and the mask's bbox;
2. places object 0 in a cluttered VGA scene so that its template origin
   lies on the level-0 stride grid;
3. matches with the JAX detector at threshold 75 and checks that the top
   match is template 0 at the planted position;
4. runs the JAX ``FusedPipeline`` (match, batched ICP, verification) on the
   same scene and checks that its top active pose moves template 0's cloud
   centroid by the planted shift (the pose's own translation is about the
   camera origin: a rotation of a few degrees about the dome's centre, a
   near-symmetry of a dome, moves it by tens of mm);
5. writes ``sixdpose_tpu_torch/testdata/planted_bank.npz`` (the JAX
   ``TemplateBank.save``, infos included), ``planted_golden.npz`` (the
   scene position and the JAX ``tid, x, y, score, keep``) and
   ``planted_refine_golden.npz`` (the fused pipeline's settings, inputs and
   outputs).

Run from the repository root on the CPU:

    JAX_PLATFORMS=cpu python tools/torch_port_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sixdpose_tpu.models.templates as JT  # noqa: E402
from sixdpose_tpu.config import DetectorConfig, IcpConfig  # noqa: E402
from sixdpose_tpu.models.detector import Detector, _offset  # noqa: E402
from sixdpose_tpu.models.pipeline import FusedPipeline  # noqa: E402
from sixdpose_tpu.models.refine import sample_model_points  # noqa: E402
from sixdpose_tpu_torch import synthetic  # noqa: E402

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")
CLASS_ID = "planted"
THRESHOLD = 75.0
TRAIN_AT = (264, 184)
NOMINAL_AT = (341, 157)
SCENE_SEED = 11
# The fused pipeline's settings.
REFINE_THRESHOLD = 60.0
REFINE = dict(max_refine=8, num_points=512, icp_seeds=3, seed_flip=True)
ICP_ITERS = 16
TRANSLATION_TOL_MM = 5.0


def view_info(rgb, depth, mask) -> dict:
    """Refine infos of a training view: its object pixels backprojected with
    the bench camera (512 at most) and their colours, the identity pose,
    and the mask's bbox (x0, y0, x1, y1)."""
    obj = np.where(mask > 0, depth, 0).astype(np.uint16)
    pts, valid, (ys, xs) = sample_model_points(obj, synthetic.BENCH_K, 512, return_pixels=True)
    my, mx = np.nonzero(mask)
    return {
        "cam_K": synthetic.BENCH_K.astype(np.float64),
        "cam_R_w2c": np.eye(3),
        "cam_t_w2c": np.zeros((3, 1)),
        "icp_points": pts[valid],
        "icp_colors": rgb[ys, xs].astype(np.uint8),
        "render_bbox": np.array([mx.min(), my.min(), mx.max(), my.max()]),
    }


def centroid_shift_mm(R, t_mm, cloud_m) -> np.ndarray:
    """How far the pose (R, t_mm) moves the centroid of a cloud (meters)."""
    c = np.asarray(cloud_m, np.float64).mean(0) * 1000.0
    return R @ c + t_mm - c


def planted_shift_mm(shift_px, depth, mask) -> np.ndarray:
    """The translation (mm) that moves the training view's object points to
    the planted scene's: a pixel shift (dx, dy) at depth z is (dx z / fx,
    dy z / fy, 0), averaged over the object's pixels."""
    z = depth[mask > 0].astype(np.float64).mean()
    k = synthetic.BENCH_K
    return np.array([shift_px[0] * z / k[0, 0], shift_px[1] * z / k[1, 1], 0.0])


def main() -> int:
    cfg = DetectorConfig(t_at_level=(5, 8))
    det = Detector(cfg)

    # Record the level-0 bbox corner that crop_template_levels subtracts.
    seen = []
    crop = JT.crop_template_levels

    def recording_crop(levels):
        seen.append(levels)
        return crop(levels)

    JT.crop_template_levels = recording_crop
    try:
        for shape in range(3):
            rgb, depth, mask = synthetic.training_view(shape, at=TRAIN_AT)
            tid = det.add_template(CLASS_ID, rgb, depth, mask, view_info(rgb, depth, mask))
            if tid != shape:
                print(f"template {shape} failed to extract", file=sys.stderr)
                return 1
    finally:
        JT.crop_template_levels = crop
    pts = [(f[:, 0] << l, f[:, 1] << l) for l, mods in enumerate(seen[0]) for f in mods]
    min_x = int(min(x.min() for x, _ in pts))
    min_y = int(min(y.min() for _, y in pts))
    min_x -= min_x % 2
    min_y -= min_y % 2
    ox, oy = min_x - TRAIN_AT[0], min_y - TRAIN_AT[1]

    # Put the template origin on the level-0 stride grid (t=5) and the
    # coarse grid of level 1 (2 * 8 pixels at level 0).
    px = NOMINAL_AT[0] - (NOMINAL_AT[0] + ox) % 80
    py = NOMINAL_AT[1] - (NOMINAL_AT[1] + oy) % 80
    expected = (px + ox + _offset(5), py + oy + _offset(5))
    scene_rgb, scene_depth = synthetic.planted_scene(px, py, seed=SCENE_SEED)
    tid, x, y, score, keep = (np.asarray(a) for a in det.match_arrays(scene_rgb, scene_depth, THRESHOLD, CLASS_ID))
    live = np.flatnonzero(keep & (score >= 0))
    print(f"planted at {(px, py)}, expected top match {expected}; {len(live)} kept, "
          f"top: {[(int(tid[i]), int(x[i]), int(y[i]), float(score[i])) for i in live[:3]]}")
    if not len(live) or (int(tid[live[0]]), int(x[live[0]]), int(y[live[0]])) != (0, *expected):
        print("the JAX detector misses the planted object; fixture not written", file=sys.stderr)
        return 1

    # The fused pipeline on the same scene, verified with template 0's own
    # points and colours.
    info0 = det.bank.infos[CLASS_ID][0]
    vpts = (info0["icp_points"] * 1000.0).astype(np.float32)
    vcols = info0["icp_colors"].astype(np.float32)
    pipe = FusedPipeline(det, CLASS_ID, synthetic.BENCH_K, icp=IcpConfig(max_iters=ICP_ITERS),
                         verify_pts=vpts, verify_colors=vcols, **REFINE)
    fused = [np.asarray(a) for a in pipe(scene_rgb, scene_depth, REFINE_THRESHOLD)]
    active = fused[8]
    train_rgb, train_depth, train_mask = synthetic.training_view(0, at=TRAIN_AT)
    shift = planted_shift_mm((px - TRAIN_AT[0], py - TRAIN_AT[1]), train_depth, train_mask)
    top = int(np.flatnonzero(active)[0]) if active.any() else -1
    moved = centroid_shift_mm(fused[4][top], fused[5][top], info0["icp_points"])
    print(f"fused: {int(active.sum())} active, tid {fused[0][active].tolist()}, fitness "
          f"{np.round(fused[6][active], 3).tolist()}, verify {np.round(fused[7][active], 3).tolist()}; "
          f"top pose moves template 0's centroid by {np.round(moved, 2).tolist()} mm, "
          f"planted shift {np.round(shift, 2).tolist()} mm")
    if top < 0 or fused[0][top] != 0 or np.linalg.norm(moved - shift) > TRANSLATION_TOL_MM:
        print("the JAX fused pipeline misses the planted pose; fixture not written", file=sys.stderr)
        return 1

    os.makedirs(OUT_DIR, exist_ok=True)
    det.write_classes(os.path.join(OUT_DIR, "planted_bank.npz"))
    np.savez(
        os.path.join(OUT_DIR, "planted_refine_golden.npz"),
        threshold=np.float32(REFINE_THRESHOLD),
        K=synthetic.BENCH_K,
        icp_max_iters=np.int32(ICP_ITERS),
        max_refine=np.int32(REFINE["max_refine"]),
        num_points=np.int32(REFINE["num_points"]),
        icp_seeds=np.int32(REFINE["icp_seeds"]),
        seed_flip=np.bool_(REFINE["seed_flip"]),
        verify_pts=vpts,
        verify_colors=vcols,
        planted_shift_mm=shift.astype(np.float32),
        translation_tol_mm=np.float32(TRANSLATION_TOL_MM),
        **{name: a for name, a in zip(("tid", "x", "y", "score", "R", "t_mm", "fitness", "verify", "active"), fused)},
    )
    np.savez(
        os.path.join(OUT_DIR, "planted_golden.npz"),
        scene_xy=np.array([px, py], np.int32),
        scene_seed=np.int32(SCENE_SEED),
        expected_xy=np.array(expected, np.int32),
        threshold=np.float32(THRESHOLD),
        t_at_level=np.array(cfg.t_at_level, np.int32),
        tid=tid.astype(np.int32),
        x=x.astype(np.int32),
        y=y.astype(np.int32),
        score=score.astype(np.float32),
        keep=keep.astype(bool),
    )
    print(f"wrote {OUT_DIR}/planted_bank.npz, planted_golden.npz and planted_refine_golden.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
