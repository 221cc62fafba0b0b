"""Record the JAX package's detections on the synthetic planted-object scene,
as the golden the PyTorch port is held to on the GPU.

The scene and the training views come from ``sixdpose_tpu_torch.synthetic``
(numpy seeds), so the port regenerates them without JAX.  The script:

1. trains a bank of three templates (disc, ellipse, rounded square) with the
   JAX ``Detector.add_template`` at ``t_at_level=(5, 8)``;
2. places object 0 in a cluttered VGA scene so that its template origin
   lies on the level-0 stride grid;
3. matches with the JAX detector at threshold 75 and checks that the top
   match is template 0 at the planted position;
4. writes ``sixdpose_tpu_torch/testdata/planted_bank.npz`` (the JAX
   ``TemplateBank.save``) and ``planted_golden.npz`` (the scene position and
   the JAX ``tid, x, y, score, keep``).

Run from the repository root on the CPU:

    JAX_PLATFORMS=cpu python tools/torch_port_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sixdpose_tpu.models.templates as JT  # noqa: E402
from sixdpose_tpu.config import DetectorConfig  # noqa: E402
from sixdpose_tpu.models.detector import Detector, _offset  # noqa: E402
from sixdpose_tpu_torch import synthetic  # noqa: E402

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")
CLASS_ID = "planted"
THRESHOLD = 75.0
TRAIN_AT = (264, 184)
NOMINAL_AT = (341, 157)
SCENE_SEED = 11


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
            tid = det.add_template(CLASS_ID, rgb, depth, mask)
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

    os.makedirs(OUT_DIR, exist_ok=True)
    det.write_classes(os.path.join(OUT_DIR, "planted_bank.npz"))
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
    print(f"wrote {OUT_DIR}/planted_bank.npz and planted_golden.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
