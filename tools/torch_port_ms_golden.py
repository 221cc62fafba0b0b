"""Record the JAX package's multi-scale matchers on a planted rescaled VGA
scene, as the golden the PyTorch port is held to.

The scene comes from ``sixdpose_tpu_torch.synthetic`` (numpy seeds), so the
port regenerates it without JAX.  The script:

1. trains the three-class bank of ``tools/torch_port_mc_golden.py`` (disc,
   ellipse, rounded square; one template each, trained with the object's
   base at 850 mm) with the JAX ``Detector`` at ``t_at_level=(5, 8)``, and
   checks that it equals the committed ``planted_mc_bank.npz``, which the
   port loads;
2. pastes the disc resized (nearest neighbour) to the scale of the 1050 mm
   depth bin, 850 / 1050, with its base at 1050 mm into the cluttered VGA
   scene (``synthetic.planted_scene_scaled``; its top rows are a plane at
   750 mm, a second proposal);
3. matches with the JAX ``MultiScaleDetector`` (the disc class) and
   ``MultiScaleMultiClass`` (all three classes) at threshold 60, 5
   proposals, and checks that the disc's top kept match is its template at
   the planted depth bin and scale, within one level-0 stride (5 px) of
   the planted template origin;
4. writes ``sixdpose_tpu_torch/testdata/planted_ms_golden.npz``: the
   scene, the settings, the expected position, and both outputs.

Run from the repository root on the CPU (about a minute):

    JAX_PLATFORMS=cpu python tools/torch_port_ms_golden.py
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
from sixdpose_tpu.config import DetectorConfig  # noqa: E402
from sixdpose_tpu.models.detector import Detector, _offset  # noqa: E402
from sixdpose_tpu.models.multiscale import MultiScaleDetector, MultiScaleMultiClass, _multiscale_detect  # noqa: E402
from sixdpose_tpu_torch import synthetic  # noqa: E402

CLASSES = ("disc", "ellipse", "square")  # shapes 0, 1 and 2 of synthetic.planted_object
TRAIN_DEPTH = 850.0  # the training views' object base (synthetic.training_view)
SCENE_DEPTH = 1050  # a bin centre of the default histogram
NOMINAL_AT = (300, 250)
THRESHOLD = 60.0
NUM_SCALES = 5
OUTPUTS = ("tid", "x", "y", "score", "keep", "depth_mm", "scale")


def main() -> int:
    cfg = DetectorConfig(t_at_level=(5, 8))
    det = Detector(cfg)
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
    committed = Detector.read_classes(os.path.join(G.OUT_DIR, "planted_mc_bank.npz"), cfg)
    for cid in CLASSES:
        for a, b in zip(det.bank.templates[cid][0], committed.bank.templates[cid][0]):
            if not (np.array_equal(a.features, b.features) and (a.width, a.height) == (b.width, b.height)):
                print(f"class {cid} differs from planted_mc_bank.npz; run torch_port_mc_golden.py", file=sys.stderr)
                return 1

    # The disc template's origin relative to the object's top-left corner.
    pts = [(f[:, 0] << l, f[:, 1] << l) for l, mods in enumerate(seen[0]) for f in mods]
    min_x = int(min(x.min() for x, _ in pts))
    min_y = int(min(y.min() for _, y in pts))
    ox, oy = min_x - min_x % 2 - G.TRAIN_AT[0], min_y - min_y % 2 - G.TRAIN_AT[1]
    scale = float(np.float32(TRAIN_DEPTH / SCENE_DEPTH))
    px, py = NOMINAL_AT
    expected = (px + int(round(ox * scale)) + _offset(5), py + int(round(oy * scale)) + _offset(5))
    rgb, depth = synthetic.planted_scene_scaled(px, py, scale, SCENE_DEPTH, seed=G.SCENE_SEED)

    # MultiScaleDetector.match's arrays, before its readback and filtering.
    ms = MultiScaleDetector(det, TRAIN_DEPTH, num_scales=NUM_SCALES)
    feats, valids, whs, bs, kdims, w_bins, nf_bins = ms._feature_arrays("disc")
    single = [np.asarray(a) for a in _multiscale_detect(
        rgb, depth, feats, valids, whs, bs, cfg, THRESHOLD, NUM_SCALES, kdims, w_bins=w_bins, nf_bins=nf_bins)]
    mc = MultiScaleMultiClass(det, TRAIN_DEPTH, num_scales=NUM_SCALES)
    multi = [np.asarray(a) for a in mc.match_arrays(rgb, depth, THRESHOLD)]

    ok = True
    for name, out in (("MultiScaleDetector", single), ("MultiScaleMultiClass", [a[0] for a in multi])):
        tid, x, y, score, keep, dmm, sc = out
        live = np.flatnonzero(keep & (score >= 0))
        top = [(int(tid[i]), int(x[i]), int(y[i]), float(score[i]), float(dmm[i]), float(sc[i])) for i in live[:3]]
        print(f"{name}: disc planted at {(px, py)} x {scale:.4f}, expected near {expected}; {len(live)} kept, top {top}")
        if not len(live):
            ok = False
            continue
        t = top[0]
        ok &= t[0] == 0 and t[4] == SCENE_DEPTH and t[5] == scale
        ok &= abs(t[1] - expected[0]) <= 5 and abs(t[2] - expected[1]) <= 5
    if not ok:
        print("the JAX multi-scale matchers miss the planted object; fixture not written", file=sys.stderr)
        return 1

    np.savez(
        os.path.join(G.OUT_DIR, "planted_ms_golden.npz"),
        class_ids=np.array(CLASSES),
        t_at_level=np.array(cfg.t_at_level, np.int32),
        train_depth=np.float32(TRAIN_DEPTH),
        scene_xy=np.array((px, py), np.int32),
        scene_depth=np.int32(SCENE_DEPTH),
        scene_seed=np.int32(G.SCENE_SEED),
        planted_scale=np.float32(scale),
        expected_xy=np.array(expected, np.int32),
        tolerance_px=np.int32(5),
        threshold=np.float32(THRESHOLD),
        num_scales=np.int32(NUM_SCALES),
        **{f"single_{k}": a for k, a in zip(OUTPUTS, single)},
        **{f"multi_{k}": a for k, a in zip(OUTPUTS, multi)},
    )
    print(f"wrote {G.OUT_DIR}/planted_ms_golden.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
