"""Record the JAX package's tiled and template-sharded multi-scale
detection on small scenes, as the golden the PyTorch port's ``parallel``
package is held to.

The script, on 8 virtual CPU devices:

1. trains the four-object bank of ``tests/test_sharding.py`` (96 x 128, one
   two-colour disc per template, ``t_at_level=(4, 8)``, 16 colour
   features, top_k 16) and its four scenes with the JAX ``Detector``;
2. runs ``tiled_detect`` at tile 4 on scenes 0 and 2 on the
   feature-sparse path (``feats``/``valids`` given), threshold 60;
3. trains the four-object bank of the multi-scale test there (24 colour
   features) and its scene (object 2 resized to 24 x 24 at 1000 mm) and
   runs ``sharded_multiscale_detect`` at template 4, train depth 600 mm,
   3 proposals, threshold 55;
4. checks that each top match is where the single-device matcher puts it;
5. writes ``sixdpose_tpu_torch/testdata/parallel_bank.npz`` and
   ``parallel_ms_bank.npz`` (both banks, in the npz both packages read) and
   ``parallel_golden.npz`` (the scenes, settings and outputs).

Run from the repository root on the CPU (about a minute):

    JAX_PLATFORMS=cpu python tools/torch_port_parallel_golden.py
"""

from __future__ import annotations

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from sixdpose_tpu.config import ColorGradientConfig, DetectorConfig  # noqa: E402
from sixdpose_tpu.models.detector import Detector  # noqa: E402
from sixdpose_tpu.models.multiscale import MultiScaleDetector  # noqa: E402
from sixdpose_tpu.parallel import make_mesh, pad_templates  # noqa: E402
from sixdpose_tpu.parallel.sharded_match import sharded_multiscale_detect  # noqa: E402
from sixdpose_tpu.parallel.tiled_match import tiled_detect  # noqa: E402

OUT_DIR = os.path.join(ROOT, "sixdpose_tpu_torch", "testdata")
COLORS = [(200, 80, 40), (40, 200, 80), (80, 40, 200), (200, 200, 40)]
TILED_SCENES = (0, 2)
THRESHOLD = 60.0
MS_THRESHOLD = 55.0
MS_TRAIN_DEPTH = 600.0
MS_SCALES = 3
SHARDS = 4


def _disc(i: int):
    obj = np.zeros((40, 40, 3), np.uint8)
    yy, xx = np.mgrid[0:40, 0:40]
    m = ((yy - 20) ** 2 + (xx - 20) ** 2) < 256
    col = COLORS[i]
    obj[m] = col
    return obj, m, yy, xx


def _train(det: Detector, obj, m, i: int) -> None:
    train = np.zeros((96, 128, 3), np.uint8)
    train[28:68, 44:84] = obj
    mask = np.zeros((96, 128), np.uint8)
    mask[28:68, 44:84] = m.astype(np.uint8) * 255
    assert det.add_template("objs", train, None, mask) == i


def sharding_bank():
    """The bank and scenes of tests/test_sharding.py's ``trained``."""
    cfg = DetectorConfig(t_at_level=(4, 8), use_depth=False, top_k=16, color=ColorGradientConfig(num_features=16))
    det = Detector(cfg)
    scenes = []
    for i in range(4):
        obj, m, yy, xx = _disc(i)
        col = COLORS[i]
        obj[m & (xx > 20)] = (255 - col[0], 255 - col[1], col[2])
        _train(det, obj, m, i)
        scene = np.zeros((96, 128, 3), np.uint8)
        ox, oy = 16 + 8 * i, 40 - 6 * i
        scene[oy : oy + 40, ox : ox + 40] = obj
        scenes.append(scene)
    return det, np.stack(scenes)


def multiscale_bank():
    """The bank and scene of tests/test_sharding.py's multi-scale test."""
    cfg = DetectorConfig(t_at_level=(4, 8), use_depth=False, top_k=16, color=ColorGradientConfig(num_features=24))
    det = Detector(cfg)
    objs = []
    for i in range(4):
        obj, m, yy, xx = _disc(i)
        col = COLORS[i]
        obj[m & (yy > 20)] = (col[2], 255 - col[1], col[0])
        _train(det, obj, m, i)
        objs.append(obj)
    small = np.asarray(Image.fromarray(objs[2]).resize((24, 24), Image.BILINEAR))
    scene = np.zeros((96, 128, 3), np.uint8)
    scene[40:64, 60:84] = small
    depth = np.full((96, 128), 1000, np.uint16)
    return det, scene, depth


def main() -> int:
    det, scenes = sharding_bank()
    cfg = det.cfg
    kernels, nfeats, whs = det.device_bank("objs")
    feats, valids = det._device_feats["objs"]
    mesh = make_mesh(tile=SHARDS)
    tiled = {}
    for b in TILED_SCENES:
        out = [np.asarray(a) for a in tiled_detect(mesh, jnp.asarray(scenes[b]), None, kernels, nfeats, whs, cfg,
                                                   THRESHOLD, feats=feats, valids=valids)]
        top = det.match(scenes[b], None, threshold=THRESHOLD, apply_nms=False)[0]
        if (int(out[0][0]), int(out[1][0]), int(out[2][0])) != (top.template_id, top.x, top.y):
            print(f"scene {b}: tiled top {out[0][0], out[1][0], out[2][0]} is not {top}", file=sys.stderr)
            return 1
        tiled[b] = out

    ms_det, ms_scene, ms_depth = multiscale_bank()
    ms = MultiScaleDetector(ms_det, train_depth=MS_TRAIN_DEPTH, num_scales=MS_SCALES)
    f, v, w, bs, kdims, _w, _nf = ms._feature_arrays("objs")
    pad = lambda arrs: tuple(jnp.asarray(a) for a in pad_templates(tuple(np.asarray(x) for x in arrs), SHARDS))
    ms_out = [np.asarray(a) for a in sharded_multiscale_detect(
        make_mesh(template=SHARDS), jnp.asarray(ms_scene), jnp.asarray(ms_depth), pad(f), pad(v), pad(w), bs, ms_det.cfg,
        MS_THRESHOLD, MS_SCALES, kdims,
    )]
    ref = ms.match(ms_scene, ms_depth, MS_THRESHOLD, "objs")[0]
    live = np.flatnonzero(ms_out[4] & (ms_out[3] >= 0))
    best = live[np.argmax(ms_out[3][live])]
    if (int(ms_out[1][best]), int(ms_out[2][best]), float(ms_out[3][best])) != (ref.x, ref.y, ref.similarity):
        print(f"sharded multi-scale top {best} is not {ref}", file=sys.stderr)
        return 1

    det.write_classes(os.path.join(OUT_DIR, "parallel_bank.npz"))
    ms_det.write_classes(os.path.join(OUT_DIR, "parallel_ms_bank.npz"))
    np.savez(
        os.path.join(OUT_DIR, "parallel_golden.npz"),
        scenes=scenes,
        threshold=np.float32(THRESHOLD),
        tiled_scenes=np.array(TILED_SCENES, np.int32),
        shards=np.int32(SHARDS),
        **{f"tiled{b}_{k}": a for b, out in tiled.items() for k, a in zip(("tid", "x", "y", "score"), out)},
        ms_scene=ms_scene,
        ms_depth=ms_depth,
        ms_threshold=np.float32(MS_THRESHOLD),
        ms_train_depth=np.float32(MS_TRAIN_DEPTH),
        ms_scales=np.int32(MS_SCALES),
        ms_kdims=np.array(kdims, np.int32),
        **{f"ms_{k}": a for k, a in zip(("tid", "x", "y", "score", "keep", "depth_mm", "scale"), ms_out)},
    )
    print(f"wrote {OUT_DIR}/parallel_bank.npz, parallel_ms_bank.npz and parallel_golden.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
