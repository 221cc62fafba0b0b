"""Record the JAX package's synthetic accuracy benchmark at a cut size, as the
golden the PyTorch port is held to.

The script runs ``sixdpose_tpu.benchmark.run_benchmark`` on the CPU at
``SETTINGS`` (three of the nine meshes, the box, the cup and the textured
box; 240 x 180; ``min_n_views`` 12, the smallest view sphere, 60 views per
class; 3 scenes) and writes, under ``sixdpose_tpu_torch/testdata/``:

- ``synth_bank.npz`` and ``synth_bank.npz.meta.json``: the trained bank, as
  the benchmark's bank cache writes it (the port's ``run_benchmark`` loads
  it through the same cache);
- ``synth_golden.npz``: the settings, the scenes as ``scene_hook`` sees them
  (rgb, depth, ground-truth poses), each scene's published estimates as
  ``PoseEstimationService.process_frame`` returned them, the result dict
  (as JSON), and JAX renders of each of the nine meshes at two poses (96 x
  72: depth, RGB and, for the textured box, the textured RGB), for the
  checks on the card, where there is no JAX.

Run from the repository root on the CPU (about a minute):

    JAX_PLATFORMS=cpu python tools/torch_port_synth_golden.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import sixdpose_tpu.benchmark as JB  # noqa: E402
from sixdpose_tpu.geometry.render import render  # noqa: E402
from sixdpose_tpu.geometry.transform import random_rotation  # noqa: E402

OUT_DIR = os.path.join(ROOT, "sixdpose_tpu_torch", "testdata")
SETTINGS = dict(
    num_scenes=3, min_n_views=12, im_size=(240, 180), threshold=55.0, seed=0, max_objects_per_scene=4,
    object_ids=["box", "cup", "texbox"], max_hyps=12, icp_seeds=4, verify_tau=6.0, seed_flip=True, top_k=32,
)
RENDER_SIZE = (96, 72)
RENDER_K = np.array([[84.0, 0, 48], [0, 84.0, 36], [0, 0, 1]])
RENDER_SEED = 7
EST_FIELDS = ("template_id", "x", "y", "similarity", "fitness", "verify")
# run_benchmark's service settings at SETTINGS; the host and multi-scale
# cases run it on one scene each.
SERVICE = dict(threshold=55.0, max_refine=12, icp_max_iters=20, min_fitness=0.3, icp_seeds=4, verify_tau=6.0,
               seed_flip=True)
HOST_SCENE, MS_SCENE, MS_TRAIN_DEPTH, MS_SCALES = 0, 1, 450.0, 3


def mesh_renders() -> dict:
    """JAX renders of every benchmark mesh at two poses drawn from
    ``RENDER_SEED``: depth, RGB (vertex colours) and, for the textured box,
    the textured RGB; flattened in ``make_models`` order."""
    rng = np.random.default_rng(RENDER_SEED)
    out = {"R": [], "t": [], "depth": [], "rgb": [], "tex_rgb": []}
    for cid, m in JB.make_models().items():
        for _ in range(2):
            R = random_rotation(rng)
            t = np.array([rng.uniform(-15, 15), rng.uniform(-10, 10), rng.uniform(380, 520)])
            rgb, depth = render(dict(m), RENDER_SIZE, RENDER_K, R, t, mode="rgb+depth")
            tex = render(dict(m), RENDER_SIZE, RENDER_K, R, t, mode="rgb", texture=m.get("texture"))
            out["R"].append(R)
            out["t"].append(t)
            out["depth"].append(np.asarray(depth))
            out["rgb"].append(np.asarray(rgb))
            out["tex_rgb"].append(np.asarray(tex))
    return {f"render_{k}": np.stack(v) for k, v in out.items()}


def estimate_arrays(prefix: str, estimates) -> dict:
    """Per scene (or case) lists of ``PoseEstimate`` as padded arrays."""
    n = max(1, max(len(e) for e in estimates))
    out = {f"{prefix}_{f}": np.zeros((len(estimates), n)) for f in EST_FIELDS}
    out[f"{prefix}_R"] = np.zeros((len(estimates), n, 3, 3))
    out[f"{prefix}_t"] = np.zeros((len(estimates), n, 3))
    cls = np.full((len(estimates), n), "", dtype=object)
    for si, ests in enumerate(estimates):
        for ei, e in enumerate(ests):
            for f in EST_FIELDS:
                out[f"{prefix}_{f}"][si, ei] = getattr(e, f)
            out[f"{prefix}_R"][si, ei], out[f"{prefix}_t"][si, ei], cls[si, ei] = e.R, e.t.ravel(), e.class_id
    out[f"{prefix}_class"] = cls.astype(str)
    out[f"{prefix}_n"] = np.array([len(e) for e in estimates], np.int32)
    return out


def service_cases(bank: str, scenes) -> dict:
    """The host-path and multi-scale runs of the benchmark's service."""
    from sixdpose_tpu.config import IcpConfig
    from sixdpose_tpu.models.detector import Detector

    models = {c: JB.make_models()[c] for c in SETTINGS["object_ids"]}
    K = np.array([[280.0, 0, SETTINGS["im_size"][0] / 2], [0, 280.0, SETTINGS["im_size"][1] / 2], [0, 0, 1]])
    cfg = JB.DetectorConfig(
        t_at_level=(4, 8), top_k=SETTINGS["top_k"],
        color=JB.ColorGradientConfig(num_features=40, strong_threshold=30.0),
        depth=JB.DepthNormalConfig(num_features=24, extract_threshold=1, focal=280.0),
    )
    kw = {k: v for k, v in SERVICE.items() if k != "icp_max_iters"}
    ests, counters = [], []
    for case in ("host", "multiscale"):
        svc = JB.PoseEstimationService(Detector.read_classes(bank, cfg), models, K,
                                       icp=IcpConfig(max_iters=SERVICE["icp_max_iters"]), **kw,
                                       prefer_fused=case != "host")
        if case == "multiscale":
            svc.enable_multiscale(train_depth=MS_TRAIN_DEPTH, num_scales=MS_SCALES)
        rgb, depth, _ = scenes[HOST_SCENE if case == "host" else MS_SCENE]
        ests.append(svc.process_frame(rgb, depth))
        counters.append(svc.metrics.snapshot()["counters"])
        print(f"{case}: {len(ests[-1])} estimates, counters {counters[-1]}")
    return dict(estimate_arrays("case", ests), case_counters=np.array(json.dumps(counters)))


def main() -> int:
    scenes, estimates = [], []

    class RecordingService(JB.PoseEstimationService):
        def process_frame(self, rgb, depth):
            ests = super().process_frame(rgb, depth)
            estimates.append(ests)
            return ests

    def hook(si, rgb, depth, gts):
        scenes.append((rgb, depth, gts))

    os.makedirs(OUT_DIR, exist_ok=True)
    bank = os.path.join(OUT_DIR, "synth_bank.npz")
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "bank.npz")
        JB.PoseEstimationService = RecordingService
        try:
            result = JB.run_benchmark(bank_cache=cache, scene_hook=hook, verbose=True, **SETTINGS)
        finally:
            JB.PoseEstimationService = RecordingService.__bases__[0]
        if result["targets"] == 0:
            print("no targets in the cut benchmark; fixture not written", file=sys.stderr)
            return 1
        os.replace(cache, bank)
        os.replace(cache + ".meta.json", bank + ".meta.json")

    n_obj = max(len(g) for _, _, g in scenes)
    gt_R = np.zeros((len(scenes), n_obj, 3, 3))
    gt_t = np.zeros((len(scenes), n_obj, 3))
    gt_obj = np.full((len(scenes), n_obj), "", dtype=object)
    for si, (_, _, gts) in enumerate(scenes):
        for gi, g in enumerate(gts):
            gt_R[si, gi], gt_t[si, gi], gt_obj[si, gi] = g["R"], g["t"].ravel(), g["obj_id"]
    np.savez_compressed(
        os.path.join(OUT_DIR, "synth_golden.npz"),
        settings=np.array(json.dumps(SETTINGS)),
        result=np.array(json.dumps(result)),
        rgb=np.stack([s[0] for s in scenes]),
        depth=np.stack([s[1] for s in scenes]),
        gt_R=gt_R, gt_t=gt_t, gt_obj=gt_obj.astype(str),
        **estimate_arrays("est", estimates),
        service=np.array(json.dumps(SERVICE)), host_scene=np.int32(HOST_SCENE), ms_scene=np.int32(MS_SCENE),
        ms_train_depth=np.float32(MS_TRAIN_DEPTH), ms_scales=np.int32(MS_SCALES),
        **service_cases(bank, scenes),
        render_K=RENDER_K, render_size=np.array(RENDER_SIZE), render_seed=np.int32(RENDER_SEED),
        **mesh_renders(),
    )
    print(f"wrote {bank} (+ .meta.json) and {OUT_DIR}/synth_golden.npz: {json.dumps(result)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
