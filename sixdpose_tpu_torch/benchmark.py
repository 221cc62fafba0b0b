"""Synthetic end-to-end accuracy benchmark.

Port of the JAX package's ``benchmark.py``.  Real SIXD datasets are not
downloadable in every environment, so this module generates a controlled
stand-in: distinct parametric meshes, render-trained banks, and cluttered
multi-object scenes (z-buffer composited, so objects occlude each other),
then runs the full detect -> refine -> evaluate pipeline through
``PoseEstimationService`` and reports ADI recall at the SIXD 0.1-diameter
threshold, VSD recall, and timing.

The meshes, the scenes and the bank cache are the JAX package's: a bank
cached by either package (the npz and its ``.meta.json`` knobs) loads in the
other.  Everything runs on ``device``: CUDA by default, raising when there
is none; ``device="cpu"`` for the CPU.

    python -m sixdpose_tpu_torch.benchmark --scenes 20 --top-k 128 \\
        --max-hyps 96 --bank-cache <path>.npz --out <path>.json
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sixdpose_tpu_torch.config import (
    ColorGradientConfig,
    DepthNormalConfig,
    DetectorConfig,
    IcpConfig,
)
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.eval import pose_error
from sixdpose_tpu_torch.eval.misc import model_diameter
from sixdpose_tpu_torch.geometry.render import render
from sixdpose_tpu_torch.geometry.transform import random_rotation
from sixdpose_tpu_torch.models.detector import Detector
from sixdpose_tpu_torch.models.train import render_train_templates
from sixdpose_tpu_torch.ops.quantize import QUANTIZER_VERSION
from sixdpose_tpu_torch.serving import PoseEstimationService


def _quads_to_tris(quads):
    out = []
    for a, b, c, d in quads:
        out += [[a, b, c], [a, c, d]]
    return out


def _prism(profile_xy: np.ndarray, half_h: float) -> Tuple[np.ndarray, np.ndarray]:
    """Extrude a CCW 2-D polygon along z into a closed prism.

    Returns (pts (2n+2, 3), faces): top/bottom rings plus center fan
    vertices (same construction as the hex prism below).
    """
    n = len(profile_xy)
    top = np.concatenate([profile_xy, np.full((n, 1), half_h)], 1)
    bot = top.copy()
    bot[:, 2] = -half_h
    pts = np.concatenate([top, bot, [[0, 0, half_h], [0, 0, -half_h]]])
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [
            [i, j, n + i], [j, n + j, n + i],        # side
            [2 * n, j, i], [2 * n + 1, n + i, n + j]  # caps
        ]
    return pts, np.array(faces)


def _lathe(profile_rz: np.ndarray, segs: int = 20) -> Tuple[np.ndarray, np.ndarray]:
    """Revolve an (r, z) profile polyline around the z axis.

    Profile points with r=0 become single axis vertices; consecutive
    profile rows are stitched with quads (fans where one end is an axis
    point).  Returns (pts, faces).
    """
    th = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    ring_start = []
    pts = []
    for r, z in profile_rz:
        if r < 1e-9:
            ring_start.append((len(pts), True))
            pts.append([0.0, 0.0, z])
        else:
            ring_start.append((len(pts), False))
            for a in th:
                pts.append([r * np.cos(a), r * np.sin(a), z])
    faces = []
    for k in range(len(profile_rz) - 1):
        s0, ax0 = ring_start[k]
        s1, ax1 = ring_start[k + 1]
        for i in range(segs):
            j = (i + 1) % segs
            if ax0 and not ax1:
                faces.append([s0, s1 + i, s1 + j])
            elif ax1 and not ax0:
                faces.append([s1, s0 + j, s0 + i])
            elif not ax0 and not ax1:
                faces += [[s0 + i, s1 + i, s1 + j], [s0 + i, s1 + j, s0 + j]]
    return np.array(pts, np.float64), np.array(faces)


def make_models() -> Dict[str, dict]:
    """Nine diverse meshes (mm) spanning the failure modes that matter
    for template matching + depth-only ICP: an unequal box, a concave
    L-bracket, a near-symmetric hexagonal prism, a concave cup (interior
    cavity), a T-bar, an asymmetric wedge, a 5-point star prism, a
    near-symmetric cylinder, and a TEXTURE-mapped box (exercises the
    textured render path end to end).  A numpy copy of the JAX package's:
    the arrays are equal."""
    models = {}

    half = np.array([30.0, 20.0, 12.0])
    pts = np.array(
        [[sx * half[0], sy * half[1], sz * half[2]]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )
    quads = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]
    colors = np.stack(
        [100 + 155 * (pts[:, 0] > 0), 100 + 155 * (pts[:, 1] > 0),
         100 + 155 * (pts[:, 2] > 0)], 1,
    ).astype(np.uint8)
    models["box"] = {
        "pts": pts, "faces": np.array(_quads_to_tris(quads)), "colors": colors
    }

    # L-bracket: two slabs.
    def slab(x0, x1, y0, y1, z0, z1):
        return np.array(
            [[x, y, z] for x in (x0, x1) for y in (y0, y1) for z in (z0, z1)]
        )
    p1 = slab(-30, 30, -25, -5, -10, 10)
    p2 = slab(-30, -10, -5, 35, -10, 10)
    pts = np.concatenate([p1, p2])
    faces = np.array(_quads_to_tris(quads) + (np.array(_quads_to_tris(quads)) + 8).tolist())
    colors = np.stack(
        [np.full(len(pts), 220), 80 + 120 * (pts[:, 1] > 0),
         np.full(len(pts), 60)], 1,
    ).astype(np.uint8)
    models["lbracket"] = {"pts": pts, "faces": faces, "colors": colors}

    # Hexagonal prism.
    th = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    top = np.stack([25 * np.cos(th), 25 * np.sin(th), np.full(6, 15.0)], 1)
    bot = top.copy(); bot[:, 2] = -15
    pts = np.concatenate([top, bot, [[0, 0, 15], [0, 0, -15]]])
    faces = []
    for i in range(6):
        j = (i + 1) % 6
        faces += [[i, j, 6 + i], [j, 6 + j, 6 + i], [12, j, i], [13, 6 + i, 6 + j]]
    colors = np.stack(
        [120 + 100 * np.cos(np.arctan2(pts[:, 1], pts[:, 0] + 1e-9)),
         np.full(len(pts), 90),
         120 + 100 * np.sin(np.arctan2(pts[:, 1], pts[:, 0] + 1e-9))], 1,
    ).clip(0, 255).astype(np.uint8)
    models["hex"] = {"pts": pts, "faces": np.array(faces), "colors": colors}

    def angle_colors(pts, base=(120, 90, 120), amp=100):
        a = np.arctan2(pts[:, 1], pts[:, 0] + 1e-9)
        return np.stack(
            [base[0] + amp * np.cos(a),
             base[1] + 60 * (pts[:, 2] > 0),
             base[2] + amp * np.sin(a)], 1,
        ).clip(0, 255).astype(np.uint8)

    # Cup: concave solid of revolution — outer wall r=26, interior cavity
    # r=20 down to 6 mm above the base (ICP sees both walls + rim).
    profile = np.array([
        [0.0, -20.0], [26.0, -20.0], [26.0, 20.0],
        [20.0, 20.0], [20.0, -14.0], [0.0, -14.0],
    ])
    pts, faces = _lathe(profile, segs=20)
    colors = angle_colors(pts, base=(180, 80, 60), amp=60)
    models["cup"] = {"pts": pts, "faces": faces, "colors": colors}

    # T-bar: concave T-profile extrusion.
    tprof = np.array([
        [-30, 25], [30, 25], [30, 10], [8, 10],
        [8, -30], [-8, -30], [-8, 10], [-30, 10],
    ], np.float64)[::-1]  # CCW
    pts, faces = _prism(tprof, 10.0)
    colors = np.stack(
        [np.full(len(pts), 70), 120 + 100 * (pts[:, 1] > 10),
         150 + 80 * (pts[:, 0] > 0)], 1,
    ).clip(0, 255).astype(np.uint8)
    models["tbar"] = {"pts": pts, "faces": faces, "colors": colors}

    # Wedge: asymmetric right-angled ramp (no symmetries at all).
    wprof = np.array([[-30, -18], [30, -18], [30, 2], [-30, 22]], np.float64)
    pts, faces = _prism(wprof, 12.0)
    colors = np.stack(
        [200 - 3 * (pts[:, 1] + 18), np.full(len(pts), 140),
         60 + 3 * (pts[:, 1] + 18)], 1,
    ).clip(0, 255).astype(np.uint8)
    models["wedge"] = {"pts": pts, "faces": faces, "colors": colors}

    # Star prism: 5-point star (spiky silhouette, strong gradients).
    a = np.linspace(0, 2 * np.pi, 10, endpoint=False) - np.pi / 2
    r = np.where(np.arange(10) % 2 == 0, 32.0, 14.0)
    sprof = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    pts, faces = _prism(sprof, 9.0)
    models["star"] = {"pts": pts, "faces": faces,
                      "colors": angle_colors(pts, base=(90, 150, 90))}

    # Near-symmetric cylinder: 24-gon, color breaks the symmetry the
    # geometry can't (tests the color-verification path).
    a = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    cprof = np.stack([24 * np.cos(a), 24 * np.sin(a)], 1)
    pts, faces = _prism(cprof, 22.0)
    models["cyl"] = {"pts": pts, "faces": faces,
                     "colors": angle_colors(pts, base=(60, 60, 160), amp=90)}

    # Textured box: planar-UV checker+gradient texture exercises the
    # texture-mapped render path (reference renderer.py:316-321) through
    # training, scene composition, and verification.
    half = np.array([32.0, 22.0, 10.0])
    pts = np.array(
        [[sx * half[0], sy * half[1], sz * half[2]]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )
    quads = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]
    uv = np.stack(
        [(pts[:, 0] + half[0]) / (2 * half[0]),
         (pts[:, 1] + half[1]) / (2 * half[1])], 1,
    )
    ty, tx = np.mgrid[0:64, 0:64]
    checker = ((tx // 8 + ty // 8) % 2).astype(np.float32)
    tex = np.stack(
        [60 + 180 * checker, 40 + 3 * tx.astype(np.float32),
         220 - 180 * checker], -1,
    ).clip(0, 255).astype(np.uint8)
    models["texbox"] = {
        "pts": pts, "faces": np.array(_quads_to_tris(quads)),
        "texture_uv": uv, "texture": tex,
        # fallback colors for paths that ignore textures
        "colors": np.full((len(pts), 3), 150, np.uint8),
    }
    return models


def make_scene(
    models: Dict[str, dict],
    K: np.ndarray,
    im_size: Tuple[int, int],
    rng: np.random.Generator,
    depth_range=(380.0, 520.0),
    spread_mm: float = 90.0,
    max_objects: Optional[int] = None,
    device=None,
):
    """Compose a cluttered scene: objects at random poses, merged by
    nearest depth (mutual occlusion).  Returns (rgb, depth, gt list) as
    numpy, drawn from ``rng`` in the JAX package's order.

    ``max_objects``: sample that many classes per scene from the pool
    (None = all); 3-5 per scene matches hinterstoisser-style clutter while
    per-object recall still covers every mesh over enough scenes."""
    device = resolve_device(device)
    w, h = im_size
    rgb = np.zeros((h, w, 3), np.uint8)
    depth = np.zeros((h, w), np.float32)
    gts = []
    cids = list(models.keys())
    if max_objects is not None and max_objects < len(cids):
        cids = list(rng.choice(cids, size=max_objects, replace=False))
    for cid in cids:
        model = models[cid]
        R = random_rotation(rng)
        t = np.array(
            [rng.uniform(-spread_mm, spread_mm),
             rng.uniform(-spread_mm * 0.7, spread_mm * 0.7),
             rng.uniform(*depth_range)]
        )
        r_i, d_i = render(model, im_size, K, R, t, mode="rgb+depth", texture=model.get("texture"), device=device)
        r_i = r_i.cpu().numpy()
        d_i = d_i.cpu().numpy()
        closer = (d_i > 0) & ((depth == 0) | (d_i < depth))
        depth[closer] = d_i[closer]
        rgb[closer] = r_i[closer]
        gts.append({"obj_id": cid, "R": R, "t": t.reshape(3, 1)})
    return rgb, depth.astype(np.uint16), gts


def _norm_cfg(cfg_repr: str) -> str:
    """Drop inference-only fields from the cache key: top_k and nms_iou
    never affect what training writes into the bank, and a candidate-budget
    sweep must not cost a retrain."""
    import re

    cfg_repr = re.sub(r"top_k=\d+", "top_k=*", cfg_repr)
    return re.sub(r"nms_iou=[\d.]+", "nms_iou=*", cfg_repr)


def train_benchmark_bank(
    models: Dict[str, dict],
    K: np.ndarray,
    im_size: Tuple[int, int],
    min_n_views: int,
    cfg: DetectorConfig,
    bank_cache: Optional[str] = None,
    verbose: bool = True,
    device=None,
) -> Tuple[Detector, float]:
    """One shared detector bank for all benchmark classes, loaded from
    ``bank_cache`` when present and its ``.meta.json`` knobs match (training
    dominates benchmark wall time; the bank is deterministic given the
    knobs).  The knobs are the JAX package's, so either package's cache
    serves the other.  Returns (detector on ``device``, training seconds, 0
    on a cache hit)."""
    device = resolve_device(device)
    knobs = {
        "classes": sorted(models.keys()),
        "min_n_views": min_n_views,
        "im_size": list(im_size),
        "cfg": repr(cfg),
        "quantizer": QUANTIZER_VERSION,
    }

    def _match(cached: dict) -> bool:
        a, b = dict(cached), dict(knobs)
        a["cfg"] = _norm_cfg(a.get("cfg", ""))
        b["cfg"] = _norm_cfg(b["cfg"])
        return a == b

    if bank_cache and os.path.exists(bank_cache) and os.path.exists(bank_cache + ".meta.json"):
        with open(bank_cache + ".meta.json") as f:
            cached = json.load(f)
        if _match(cached):
            det = Detector.read_classes(bank_cache, cfg, device=device)
            if verbose:
                print(f"bank cache hit: {bank_cache} ({det.num_templates()} templates)")
            return det, 0.0
        if verbose:
            print("bank cache stale (knobs changed); retraining")

    det = Detector(cfg, device=device)
    t0 = time.time()
    for cid, model in models.items():
        stats = render_train_templates(
            det, cid, model, K,
            radii=[450.0], min_n_views=min_n_views, im_size=im_size,
            elev_range=(-0.5 * np.pi, 0.5 * np.pi),   # full sphere: scene
            tilt_range=(-0.5 * np.pi, 0.5 * np.pi),   # poses are unrestricted
            tilt_step=0.2 * np.pi,
            device=device,
        )
        if verbose:
            print(f"trained {cid}: {stats} ({det.num_templates(cid)} templates)")
    train_time = time.time() - t0
    if bank_cache:
        # Atomic publish: both files to temp paths, then os.replace(), the
        # sidecar last, so an interrupt never leaves a truncated bank next
        # to a matching sidecar.  np.savez appends ".npz" unless the path
        # ends with it, so the cache path is normalized first.
        if not bank_cache.endswith(".npz"):
            bank_cache = bank_cache + ".npz"
        root, ext = os.path.splitext(bank_cache)
        tmp_bank = root + ".tmp" + ext
        tmp_meta = bank_cache + ".meta.json.tmp"
        det.write_classes(tmp_bank)
        with open(tmp_meta, "w") as f:
            json.dump(knobs, f)
        os.replace(tmp_bank, bank_cache)
        os.replace(tmp_meta, bank_cache + ".meta.json")
    return det, train_time


def benchmark_config(top_k: int = 32) -> DetectorConfig:
    """The benchmark's detector configuration (the JAX package's
    ``run_benchmark``)."""
    return DetectorConfig(
        t_at_level=(4, 8),
        top_k=top_k,
        color=ColorGradientConfig(num_features=40, strong_threshold=30.0),
        depth=DepthNormalConfig(num_features=24, extract_threshold=1, focal=280.0),
    )


def benchmark_K(im_size: Tuple[int, int]) -> np.ndarray:
    """The benchmark camera: f = 280 px, principal point at the centre."""
    return np.array([[280.0, 0, im_size[0] / 2], [0, 280.0, im_size[1] / 2], [0, 0, 1]])


def run_benchmark(
    num_scenes: int = 20,
    min_n_views: int = 80,
    im_size: Tuple[int, int] = (320, 240),
    threshold: float = 55.0,
    seed: int = 0,
    verbose: bool = True,
    max_objects_per_scene: Optional[int] = 4,
    prefer_fused: bool = True,
    object_ids: Optional[List[str]] = None,
    bank_cache: Optional[str] = None,
    max_hyps: int = 12,
    rank_key: str = "verify",
    scene_hook=None,
    icp_seeds: int = 4,
    verify_tau: float = 6.0,
    seed_flip: bool = True,
    top_k: int = 32,
    verify_color_weight: float = 0.5,
    verify_color_zscore: bool = False,
    icp: Optional[IcpConfig] = None,
    device=None,
) -> dict:
    """Train banks for all models, evaluate recall over cluttered scenes.

    Correctness = ADI < 0.1 * diameter (SIXD ADD/ADI protocol; ADI since
    the synthetic shapes have geometric symmetries depth-only ICP cannot
    disambiguate), and the SIXD-2017 VSD protocol (delta 15, tau 20, step
    cost, e < 0.3) beside it.

    All classes share ONE detector bank and every scene is one fused
    multi-class frame that carries ``max_hyps`` hypotheses per class
    through batched ICP and verification; the published estimate per class
    is the verification-ranked winner.

    ``scene_hook``: optional callable(si, rgb, depth, gts) invoked per
    generated scene.
    """
    device = resolve_device(device)
    K = benchmark_K(im_size)
    rng = np.random.default_rng(seed)
    models = make_models()
    if object_ids is not None:
        models = {cid: models[cid] for cid in object_ids}
    diameters = {cid: model_diameter(m["pts"]) for cid, m in models.items()}

    cfg = benchmark_config(top_k)
    det, train_time = train_benchmark_bank(models, K, im_size, min_n_views, cfg, bank_cache, verbose, device)

    service = PoseEstimationService(
        det, models, K,
        threshold=threshold, max_refine=max_hyps,
        icp=icp or IcpConfig(max_iters=20), min_fitness=0.3,
        prefer_fused=prefer_fused, rank_key=rank_key,
        icp_seeds=icp_seeds, verify_tau=verify_tau, seed_flip=seed_flip,
        verify_color_weight=verify_color_weight,
        verify_color_zscore=verify_color_zscore,
        device=device,
    )

    targets = 0
    hits = 0
    hits_vsd = 0
    per_obj = {cid: [0, 0] for cid in models}
    detect_time = 0.0
    frames = 0
    last_scene = None
    for si in range(num_scenes):
        rgb, depth, gts = make_scene(models, K, im_size, rng, max_objects=max_objects_per_scene, device=device)
        if scene_hook is not None:
            scene_hook(si, rgb, depth, gts)
        # One frame per scene covers every class; per-class estimate lists
        # come out ranked by the service's rank_key.
        t0 = time.time()
        ests = service.process_frame(rgb, depth)
        detect_time += time.time() - t0
        frames += 1
        last_scene = (rgb, depth)
        by_class: Dict[str, List] = {}
        for e in ests:
            by_class.setdefault(e.class_id, []).append(e)
        for gt in gts:
            cid = gt["obj_id"]
            # target only if sufficiently visible (analog of visib>=0.1)
            d_solo = render(models[cid], im_size, K, gt["R"], gt["t"], mode="depth", device=device).cpu().numpy()
            vis_frac = (
                ((np.abs(depth.astype(np.float32) - d_solo) < 5) & (d_solo > 0)).sum()
                / max((d_solo > 0).sum(), 1)
            )
            if vis_frac < 0.3:
                continue
            targets += 1
            per_obj[cid][1] += 1
            ok = False
            ok_vsd = False
            for e in by_class.get(cid, [])[:1]:
                err = pose_error.adi(e.R, e.t, gt["R"], gt["t"], models[cid], max_pts=1024, device=device)
                if err < 0.1 * diameters[cid]:
                    ok = True
                e_vsd = pose_error.vsd(
                    e.R, e.t, gt["R"], gt["t"], models[cid], depth, K,
                    delta=15.0, tau=20.0, cost_type="step", device=device,
                )
                if e_vsd < 0.3:
                    ok_vsd = True
            if ok:
                hits += 1
                per_obj[cid][0] += 1
            if ok_vsd:
                hits_vsd += 1
        if verbose and (si + 1) % 5 == 0:
            print(f"scene {si+1}/{num_scenes}: recall so far {hits}/{targets}")

    result = {
        "recall": hits / max(targets, 1),
        "recall_vsd": hits_vsd / max(targets, 1),
        "targets": targets,
        "hits": hits,
        "hits_vsd": hits_vsd,
        "per_object": {cid: (v[0] / max(v[1], 1)) for cid, v in per_obj.items()},
        "train_time_s": train_time,
        "detect_refine_s_per_frame": detect_time / max(frames, 1),
        "detect_refine_s_per_target": detect_time / max(targets, 1),
    }
    # Device time of the fused frame at this configuration, beside the host
    # wall time above.
    if prefer_fused and last_scene is not None:
        dev_ms = fused_device_ms_per_frame(service, *last_scene)
        if dev_ms is not None:
            result["device_ms_per_frame"] = dev_ms
    if verbose:
        print(result)
    return result


def fused_device_ms_per_frame(service, rgb, depth, frames: int = 10) -> Optional[float]:
    """Median milliseconds per fused multi-class frame at the service's
    configuration, between CUDA events around each of ``frames`` frames
    (after one warm-up) on images already on the card.  None on the CPU, or
    when the fused pipeline is unavailable."""
    if service.device.type != "cuda":
        return None
    pipe = service._fused_multiclass([c for c in service.det.class_ids() if c in service.models])
    if pipe is None:
        return None
    rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(service.device)
    dep_t = torch.from_numpy(np.asarray(depth).astype(np.int32)).to(service.device)
    pipe(rgb_t, dep_t, service.threshold)
    torch.cuda.synchronize(service.device)
    times = []
    for _ in range(frames):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipe(rgb_t, dep_t, service.threshold)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def provenance(config: dict) -> dict:
    """Stamp: git revision and dirty flag of this checkout, UTC time, argv,
    the device and the flags."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def git(*args) -> str:
        try:
            return subprocess.run(["git", *args], cwd=root, capture_output=True, text=True, timeout=10).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            return ""

    dev = config.get("device") or "cuda"
    return {
        "git": {"rev": git("rev-parse", "HEAD"), "dirty": bool(git("status", "--porcelain"))},
        "generated_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
        "argv": sys.argv,
        "device": torch.cuda.get_device_name(0) if dev.startswith("cuda") and torch.cuda.is_available() else dev,
        "config": config,
    }


def main(argv: Optional[List[str]] = None) -> int:
    """The CLI of the JAX package's ``tools/benchmark_synthetic.py``: the
    same flags and JSON, on the card unless ``--device cpu``."""
    ap = argparse.ArgumentParser(description="Synthetic multi-object accuracy benchmark of the PyTorch port.")
    ap.add_argument("--scenes", type=int, default=20)
    ap.add_argument("--views", type=int, default=80)
    ap.add_argument("--threshold", type=float, default=55.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--objects-per-scene", type=int, default=4,
                    help="classes sampled per scene (0 = all 9 at once)")
    ap.add_argument("--objects", nargs="*", default=None, help="restrict the model pool (default: all 9)")
    ap.add_argument("--host-path", action="store_true", help="force the host-orchestrated serving path (A/B)")
    ap.add_argument("--bank-cache", default=None, help="npz path: reuse the trained bank across runs")
    ap.add_argument("--max-hyps", type=int, default=12, help="hypotheses per class kept through ICP + verify")
    ap.add_argument("--icp-seeds", type=int, default=4,
                    help="in-plane ICP seed fan per hypothesis (with the flip the last slot is the 180-deg seed)")
    ap.add_argument("--no-seed-flip", action="store_true", help="disable the 180-deg in-plane flip seed")
    ap.add_argument("--verify-tau", type=float, default=6.0, help="verification depth-agreement tolerance (mm)")
    ap.add_argument("--top-k", type=int, default=32,
                    help="match candidate budget per class (inference-only; does not invalidate the bank cache)")
    ap.add_argument("--rank-key", default="verify", choices=["verify", "fitness", "similarity"])
    ap.add_argument("--color-zscore", action="store_true",
                    help="per-pixel chroma informativeness weighting in verification")
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' for the CPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    result = run_benchmark(
        num_scenes=args.scenes,
        min_n_views=args.views,
        threshold=args.threshold,
        seed=args.seed,
        max_objects_per_scene=args.objects_per_scene or None,
        prefer_fused=not args.host_path,
        object_ids=args.objects,
        bank_cache=args.bank_cache,
        max_hyps=args.max_hyps,
        rank_key=args.rank_key,
        seed_flip=not args.no_seed_flip,
        icp_seeds=args.icp_seeds,
        verify_tau=args.verify_tau,
        top_k=args.top_k,
        verify_color_zscore=args.color_zscore,
        device=args.device,
    )
    config = {k: v for k, v in vars(args).items() if k != "out"}
    result = dict(result, provenance=provenance(config))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
