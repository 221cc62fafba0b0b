"""Synthetic workloads, made from numpy seeds.

- ``bench_bank``: the JAX package's ``bench.py`` workload
  (``_synthetic_bank``, bench.py:76-103): one class of 89 templates with 254
  features at level 0 and 127 at level 1, and a VGA RGB-D frame, drawn from
  the same seed in the same order, so both packages see identical data.
- ``bench_refine_bank``: the refine stage bench.py adds to that workload
  for its detect+refine measurement (bench.py:229-270).
- ``training_view`` / ``planted_scene`` / ``planted_scene_multi``: a VGA
  scene with textured objects on depth domes pasted at known places, and
  the views that train their templates.  ``tools/torch_port_golden.py``
  and ``tools/torch_port_mc_golden.py`` record what the JAX package
  detects and refines in them.
- ``multiclass_workload``: the shape of the JAX package's synthetic
  benchmark (``SYNTH_r05.json``, ``benchmark.py:run_benchmark``): 9 classes
  of 810 views in one bank, a 320x240 RGB-D frame and its settings.  The
  bank is drawn, not rendered (rendering is not ported yet).
- ``multiscale_workload``: the shape of the JAX package's multi-scale sweep
  (``tools/bench_multiscale_multiclass.py``): 15 classes of 337 templates,
  a VGA RGB-D frame of noisy depth planes and its settings.  The bank is
  drawn (the case1 bank that tool clones is not in the repository).
- ``planted_scene_scaled``: the planted scene with object 0 resized to a
  given scale and set at a given depth, for the multi-scale golden
  (``tools/torch_port_ms_golden.py``).
- ``bin_picking_scene``: the segmentation path's frame: the benchmark's
  nine meshes at random poses 450-600 mm away over a tilted floor, with
  each object's visible mask and a sample of each mesh's surface (the
  registration's model clouds); ``tools/torch_port_seg_golden.py`` records
  what the JAX package's ``seg`` makes of it at 320 x 240.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from sixdpose_tpu_torch.config import ColorGradientConfig, DepthNormalConfig, DetectorConfig, IcpConfig
from sixdpose_tpu_torch.models.detector import Detector
from sixdpose_tpu_torch.models.templates import TemplateLevel

VGA = (480, 640)
OBJECT_SIZE = 112
# bench.py's camera (K_cam, bench.py:258-267), also the planted scene's.
BENCH_K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]], np.float32)


def bench_bank(num_templates: int = 89, seed: int = 0, sizes: Tuple[int, int] = (80, 40), features: int = 254,
               hw: Tuple[int, int] = VGA):
    """(class_id, templates, rgb (H, W, 3) uint8, depth (H, W) uint16) of
    bench.py's synthetic workload.  The defaults are bench.py's; ``sizes``
    (the templates' side at levels 0 and 1), ``features`` (level 0's count;
    level 1 has half) and ``hw`` cut it by the same recipe."""
    rng = np.random.default_rng(seed)
    templates: List[List[TemplateLevel]] = []
    for _ in range(num_templates):
        levels = []
        for l, size in enumerate(sizes):
            f = features // (l + 1)
            feats = np.stack(
                [rng.integers(0, size, f), rng.integers(0, size, f), rng.integers(0, 16, f)], 1
            )
            levels.append(TemplateLevel(features=feats, width=size, height=size, pyramid_level=l))
        templates.append(levels)
    rgb = rng.integers(0, 255, hw + (3,), np.uint8)
    dep = (900 + 60 * rng.standard_normal(hw)).astype(np.uint16)
    return "synthetic", templates, rgb, dep


def bench_refine_bank(whs0: np.ndarray, seed: int = 0) -> dict:
    """The refine stage of bench.py's detect+refine workload (bench.py:229-270),
    drawn from the same seed in the same order, for the templates whose
    level-0 (width, height) are ``whs0`` (N, 2).

    Returns ``fields``: the six ``RefineBank`` arrays (box-surface clouds of
    512 points about 10 cm across, all valid, chroma, centroids, bbox =
    the template size, identity base poses); ``win``: the median window
    (not capped at 192, as bench.py builds it); ``K``: the camera;
    ``icp``: ``IcpConfig(max_iters=16)``; ``max_refine``: 8; and
    ``verify_pts`` (mm) / ``verify_colors``: the first cloud and random
    colors.
    """
    rng = np.random.default_rng(seed)
    whs0 = np.asarray(whs0)
    n_tmpl, n_pts = len(whs0), 512
    face = rng.integers(0, 3, (n_tmpl, n_pts))
    sgn = rng.choice([-1.0, 1.0], (n_tmpl, n_pts))
    cl = rng.uniform(-0.05, 0.05, (n_tmpl, n_pts, 3)).astype(np.float32)
    for ax in range(3):
        m = face == ax
        cl[..., ax] = np.where(m, 0.05 * sgn, cl[..., ax]).astype(np.float32)
    chroma = rng.uniform(0.2, 0.4, (n_tmpl, n_pts, 2)).astype(np.float32)
    fields = (
        cl,
        np.ones((n_tmpl, n_pts), bool),
        chroma,
        cl.mean(1),
        whs0.astype(np.int32),
        np.tile(np.eye(4, dtype=np.float32), (n_tmpl, 1, 1)),
    )
    win = (int(-(-(whs0[:, 1].max() + 1) // 16) * 16), int(-(-(whs0[:, 0].max() + 1) // 16) * 16))
    return {
        "fields": fields,
        "win": win,
        "K": BENCH_K.copy(),
        "icp": IcpConfig(max_iters=16),
        "max_refine": 8,
        "verify_pts": (cl[0] * 1000.0).astype(np.float32),
        "verify_colors": rng.integers(60, 220, (n_pts, 3)).astype(np.float32),
    }


def planted_object(shape_id: int, size: int = OBJECT_SIZE, seed: int = 5):
    """A textured object: (rgb (size, size, 3) uint8, height (size, size)
    int32 mm above its base, mask (size, size) bool).  Shapes: 0 disc,
    1 ellipse, 2 rounded square; each a dome up to 60 mm high."""
    rng = np.random.default_rng(seed + shape_id)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    c = (size - 1) / 2.0
    u, v = (xx - c) / (size / 2 - 6), (yy - c) / (size / 2 - 6)
    if shape_id == 0:
        r2 = u * u + v * v
    elif shape_id == 1:
        r2 = u * u + (v / 0.7) ** 2
    else:
        r2 = np.maximum(np.abs(u), np.abs(v)) ** 6 + 0.2 * (u * u + v * v)
    mask = r2 < 1.0
    rgb = np.zeros((size, size, 3), np.uint8)
    rgb[mask] = (60, 170, 230)
    rgb[mask & (xx > c)] = (230, 90, 30)
    rgb[mask & (yy > c) & (xx <= c)] = (120, 230, 60)
    rgb[mask & (yy < c / 2)] = (240, 240, 90)
    noise = rng.integers(0, 20, (size, size, 3), np.uint8)
    rgb = np.where(mask[..., None], np.clip(rgb.astype(np.int32) + noise, 0, 255), 0).astype(np.uint8)
    height = np.where(mask, 60.0 * np.sqrt(np.clip(1.0 - r2, 0.0, 1.0)), 0.0).astype(np.int32)
    return rgb, height, mask


def _paste(rgb, depth, shape_id: int, x: int, y: int, base_mm: int) -> np.ndarray:
    """Paste object ``shape_id`` with its top-left at (x, y); returns its
    mask in frame coordinates."""
    obj, height, m = planted_object(shape_id)
    s = obj.shape[0]
    rgb[y : y + s, x : x + s][m] = obj[m]
    depth[y : y + s, x : x + s][m] = (base_mm - height[m]).astype(depth.dtype)
    mask = np.zeros(depth.shape, bool)
    mask[y : y + s, x : x + s] = m
    return mask


def training_view(shape_id: int, at: Tuple[int, int] = (264, 184)):
    """(rgb, depth uint16, mask uint8) of object ``shape_id`` with its
    top-left at ``at`` = (x, y) on a black VGA canvas, a plane at 900 mm."""
    rgb = np.zeros(VGA + (3,), np.uint8)
    depth = np.full(VGA, 900, np.uint16)
    mask = _paste(rgb, depth, shape_id, at[0], at[1], 850)
    return rgb, depth, mask.astype(np.uint8) * 255


def planted_scene(x: int, y: int, seed: int = 11):
    """(rgb, depth uint16) of a cluttered VGA scene with object 0 pasted at
    top-left (x, y): low-contrast noise on a noisy plane at 900 mm."""
    return planted_scene_multi([(0, x, y)], seed)


def planted_scene_multi(placements: Sequence[Tuple[int, int, int]], seed: int = 11):
    """(rgb, depth uint16) of the cluttered VGA scene of ``planted_scene``
    with object ``shape_id`` pasted at top-left (x, y) for each
    ``(shape_id, x, y)`` of ``placements``, in order."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(30, 70, VGA + (3,), np.uint8)
    depth = (900 + rng.integers(-2, 3, VGA)).astype(np.uint16)
    for shape_id, x, y in placements:
        _paste(rgb, depth, shape_id, x, y, 850)
    return rgb, depth


# The synthetic benchmark's camera and frame (benchmark.py:run_benchmark at
# im_size (320, 240)), and its bank's shape: 9 meshes of 73-87 mm diagonal
# at 450 mm under f = 280 span 45-54 px, and 80 views over the full sphere
# with tilt_step 0.2 pi make 810 templates per class.
SYNTH_K = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1]], np.float32)
SYNTH_FRAME = (240, 320)
SYNTH_CLASSES = 9
SYNTH_VIEWS = 810
SYNTH_CFG = DetectorConfig(
    t_at_level=(4, 8),
    top_k=128,
    color=ColorGradientConfig(num_features=40, strong_threshold=30.0),
    depth=DepthNormalConfig(num_features=24, extract_threshold=1, focal=280.0),
)


def multiclass_workload(classes: int = SYNTH_CLASSES, views: int = SYNTH_VIEWS, seed: int = 0) -> dict:
    """A multi-class workload of the synthetic benchmark's shape and
    settings (``SYNTH_r05.json``: top_k 128, 96 hypotheses per class, 4
    seeds with the flip, 20 ICP iterations, verify_tau 6), drawn from
    ``seed``.

    Per class c: ``views`` templates whose level-0 (width, height) are
    drawn in [12, 45 + c * 9 / 8] px (the class's largest view), with 40
    colour features (channels 0-7) and 24 depth features (channels 8-15)
    at level 0 and 20 + 12 at level 1, as ``DetectorConfig(color=40,
    depth=24)`` extracts them; each template's info carries a box-surface
    cloud of 512 points (the pattern of ``bench_refine_bank``, the box's
    diagonal the class's 73 + 14 c / 8 mm) with colours, an identity pose
    and its bbox.  Each class verifies against its first cloud (mm) and
    512 random colours.  The frame is 320 x 240 RGB noise on a noisy plane
    at 450 mm.

    Returns a dict: ``class_ids``, ``templates`` and ``infos`` (per class,
    per template), ``rgb`` (240, 320, 3) uint8, ``depth`` (240, 320)
    uint16, ``K``, ``cfg``, ``threshold`` (55), ``icp``, ``max_refine``,
    ``icp_seeds``, ``seed_flip``, ``num_points``, ``verify_tau``,
    ``verify_color_weight``, ``verify_pts`` and ``verify_colors`` (class id
    -> (512, 3)).
    """
    rng = np.random.default_rng(seed)
    n_pts = 512
    out = {"class_ids": [f"obj_{c:02d}" for c in range(classes)], "templates": [], "infos": [],
           "verify_pts": {}, "verify_colors": {}}
    for c, cid in enumerate(out["class_ids"]):
        largest = int(round(45 + c * 9 / 8))
        whs = rng.integers(12, largest + 1, (views, 2))
        levels = []
        for l, (n_color, n_depth) in enumerate(((40, 24), (20, 12))):
            wl, hl = whs[:, 0] >> l, whs[:, 1] >> l
            n_f = n_color + n_depth
            xs = (rng.random((views, n_f)) * (wl[:, None] + 1)).astype(np.int64)
            ys = (rng.random((views, n_f)) * (hl[:, None] + 1)).astype(np.int64)
            ch = np.concatenate([rng.integers(0, 8, (views, n_color)), rng.integers(8, 16, (views, n_depth))], 1)
            levels.append((np.stack([xs, ys, ch], -1), wl, hl))
        out["templates"].append([
            [TemplateLevel(features=f[i], width=int(wl[i]), height=int(hl[i]), pyramid_level=l)
             for l, (f, wl, hl) in enumerate(levels)]
            for i in range(views)
        ])
        half = (73 + 14 * c / 8) / 2 / np.sqrt(3) / 1000.0  # the box's half edge, m
        face = rng.integers(0, 3, (views, n_pts))
        sgn = rng.choice([-1.0, 1.0], (views, n_pts))
        cl = rng.uniform(-half, half, (views, n_pts, 3)).astype(np.float32)
        for ax in range(3):
            cl[..., ax] = np.where(face == ax, half * sgn, cl[..., ax]).astype(np.float32)
        colors = rng.integers(60, 220, (views, n_pts, 3)).astype(np.uint8)
        out["infos"].append([
            {"icp_points": cl[i], "icp_colors": colors[i], "cam_R_w2c": np.eye(3), "cam_t_w2c": np.zeros((3, 1)),
             "render_bbox": np.array([0, 0, whs[i, 0], whs[i, 1]])}
            for i in range(views)
        ])
        out["verify_pts"][cid] = (cl[0] * 1000.0).astype(np.float32)
        out["verify_colors"][cid] = rng.integers(60, 220, (n_pts, 3)).astype(np.float32)
    out["rgb"], out["depth"] = _multiclass_frame(rng)
    out.update(K=SYNTH_K.copy(), cfg=SYNTH_CFG, threshold=55.0, icp=IcpConfig(max_iters=20), max_refine=96,
               icp_seeds=4, seed_flip=True, num_points=n_pts, verify_tau=6.0, verify_color_weight=0.5)
    return out


def _multiclass_frame(rng):
    h, w = SYNTH_FRAME
    rgb = rng.integers(0, 255, (h, w, 3), np.uint8)
    return rgb, (450 + 30 * rng.standard_normal((h, w))).astype(np.uint16)


def multiclass_frame(seed: int):
    """(rgb, depth) drawn as ``multiclass_workload`` draws its frame, from
    ``default_rng(seed)`` alone: more frames for the workload's bank."""
    return _multiclass_frame(np.random.default_rng(seed))


def multiclass_detector(workload: dict, device) -> Detector:
    """A ``Detector`` on ``device`` holding every class of a
    ``multiclass_workload`` with its refine infos."""
    det = Detector(workload["cfg"], device=device)
    for cid, templates, infos in zip(workload["class_ids"], workload["templates"], workload["infos"]):
        for levels, info in zip(templates, infos):
            det.bank.add_template_levels(cid, levels, info)
    return det


def multiclass_pipeline_args(workload: dict) -> dict:
    """The keyword arguments of ``FusedMultiClassPipeline`` (after the
    detector and the camera) for a ``multiclass_workload``."""
    names = ("icp", "max_refine", "num_points", "verify_pts", "verify_colors", "verify_tau", "verify_color_weight",
             "icp_seeds", "seed_flip")
    return {n: workload[n] for n in names}


# The multi-scale sweep of tools/bench_multiscale_multiclass.py: the case1
# bank's settings (DetectorConfig(t_at_level=(5, 8), top_k=128), 63 colour
# and 63 depth features at level 0, 31 + 31 at level 1), 15 classes of 337
# templates trained at 600 mm, 5 proposals, threshold 70.
MS_CFG = DetectorConfig(t_at_level=(5, 8), top_k=128)
MS_CLASSES = 15
MS_VIEWS = 337
MS_TRAIN_DEPTH = 600.0
# The frame's depth planes: (first row, depth mm), each a bin centre of the
# default histogram (100 mm bins from 400 mm), 3 or more bins apart so each
# is its own peak; 4 planes give 4 proposals of 5 and one empty.
MS_PLANES = ((0, 650), (160, 950), (290, 1250), (400, 1650))


def multiscale_workload(classes: int = MS_CLASSES, views: int = MS_VIEWS, seed: int = 0) -> dict:
    """A multi-scale workload of the JAX sweep's shape, drawn from ``seed``.

    Per class c: ``views`` templates whose level-0 (width, height) are
    drawn in [24, 2 * L_c] px with template 0 at (2 L_c, 2 L_c), where
    L_c = 32 + c * 14 // (classes - 1) spreads the classes' largest level-1
    extents over 32-46 px (46 px is the LINEMOD-scale extent; different
    extents give the coarse maps a non-zero padding); 63 colour features (channels 0-7) and
    63 depth features (channels 8-15) at level 0 and 31 + 31 at level 1,
    as ``MS_CFG`` extracts them.  The frame is VGA RGB noise over four
    noisy depth planes (``MS_PLANES``, noise sd 15 mm).

    Returns a dict: ``class_ids``, ``templates`` (per class, per template,
    per level), ``rgb`` (480, 640, 3) uint8, ``depth`` (480, 640) uint16,
    ``cfg``, ``train_depth``, ``num_scales`` (5), ``threshold`` (70).
    """
    rng = np.random.default_rng(seed)
    out = {"class_ids": [f"obj_{c:02d}" for c in range(classes)], "templates": []}
    for c in range(classes):
        largest = 32 + c * 14 // max(classes - 1, 1)
        whs = rng.integers(24, 2 * largest + 1, (views, 2))
        whs[0] = 2 * largest
        levels = []
        for l, n_f in enumerate((63, 31)):
            wl, hl = whs[:, 0] >> l, whs[:, 1] >> l
            xs = (rng.random((views, 2 * n_f)) * (wl[:, None] + 1)).astype(np.int64)
            ys = (rng.random((views, 2 * n_f)) * (hl[:, None] + 1)).astype(np.int64)
            ch = np.concatenate([rng.integers(0, 8, (views, n_f)), rng.integers(8, 16, (views, n_f))], 1)
            levels.append((np.stack([xs, ys, ch], -1), wl, hl))
        out["templates"].append([
            [TemplateLevel(features=f[i], width=int(wl[i]), height=int(hl[i]), pyramid_level=l)
             for l, (f, wl, hl) in enumerate(levels)]
            for i in range(views)
        ])
    out["rgb"], out["depth"] = _multiscale_frame(rng)
    out.update(cfg=MS_CFG, train_depth=MS_TRAIN_DEPTH, num_scales=5, threshold=70.0)
    return out


def _multiscale_frame(rng):
    rgb = rng.integers(0, 255, VGA + (3,), np.uint8)
    depth = np.zeros(VGA, np.float64)
    for row, mm in MS_PLANES:
        depth[row:] = mm
    return rgb, np.round(depth + 15.0 * rng.standard_normal(VGA)).astype(np.uint16)


def multiscale_frame(seed: int):
    """(rgb, depth) drawn as ``multiscale_workload`` draws its frame, from
    ``default_rng(seed)`` alone: more frames for the workload's bank."""
    return _multiscale_frame(np.random.default_rng(seed))


def multiscale_detector(workload: dict, device) -> Detector:
    """A ``Detector`` on ``device`` holding every class of a
    ``multiscale_workload``."""
    det = Detector(workload["cfg"], device=device)
    for cid, templates in zip(workload["class_ids"], workload["templates"]):
        for levels in templates:
            det.bank.add_template_levels(cid, levels)
    return det


def _resize_nearest(a: np.ndarray, scale: float) -> np.ndarray:
    """Nearest-neighbour resize of the first two axes by ``scale``: output
    pixel i samples input pixel floor((i + 0.5) / scale)."""
    h, w = a.shape[:2]
    ys = np.minimum(((np.arange(int(round(h * scale))) + 0.5) / scale).astype(np.int64), h - 1)
    xs = np.minimum(((np.arange(int(round(w * scale))) + 0.5) / scale).astype(np.int64), w - 1)
    return a[ys][:, xs]


def planted_scene_scaled(x: int, y: int, scale: float, depth_mm: int, seed: int = 11, far_rows: int = 100,
                         far_mm: int = 750):
    """(rgb, depth uint16) of the cluttered VGA scene of ``planted_scene``
    with object 0 resized by ``scale`` (nearest neighbour) pasted at
    top-left (x, y) with its base at ``depth_mm``, on a noisy plane at
    ``depth_mm``; the first ``far_rows`` rows are a second plane at
    ``far_mm``, so the histogram proposes two depths."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(30, 70, VGA + (3,), np.uint8)
    depth = (depth_mm + rng.integers(-2, 3, VGA)).astype(np.uint16)
    depth[:far_rows] = (far_mm + rng.integers(-2, 3, (far_rows, VGA[1]))).astype(np.uint16)
    obj, height, m = (_resize_nearest(a, scale) for a in planted_object(0))
    s_h, s_w = m.shape
    rgb[y : y + s_h, x : x + s_w][m] = obj[m]
    depth[y : y + s_h, x : x + s_w][m] = (depth_mm - height[m]).astype(np.uint16)
    return rgb, depth


# The bin-picking frame of the segmentation path (``bin_picking_scene``):
# objects 450-600 mm away within +-120 mm of the axis, and a floor plane
# tilted from 700 mm at the bottom row back by 0.15 mm per VGA row.
BIN_DEPTH_RANGE = (450.0, 600.0)
BIN_SPREAD_MM = 120.0
BIN_SURFACE_POINTS = 2048


def mesh_surface_points(mesh: dict, n: int = BIN_SURFACE_POINTS, seed: int = 0) -> np.ndarray:
    """(n, 3) float64 points (mm) drawn uniformly over a mesh's surface:
    faces by area, then barycentric coordinates, from ``seed``."""
    pts = np.asarray(mesh["pts"], np.float64)
    tri = pts[np.asarray(mesh["faces"])]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    rng = np.random.default_rng(seed)
    face = rng.choice(len(tri), n, p=area / area.sum())
    u, v = rng.random(n), rng.random(n)
    flip = u + v > 1.0
    u[flip], v[flip] = 1.0 - u[flip], 1.0 - v[flip]
    t = tri[face]
    return t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) + v[:, None] * (t[:, 2] - t[:, 0])


def bin_picking_scene(im_size: Tuple[int, int] = (640, 480), focal: float = 545.0, seed: int = 0, device=None) -> dict:
    """The nine meshes of ``benchmark.make_models`` placed by
    ``benchmark.make_scene`` (``np.random.default_rng(seed)``, depth range
    ``BIN_DEPTH_RANGE``, spread ``BIN_SPREAD_MM``) over a tilted floor where
    the render is empty, rendered on ``device``.

    Returns dict of numpy arrays: rgb (H, W, 3) uint8, depth (H, W) uint16
    mm, K, the objects' ids, R, t, visible masks (O, H, W) bool (the pixels
    each object's depth won), and model clouds (surface samples, mm).
    """
    from sixdpose_tpu_torch import benchmark as TB
    from sixdpose_tpu_torch.geometry.render import render

    w, h = im_size
    K = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]])
    models = TB.make_models()
    rgb, depth, gts = TB.make_scene(models, K, im_size, np.random.default_rng(seed), depth_range=BIN_DEPTH_RANGE,
                                    spread_mm=BIN_SPREAD_MM, device=device)
    # Which object won each pixel, by make_scene's own merge rule.
    near = np.zeros((h, w), np.float32)
    owner = np.full((h, w), -1, np.int64)
    for i, g in enumerate(gts):
        d_i = render(models[g["obj_id"]], im_size, K, g["R"], g["t"], mode="depth", device=device).cpu().numpy()
        closer = (d_i > 0) & ((near == 0) | (d_i < near))
        near[closer] = d_i[closer]
        owner[closer] = i
    rows = np.arange(h, dtype=np.float64)[:, None] * (480.0 / h)
    floor = (700.0 + 0.15 * (480.0 - rows)) * np.ones((1, w))
    depth = np.where(depth > 0, depth, floor.astype(np.uint16))
    return {
        "rgb": rgb,
        "depth": depth,
        "K": K,
        "obj_ids": [g["obj_id"] for g in gts],
        "R": np.stack([g["R"] for g in gts]),
        "t": np.stack([np.asarray(g["t"], np.float64).reshape(3) for g in gts]),
        "masks": np.stack([owner == i for i in range(len(gts))]),
        "model_points": [mesh_surface_points(models[g["obj_id"]], seed=i) for i, g in enumerate(gts)],
    }
