"""The general traffic generator: a configuration's bank and a mix's frames,
made from one seed.

It follows the patterns of the port's ``synthetic.py`` (``planted_object``,
``multiclass_workload``, ``multiscale_workload`` and their frames),
rewritten here so that the yardstick does not move with the program:

- Each class has one object: a textured dome of the class's size (the
  ``planted_object`` pattern, its outline, aspect and colours varying with
  the class), seen in ``planted_views`` in-plane views (steps of 360 /
  planted_views degrees).  Each view is a template extracted at set-up by
  the benchmark's frozen extractor (``reference/extract.py``) from the view
  on a plane at the training depth, with its refine infos: the dome's
  cloud in the training camera's frame, its training pose and its bbox.
  The class's verification mesh is a grid over the dome.
- The class's other views, up to ``views``, are drawn as
  ``multiclass_workload`` draws them: feature lists uniform over extents
  drawn up to the class's size, box-surface clouds, identity poses.  They
  compete in every frame without matching.
- A frame is RGB noise over noisy depth planes across the configuration's
  depth range (the ``multiscale_frame`` pattern), with the mix's number of
  planted objects, each a view of a different class, pasted on a plane
  with its base at the plane's depth; in a multi-scale configuration it is
  resized by the training depth over the plane's depth.

Sizes are fixed by the configuration and the mix, and the seed moves only
the draws: every seed gives the same number of templates, features,
frames and objects.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from perfbench.reference.config import ColorGradientConfig, DepthNormalConfig, DetectorConfig
from perfbench.reference.extract import TemplateLevel, extract_template

EXTRACT_MARGIN = 16  # px of background around a view on its extraction canvas


def detector_config(cfg: dict) -> DetectorConfig:
    """The matcher's settings of a configuration file (``detector``)."""
    d = cfg["detector"]
    return DetectorConfig(
        t_at_level=tuple(d["t_at_level"]),
        top_k=int(d["top_k"]),
        color=ColorGradientConfig(num_features=int(d["color_features"])),
        depth=DepthNormalConfig(num_features=int(d["depth_features"])),
    )


@dataclasses.dataclass
class Workload:
    """What the generator hands to the program and to the reference alike.

    class_ids: C names.  templates[c][i]: per level ``TemplateLevel``.
    infos[c][i]: the refine infos of template i of class c.  meshes[c]:
    the class's verification mesh (pts mm, faces, colors).  frames: the
    pool of (rgb (H, W, 3) uint8, depth (H, W) uint16).  placements[f]:
    (class, view, x, y, depth_mm, scale) of each object planted in frame f.
    K: (3, 3) the frames' camera.
    """

    class_ids: List[str]
    templates: List[List[List[TemplateLevel]]]
    infos: List[List[dict]]
    meshes: Dict[str, dict]
    frames: List[tuple]
    placements: List[list]
    K: np.ndarray


def class_sizes(cfg: dict) -> np.ndarray:
    """Each class's object size in px at level 0 (its largest extent),
    spread evenly over the configuration's ``object_px``."""
    lo, hi = cfg["object_px"]
    c_n = cfg["classes"]
    return np.round(lo + (hi - lo) * np.arange(c_n) / max(c_n - 1, 1)).astype(np.int64)


def class_object(c: int, size: int, rng: np.random.Generator, height_mm: float):
    """The dome of class ``c`` on a (size, size) canvas: (rgb uint8, height
    mm float64, mask bool).  Its outline (disc, ellipse or rounded square)
    and aspect follow ``c``, its four colours and their noise come from
    ``rng``."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    cen = (size - 1) / 2.0
    u, v = (xx - cen) / (size / 2 - 3), (yy - cen) / (size / 2 - 3)
    aspect = 0.6 + 0.4 * ((c * 7) % 5) / 4
    shape = c % 3
    if shape == 0:
        r2 = u * u + v * v
    elif shape == 1:
        r2 = u * u + (v / aspect) ** 2
    else:
        r2 = (np.abs(u) ** 6 + np.abs(v / aspect) ** 6) * 1.4 + 0.2 * (u * u + v * v)
    mask = r2 < 1.0
    colours = rng.integers(40, 250, (4, 3))
    rgb = np.zeros((size, size, 3), np.int64)
    rgb[mask] = colours[0]
    rgb[mask & (xx > cen)] = colours[1]
    rgb[mask & (yy > cen) & (xx <= cen)] = colours[2]
    rgb[mask & (yy < cen / 2)] = colours[3]
    noise = rng.integers(0, 20, (size, size, 3))
    rgb = np.where(mask[..., None], np.clip(rgb + noise, 0, 255), 0).astype(np.uint8)
    height = np.where(mask, height_mm * np.sqrt(np.clip(1.0 - r2, 0.0, 1.0)), 0.0)
    return rgb, height, mask


def rotate_view(rgb, height, mask, degrees: float):
    """The sprite turned in-plane by ``degrees`` about its centre (nearest
    neighbour, on the same canvas)."""
    size = mask.shape[0]
    cen = (size - 1) / 2.0
    a = np.deg2rad(degrees)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    sx = np.cos(a) * (xx - cen) + np.sin(a) * (yy - cen) + cen
    sy = -np.sin(a) * (xx - cen) + np.cos(a) * (yy - cen) + cen
    ix, iy = np.round(sx).astype(np.int64), np.round(sy).astype(np.int64)
    inside = (ix >= 0) & (ix < size) & (iy >= 0) & (iy < size)
    ix, iy = ix.clip(0, size - 1), iy.clip(0, size - 1)
    m = inside & mask[iy, ix]
    return np.where(m[..., None], rgb[iy, ix], 0).astype(np.uint8), np.where(m, height[iy, ix], 0.0), m


def resize_nearest(a: np.ndarray, scale: float) -> np.ndarray:
    """Nearest-neighbour resize of the first two axes by ``scale`` (output
    pixel i samples input pixel floor((i + 0.5) / scale))."""
    h, w = a.shape[:2]
    ys = np.minimum(((np.arange(int(round(h * scale))) + 0.5) / scale).astype(np.int64), h - 1)
    xs = np.minimum(((np.arange(int(round(w * scale))) + 0.5) / scale).astype(np.int64), w - 1)
    return a[ys][:, xs]


def _rot_z(degrees: float) -> np.ndarray:
    a = np.deg2rad(degrees)
    return np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])


def dome_model(rgb, height, mask, focal: float, depth_mm: float):
    """The dome's surface in its model frame (mm; origin at the base's
    centre, z toward the camera's far side) at each mask pixel, with its
    colours."""
    size = mask.shape[0]
    cen = (size - 1) / 2.0
    ys, xs = np.nonzero(mask)
    pts = np.stack([(xs - cen) * depth_mm / focal, (ys - cen) * depth_mm / focal, -height[ys, xs]], 1)
    return pts, rgb[ys, xs].astype(np.float32)


def grid_mesh(rgb, height, mask, focal: float, depth_mm: float, step: int = 2) -> dict:
    """A grid mesh over the dome (every ``step``-th pixel; a face wherever
    a cell's four corners lie on the object) with per-vertex colours."""
    size = mask.shape[0]
    cen = (size - 1) / 2.0
    g = np.arange(0, size, step)
    vid = -np.ones((len(g), len(g)), np.int64)
    on = mask[np.ix_(g, g)]
    vid[on] = np.arange(on.sum())
    gy, gx = np.nonzero(on)
    ys, xs = g[gy], g[gx]
    pts = np.stack([(xs - cen) * depth_mm / focal, (ys - cen) * depth_mm / focal, -height[ys, xs]], 1)
    a, b, c, d = vid[:-1, :-1], vid[:-1, 1:], vid[1:, :-1], vid[1:, 1:]
    ok = (a >= 0) & (b >= 0) & (c >= 0) & (d >= 0)
    faces = np.concatenate([np.stack([a[ok], b[ok], d[ok]], 1), np.stack([a[ok], d[ok], c[ok]], 1)])
    return {"pts": pts, "faces": faces, "colors": rgb[ys, xs].astype(np.float64)}


def planted_templates(cfg: dict, det_cfg: DetectorConfig, c: int, obj, device):
    """The ``planted_views`` templates of class ``c``'s object and their
    refine infos, extracted from each view on a plane at the training
    depth."""
    rgb, height, mask = obj
    size = mask.shape[0]
    focal = float(cfg["K"][0][0])
    z_t = float(cfg["train_depth_mm"])
    side = size + 2 * EXTRACT_MARGIN
    pts_m, cols_m = dome_model(rgb, height, mask, focal, z_t)
    sel = np.linspace(0, len(pts_m) - 1, min(len(pts_m), 1024)).astype(np.int64)
    templates, infos = [], []
    n_views = cfg["planted_views"]
    for k in range(n_views):
        deg = 360.0 * k / n_views
        v_rgb, v_h, v_m = rotate_view(rgb, height, mask, deg)
        canvas = np.zeros((side, side, 3), np.uint8)
        depth = np.full((side, side), z_t + 50.0)
        m = np.zeros((side, side), bool)
        sl = (slice(EXTRACT_MARGIN, EXTRACT_MARGIN + size),) * 2
        canvas[sl][v_m] = v_rgb[v_m]
        depth[sl] = np.where(v_m, z_t - v_h, depth[sl])
        m[sl] = v_m
        levels = extract_template(canvas, np.round(depth).astype(np.uint16), m.astype(np.uint8) * 255, det_cfg, device)
        if levels is None:
            raise ValueError(f"class {c} view {k}: too few features to extract a template (object {size} px)")
        R = _rot_z(deg)
        cloud = (pts_m[sel] @ R.T + np.array([0.0, 0.0, z_t])) / 1000.0
        templates.append(levels)
        infos.append({
            "icp_points": cloud.astype(np.float32), "icp_colors": cols_m[sel],
            "cam_R_w2c": R, "cam_t_w2c": np.array([[0.0], [0.0], [z_t]]),
            "render_bbox": np.array([0, 0, levels[0].width, levels[0].height]),
        })
    return templates, infos


def drawn_templates(cfg: dict, c: int, size: int, count: int, rng: np.random.Generator):
    """``count`` drawn templates of class ``c`` (the ``multiclass_workload``
    pattern: extents uniform in [object_px[0] / 2, size], features uniform
    over them, colour channels 0-7 and depth channels 8-15) with box-surface
    clouds of the class's size, identity poses and their bboxes."""
    d = cfg["detector"]
    lo = max(int(cfg["object_px"][0]) // 2, 16)
    whs = rng.integers(lo, size + 1, (count, 2))
    levels = []
    for l in range(len(d["t_at_level"])):
        n_c, n_d = d["color_features"] >> l, d["depth_features"] >> l
        wl, hl = whs[:, 0] >> l, whs[:, 1] >> l
        xs = (rng.random((count, n_c + n_d)) * (wl[:, None] + 1)).astype(np.int64)
        ys = (rng.random((count, n_c + n_d)) * (hl[:, None] + 1)).astype(np.int64)
        ch = np.concatenate([rng.integers(0, 8, (count, n_c)), rng.integers(8, 16, (count, n_d))], 1)
        levels.append((np.stack([xs, ys, ch], -1), wl, hl))
    templates = [
        [TemplateLevel(features=f[i], width=int(wl[i]), height=int(hl[i]), pyramid_level=l)
         for l, (f, wl, hl) in enumerate(levels)]
        for i in range(count)
    ]
    n_pts = 512
    half = size * float(cfg["train_depth_mm"]) / float(cfg["K"][0][0]) / 2 / np.sqrt(3) / 1000.0
    face = rng.integers(0, 3, (count, n_pts))
    sgn = rng.choice([-1.0, 1.0], (count, n_pts))
    cl = rng.uniform(-half, half, (count, n_pts, 3))
    for ax in range(3):
        cl[..., ax] = np.where(face == ax, half * sgn, cl[..., ax])
    cl = cl.astype(np.float32)
    colors = rng.integers(60, 220, (count, n_pts, 3)).astype(np.uint8)
    infos = [
        {"icp_points": cl[i], "icp_colors": colors[i], "cam_R_w2c": np.eye(3), "cam_t_w2c": np.zeros((3, 1)),
         "render_bbox": np.array([0, 0, whs[i, 0], whs[i, 1]])}
        for i in range(count)
    ]
    return templates, infos


def _plane_depth(cfg: dict, row: int) -> float:
    depth = cfg["planes"][0][1]
    for first, mm in cfg["planes"]:
        if row >= first:
            depth = mm
    return float(depth)


PLACE_TRIES = 300  # placements tried for one class before the next class is taken


def make_frame(cfg: dict, objects: list, count: int, rng: np.random.Generator):
    """One frame with ``count`` planted objects of distinct classes, none
    overlapping another: (rgb, depth uint16, placements).

    An object stands on the plane of its top row, at that plane's depth
    (in a multi-scale configuration resized by the training depth over
    it), and may reach over the farther planes below.  The classes are
    taken in an order drawn from the seed; one for which no free place is
    found in ``PLACE_TRIES`` draws gives way to the next, so that frames
    of the largest objects never fail."""
    h, w = cfg["image"]
    rgb = rng.integers(0, 255, (h, w, 3), np.uint8)
    depth = np.zeros((h, w), np.float64)
    for first, mm in cfg["planes"]:
        depth[first:] = mm
    depth = depth + float(cfg["depth_noise_mm"]) * rng.standard_normal((h, w))
    margin = int(cfg["frame_margin_px"])
    multiscale = int(cfg.get("num_scales", 0)) > 0
    order = rng.permutation(len(objects))
    boxes, placements = [], []
    for c in order:
        if len(placements) == count:
            break
        for _ in range(PLACE_TRIES):
            view = int(rng.integers(0, cfg["planted_views"]))
            y = int(rng.integers(margin, h - margin))
            base = _plane_depth(cfg, y)
            scale = float(cfg["train_depth_mm"]) / base if multiscale else 1.0
            s = int(round(objects[c][2].shape[0] * scale))
            x = int(rng.integers(margin, max(w - margin - s, margin + 1)))
            if y + s > h - margin or x + s > w - margin:
                continue
            if any(x < bx + bs and bx < x + s and y < by + bs and by < y + s for bx, by, bs in boxes):
                continue
            o_rgb, o_h, o_m = rotate_view(*objects[c], 360.0 * view / cfg["planted_views"])
            if multiscale:
                o_rgb, o_h, o_m = (resize_nearest(a, scale) for a in (o_rgb, o_h, o_m))
            s_h, s_w = o_m.shape
            rgb[y : y + s_h, x : x + s_w][o_m] = o_rgb[o_m]
            depth[y : y + s_h, x : x + s_w][o_m] = base - o_h[o_m]
            boxes.append((x, y, s))
            placements.append((int(c), view, x, y, base, scale))
            break
    if len(placements) < count:
        raise ValueError(f"no room for {count} objects in a {w} x {h} frame")
    return rgb, np.round(depth).clip(0, 65535).astype(np.uint16), placements


def generate(cfg: dict, mix: dict, seed: int, device) -> Workload:
    """The bank of configuration ``cfg`` and the frame pool of mix ``mix``,
    from ``seed``."""
    rng = np.random.default_rng(seed)
    det_cfg = detector_config(cfg)
    focal = float(cfg["K"][0][0])
    z_t = float(cfg["train_depth_mm"])
    sizes = class_sizes(cfg)
    class_ids = [f"obj_{c:02d}" for c in range(cfg["classes"])]
    objects, templates, infos, meshes = [], [], [], {}
    for c, cid in enumerate(class_ids):
        size = int(sizes[c])
        obj = class_object(c, size, rng, height_mm=size * z_t / focal / 2)
        objects.append(obj)
        t_p, i_p = planted_templates(cfg, det_cfg, c, obj, device)
        t_d, i_d = drawn_templates(cfg, c, size, cfg["views"] - len(t_p), rng)
        templates.append(t_p + t_d)
        infos.append(i_p + i_d)
        meshes[cid] = grid_mesh(*obj, focal=focal, depth_mm=z_t)
    counts = mix["objects_per_frame"]
    frames, placements = [], []
    for f in range(mix["pool"]):
        rgb, depth, placed = make_frame(cfg, objects, counts[f % len(counts)], rng)
        frames.append((rgb, depth))
        placements.append(placed)
    return Workload(class_ids, templates, infos, meshes, frames, placements, np.asarray(cfg["K"], np.float32))


def check_frames(mix: dict, seed: int) -> List[int]:
    """The pool frames whose results the check compares, drawn from
    ``seed`` apart from the workload's own draws."""
    rng = np.random.default_rng([seed, 1])
    return sorted(int(i) for i in rng.choice(mix["pool"], mix["check_frames"], replace=False))

