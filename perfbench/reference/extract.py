"""Template extraction (copy of the port's ``models/templates.py``
extraction: the reference's ColorGradientPyramid and DepthNormalPyramid
extractTemplate and cropTemplates).  The benchmark extracts its planted
views with it at set-up, so the bank does not follow later changes to
the port's extractor.

Frozen at commit 354f402 as part of the benchmark's yardstick: later
changes to the port do not reach it.  Plain PyTorch and NumPy; imports
nothing of the port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from scipy import ndimage

from perfbench.reference import quantize as Q
from perfbench.reference.config import DetectorConfig

@dataclasses.dataclass
class TemplateLevel:
    """One template's features at one pyramid level.

    features: (F, 3) int array of (x, y, channel); channel = mod*8 + label.
    width/height: template bbox extent at this level (after cropping).
    """

    features: np.ndarray
    width: int
    height: int
    pyramid_level: int


def select_scattered_features(
    xs: np.ndarray,
    ys: np.ndarray,
    scores: np.ndarray,
    num_features: int,
    distance: float,
) -> Optional[np.ndarray]:
    """Greedy selection of well-scattered high-score candidates
    (``selectScatteredFeatures``, cpp:279-318): walk the candidates in score
    order, keep one if it lies at least ``distance`` from all kept so far;
    at the end of the list, restart with distance - 1.  Candidates must be
    sorted by score, descending.

    The port's loop, with the test "closer than ``distance`` to a kept
    candidate" read from a map of the pixels that the kept candidates'
    disks cover (the same integer test, dx^2 + dy^2 < distance^2), so a
    candidate costs one lookup.  Returns indices of the selected
    candidates, or None if impossible.
    """
    n = len(xs)
    if n < num_features:
        return None
    xs = np.asarray(xs, np.int64)
    ys = np.asarray(ys, np.int64)
    x0, y0 = int(xs.min()), int(ys.min())
    w, h = int(xs.max()) - x0 + 1, int(ys.max()) - y0 + 1
    cx, cy = (xs - x0).tolist(), (ys - y0).tolist()
    selected: List[int] = []
    dist = float(distance)
    guard = 0
    while True:
        dist_sq = dist * dist
        r = min(int(np.ceil(np.sqrt(dist_sq))) + 1, max(w, h))  # a wider disk covers nothing more
        oy, ox = np.mgrid[-r : r + 1, -r : r + 1]
        disk = (ox * ox + oy * oy) < dist_sq
        blocked = np.zeros((h + 2 * r, w + 2 * r), bool)

        def stamp(i):
            blocked[cy[i] : cy[i] + 2 * r + 1, cx[i] : cx[i] + 2 * r + 1] |= disk

        for j in selected:
            stamp(j)
        for i in range(n):
            if not blocked[cy[i] + r, cx[i] + r]:
                selected.append(i)
                if len(selected) == num_features:
                    return np.array(selected, dtype=np.int64)
                stamp(i)
        dist -= 1.0
        guard += 1
        if guard > 10000:
            return None


def extract_color_features(
    quantized: np.ndarray,
    magnitude: np.ndarray,
    mask: Optional[np.ndarray],
    num_features: int,
    strong_threshold: float,
) -> Optional[np.ndarray]:
    """Color-gradient template features, (F, 3) of (x, y, label)
    (cpp:589-643)."""
    if mask is not None:
        m = mask.astype(bool)
        eroded = ndimage.binary_erosion(m, structure=np.ones((3, 3), bool), border_value=1)
        border = m & ~eroded
    else:
        border = np.ones_like(quantized, dtype=bool)
    cand = border & (quantized > 0) & (magnitude > strong_threshold * strong_threshold)
    ys, xs = np.nonzero(cand)
    if len(ys) < num_features:
        return None
    scores = magnitude[ys, xs]
    order = np.argsort(-scores, kind="stable")
    xs, ys, scores = xs[order], ys[order], scores[order]
    distance = len(xs) / num_features + 1.0
    sel = select_scattered_features(xs, ys, scores, num_features, distance)
    if sel is None:
        return None
    labels = np.log2(quantized[ys[sel], xs[sel]].astype(np.int32)).astype(np.int64)
    return np.stack([xs[sel], ys[sel], labels], axis=1)


def extract_depth_features(
    quantized: np.ndarray,
    mask: Optional[np.ndarray],
    num_features: int,
    extract_threshold: int,
) -> Optional[np.ndarray]:
    """Depth-normal template features, (F, 3) of (x, y, label)
    (cpp:888-966)."""
    if mask is not None:
        m = mask.astype(bool)
        local = ndimage.binary_erosion(
            m, structure=np.ones((3, 3), bool), iterations=2, border_value=1
        )
    else:
        local = np.ones_like(quantized, dtype=bool)

    distances = np.zeros((8,) + quantized.shape, np.float32)
    for i in range(8):
        region = local & (quantized & (1 << i)).astype(bool)
        # DIST_C with a 3x3 mask = chessboard metric (cpp:905).
        distances[i] = ndimage.distance_transform_cdt(region, metric="chessboard")

    valid = local & (quantized != 0) & (quantized != 255)
    ys, xs = np.nonzero(valid)
    if len(ys) == 0:
        return None
    labels = np.log2(quantized[ys, xs].astype(np.int32)).astype(np.int64)
    score = distances[labels, ys, xs]
    keep = score >= extract_threshold
    xs, ys, labels, score = xs[keep], ys[keep], labels[keep], score[keep]
    if len(xs) < num_features:
        return None
    counts = np.bincount(labels, minlength=8).astype(np.float32)
    score = score / counts[labels]
    order = np.argsort(-score, kind="stable")
    xs, ys, labels, score = xs[order], ys[order], labels[order], score[order]
    area = float(local.sum()) if mask is not None else float(quantized.size)
    distance = np.sqrt(area) / np.sqrt(num_features) + 1.5
    sel = select_scattered_features(xs, ys, score, num_features, distance)
    if sel is None:
        return None
    return np.stack([xs[sel], ys[sel], labels[sel]], axis=1)


def crop_template_levels(levels: List[List[Optional[np.ndarray]]]) -> List[TemplateLevel]:
    """Shift the features of all (level, modality) sets to a common bbox.

    Args:
      levels: levels[l][m] = (F, 3) features of modality m at level l, the
        channel column still holding the 0..7 label.

    Returns one merged TemplateLevel per pyramid level with channel =
    mod*8 + label (reference cropTemplates, cpp:234-277).
    """
    min_x = min_y = np.inf
    max_x = max_y = -np.inf
    for l, mods in enumerate(levels):
        for feats in mods:
            if feats is None or len(feats) == 0:
                continue
            xs = feats[:, 0] << l
            ys = feats[:, 1] << l
            min_x = min(min_x, xs.min())
            min_y = min(min_y, ys.min())
            max_x = max(max_x, xs.max())
            max_y = max(max_y, ys.max())
    min_x, min_y = int(min_x), int(min_y)
    max_x, max_y = int(max_x), int(max_y)
    min_x -= min_x % 2
    min_y -= min_y % 2

    out = []
    for l, mods in enumerate(levels):
        ox, oy = min_x >> l, min_y >> l
        merged = []
        for m, feats in enumerate(mods):
            if feats is None or len(feats) == 0:
                continue
            f = feats.copy()
            f[:, 0] -= ox
            f[:, 1] -= oy
            f[:, 2] = m * 8 + f[:, 2]
            merged.append(f)
        all_f = np.concatenate(merged, axis=0) if merged else np.zeros((0, 3), np.int64)
        out.append(
            TemplateLevel(
                features=all_f,
                width=(max_x - min_x) >> l,
                height=(max_y - min_y) >> l,
                pyramid_level=l,
            )
        )
    return out


def extract_template_from_quantized(
    color_levels: Optional[List],
    depth_levels: Optional[List],
    mask: np.ndarray,
    cfg: DetectorConfig,
) -> Optional[List[TemplateLevel]]:
    """Extraction from precomputed quantizations (host only).

    color_levels: per level (quantized (H,W) u8, magnitude (H,W) f32).
    depth_levels: per level quantized normal (H,W) u8.
    """
    levels: List[List[Optional[np.ndarray]]] = [[] for _ in cfg.t_at_level]

    if color_levels is not None:
        cur_mask = mask
        nf = cfg.color.num_features
        for l in range(cfg.pyramid_levels):
            if l > 0:
                cur_mask = cur_mask[::2, ::2]
                nf = nf // 2
            q, mag = color_levels[l]
            feats = extract_color_features(
                np.asarray(q), np.asarray(mag), cur_mask, nf, cfg.color.strong_threshold
            )
            if feats is None:
                return None
            levels[l].append(feats)

    if depth_levels is not None:
        cur_mask = mask
        nf = cfg.depth.num_features
        thr = cfg.depth.extract_threshold
        for l in range(cfg.pyramid_levels):
            if l > 0:
                cur_mask = cur_mask[::2, ::2]
                nf = nf // 2
                thr = thr // 2
            feats = extract_depth_features(np.asarray(depth_levels[l]), cur_mask, nf, max(thr, 1))
            if feats is None:
                return None
            levels[l].append(feats)

    return crop_template_levels(levels)


def extract_template(rgb: np.ndarray, depth: np.ndarray, mask: np.ndarray, cfg: DetectorConfig,
                     device) -> Optional[List[TemplateLevel]]:
    """One multi-level template (the reference's Detector::addTemplate,
    cpp:1943-1975), quantized on ``device``; None if a level finds too few
    features."""
    color_levels = []
    cur = torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.uint8)).to(device)
    for l in range(cfg.pyramid_levels):
        if l > 0:
            cur = Q.pyr_down_rgb(cur)
        q, mag = Q.quantize_color_gradient(cur, cfg.color.weak_threshold)
        color_levels.append((q.cpu().numpy(), mag.cpu().numpy()))
    d = torch.from_numpy(np.asarray(depth).astype(np.int32)).to(device)
    qs = Q.depth_normal_pyramid(d, cfg.pyramid_levels, cfg.depth.distance_threshold,
                                cfg.depth.difference_threshold, cfg.depth.focal)
    return extract_template_from_quantized(color_levels, [q.cpu().numpy() for q in qs], mask, cfg)
