"""LCHF patch features: embeddings, responses, batched similarity.

Port of the JAX package's ``lchf/feature.py``.  Reference: cxxLCHF/lchf.h:20-83
(Linemod_embedding / Linemod_feature) and lchf.cpp:524-792.  A patch
feature is:

- rgb embedding: up to ``num_features`` strong-gradient features on the
  (mask-border of the) patch, scatter-selected (lchf.cpp:533-576; the
  initial scatter distance is candidates/num + 4);
- depth embedding: distance-transform-scored normal features
  (lchf.cpp:581-655);
- center_dep: mean of the patch's nonzero depth (lchf.cpp:526-531);
- response maps: 8 rgb + 8 depth maps with spread T=5 and cxxLCHF's own
  binary LUT (exact/45deg -> 4 else 0, lchf.cpp:450-451), padded to a
  multiple of 16 (lchf.cpp:658-713).

similarity(a -> b) (lchf.cpp:716-792): for each of a's features, scale its
coords by center_dep_a / center_dep_b, check the relative-depth gate
(|z_rel_a - z_rel_b| < z_check where z_rel = center_dep - 5x5 mean depth),
and add b's response at the scaled coords; score = sum/count/4*100 where
count includes gated-out (but in-bounds) features.

Image-level ops (quantization, spreading, responses, the 5x5 mean depth)
run as torch ops on ``device`` (CUDA unless ``device="cpu"``); the
scatter-selection and ``similarity_one_to_many`` (the host route of
training and prediction, float64 as in JAX) are numpy.  Depth arrives as
uint16 and is widened to int32 at the device boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.models.templates import extract_depth_features, select_scattered_features
from sixdpose_tpu_torch.ops import quantize as Q
from sixdpose_tpu_torch.ops.spread import compute_response_maps, spread_orientations


@dataclasses.dataclass(frozen=True)
class LchfConfig:
    """Linemod_embedding defaults (lchf.h:22-29)."""

    weak_threshold: float = 10.0
    strong_threshold: float = 55.0
    num_features: int = 15
    distance_threshold: int = 2000
    difference_threshold: int = 50
    extract_threshold: int = 2
    z_check: int = 200
    spread_t: int = 5
    lut: str = "binary45"
    focal: float = 1150.0
    # INTENTIONAL DEVIATION from the reference, kept from the JAX package:
    # cxxLCHF's own gradient quantization calls cv::phase (fastAtan2) like
    # the matcher does (lchf.cpp:210), so "cv" is the parity setting.  The
    # default is "exact" IEEE atan2 because the ~0.3 deg fastAtan2
    # polynomial error flips orientation bins near 11.25-deg boundaries on
    # smooth renders and destabilizes forest routing.  Set phase="cv" for
    # strict reference parity.
    phase: str = "exact"


@dataclasses.dataclass
class PatchFeature:
    """One patch's embedding + response maps.

    features: (F, 3) int (x, y, channel) with channel = 8*is_depth + label.
    z_rel: (F,) float relative depth (center_dep - local 5x5 mean depth).
    responses: (16, Hp, Wp) uint8 (rgb maps 0-7, depth maps 8-15), or None.
    z_avg: (H, W) float 5x5 mean of nonzero depth over the patch.
    """

    features: np.ndarray
    z_rel: np.ndarray
    center_dep: float
    responses: Optional[np.ndarray]
    z_avg: Optional[np.ndarray]
    shape: Tuple[int, int]


def _depth_tensor(depth, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(depth).astype(np.int32)).to(device)


def _rgb_tensor(rgb, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.uint8)).to(device)


def mean_depth_5x5_tensor(depth: torch.Tensor) -> torch.Tensor:
    """(H, W) 5x5 mean of NONZERO depth per pixel, float32, on the depth's
    device: the 25 shifted adds in the JAX order, then one division by a
    tensor."""
    d = depth.to(torch.float32)
    nz = (d > 0).to(torch.float32)
    h, w = d.shape
    pad_d = torch.nn.functional.pad(d, (2, 2, 2, 2))
    pad_n = torch.nn.functional.pad(nz, (2, 2, 2, 2))
    s = torch.zeros_like(d)
    c = torch.zeros_like(d)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            s = s + pad_d[2 + dy : h + 2 + dy, 2 + dx : w + 2 + dx]
            c = c + pad_n[2 + dy : h + 2 + dy, 2 + dx : w + 2 + dx]
    return s / torch.maximum(c, torch.ones_like(c))


def mean_depth_5x5(depth: np.ndarray, device=None) -> np.ndarray:
    """5x5 mean of NONZERO depth per pixel (reference get_depth,
    lchf.cpp:721-738; border windows clip)."""
    return mean_depth_5x5_tensor(_depth_tensor(depth, resolve_device(device))).cpu().numpy()


def extract_patch_feature(
    rgb: np.ndarray,
    depth: np.ndarray,
    mask: Optional[np.ndarray] = None,
    cfg: LchfConfig = LchfConfig(),
    with_responses: bool = False,
    device=None,
) -> Optional[PatchFeature]:
    """constructEmbedding (+ optionally constructResponse) for one patch."""
    nz = depth > 0
    if not nz.any():
        return None
    device = resolve_device(device)
    center_dep = float(depth[nz].astype(np.float64).mean())

    q_rgb, mag = Q.quantize_color_gradient(_rgb_tensor(rgb, device), cfg.weak_threshold, phase=cfg.phase)
    rgb_feats = _extract_rgb_lchf(q_rgb.cpu().numpy(), mag.cpu().numpy(), mask, cfg)
    if rgb_feats is None:
        return None

    dep_t = _depth_tensor(depth, device)
    q_dep = Q.quantize_depth_normal(dep_t, cfg.distance_threshold, cfg.difference_threshold, cfg.focal)
    dep_feats = extract_depth_features(q_dep.cpu().numpy(), mask, cfg.num_features, cfg.extract_threshold)
    if dep_feats is None:
        return None
    dep_feats = dep_feats.copy()
    dep_feats[:, 2] += 8

    feats = np.concatenate([rgb_feats, dep_feats], 0)
    z_avg = mean_depth_5x5_tensor(dep_t).cpu().numpy()
    z_rel = center_dep - z_avg[feats[:, 1], feats[:, 0]]

    # The responses reuse the embedding's quantizations (the JAX code
    # quantizes the patch again in construct_response; the maps are the same).
    responses = _responses(q_rgb, q_dep, cfg).cpu().numpy() if with_responses else None
    return PatchFeature(
        features=feats,
        z_rel=z_rel.astype(np.float32),
        center_dep=center_dep,
        responses=responses,
        z_avg=z_avg if with_responses else None,
        shape=depth.shape,
    )


def _extract_rgb_lchf(quantized, magnitude, mask, cfg: LchfConfig):
    """Like extract_color_features but with lchf's scatter distance
    (candidates/num + 4, lchf.cpp:572)."""
    from scipy import ndimage

    if mask is not None:
        m = mask.astype(bool)
        eroded = ndimage.binary_erosion(m, structure=np.ones((3, 3), bool), border_value=1)
        border = m & ~eroded
    else:
        border = np.ones_like(quantized, dtype=bool)
    cand = border & (quantized > 0) & (magnitude > cfg.strong_threshold**2)
    ys, xs = np.nonzero(cand)
    if len(ys) < cfg.num_features:
        return None
    scores = magnitude[ys, xs]
    order = np.argsort(-scores, kind="stable")
    xs, ys, scores = xs[order], ys[order], scores[order]
    distance = len(xs) / cfg.num_features + 4.0
    sel = select_scattered_features(xs, ys, scores, cfg.num_features, distance)
    if sel is None:
        return None
    labels = np.log2(quantized[ys[sel], xs[sel]].astype(np.int32)).astype(np.int64)
    return np.stack([xs[sel], ys[sel], labels], axis=1)


def _responses(q_rgb: torch.Tensor, q_dep: torch.Tensor, cfg: LchfConfig) -> torch.Tensor:
    """(16, Hp, Wp) uint8 response maps of the (H, W) colour and depth
    quantizations, padded to multiples of 16 (lchf.cpp:658-713)."""
    h, w = q_dep.shape
    hp = -(-h // 16) * 16
    wp = -(-w // 16) * 16
    out = []
    for q in (q_rgb, q_dep):
        qp = torch.nn.functional.pad(q, (0, wp - w, 0, hp - h))
        out.append(compute_response_maps(spread_orientations(qp, cfg.spread_t), cfg.lut))
    return torch.cat(out, dim=0)


def construct_response_tensor(rgb: torch.Tensor, depth: torch.Tensor, cfg: LchfConfig) -> torch.Tensor:
    """(16, Hp, Wp) uint8 response maps of a (H, W, 3) uint8 and a (H, W)
    int32 tensor (lchf.cpp:658-713)."""
    q_rgb, _ = Q.quantize_color_gradient(rgb, cfg.weak_threshold, phase=cfg.phase)
    q_dep = Q.quantize_depth_normal(depth, cfg.distance_threshold, cfg.difference_threshold, cfg.focal)
    return _responses(q_rgb, q_dep, cfg)


def construct_response(rgb: np.ndarray, depth: np.ndarray, cfg: LchfConfig, device=None) -> np.ndarray:
    """(16, Hp, Wp) uint8 response maps, padded to multiples of 16
    (lchf.cpp:658-713), computed on ``device``."""
    device = resolve_device(device)
    return construct_response_tensor(_rgb_tensor(rgb, device), _depth_tensor(depth, device), cfg).cpu().numpy()


# ---------------------------------------------------------------------------
# Batched patch sets + similarity
# ---------------------------------------------------------------------------


class PatchSet:
    """Struct-of-arrays over M patches with uniform shapes.

    responses: (M, 16, P, P) uint8; z_avg: (M, P, P) float32;
    center: (M,) float32.  Used as the "other" side of similarity.
    """

    def __init__(self, responses, z_avg, center):
        self.responses = responses
        self.z_avg = z_avg
        self.center = center

    @classmethod
    def from_features(cls, feats: Sequence[PatchFeature]) -> "PatchSet":
        p = max(max(f.responses.shape[1] for f in feats), max(f.responses.shape[2] for f in feats))
        m = len(feats)
        resp = np.zeros((m, 16, p, p), np.uint8)
        zavg = np.zeros((m, p, p), np.float32)
        center = np.zeros((m,), np.float32)
        for i, f in enumerate(feats):
            _, hh, ww = f.responses.shape
            resp[i, :, :hh, :ww] = f.responses
            ah, aw = f.z_avg.shape
            zavg[i, :ah, :aw] = f.z_avg
            center[i] = f.center_dep
        return cls(resp, zavg, center)


def similarity_one_to_many(a: PatchFeature, others: PatchSet, idx: np.ndarray, z_check: float = 200.0) -> np.ndarray:
    """similarity(a -> others[idx]) for many others at once (numpy, float64;
    the host route).

    Faithful to lchf.cpp:716-792: coords scaled by center_a/center_j
    (integer floor), bounds checks against the DEPTH patch extent, z-gate,
    responses summed over both modalities, score/count/4*100 with count
    incl. gated (but in-bounds) features.
    """
    j = np.asarray(idx)
    cj = others.center[j]  # (J,)
    ok_j = (cj > 0) & (a.center_dep > 0)
    x = a.features[:, 0][None, :]  # (1, F)
    y = a.features[:, 1][None, :]
    c = a.features[:, 2][None, :]
    nx = (x * a.center_dep / np.maximum(cj[:, None], 1e-6)).astype(np.int64)
    ny = (y * a.center_dep / np.maximum(cj[:, None], 1e-6)).astype(np.int64)
    ph, pw = a.shape
    jh = others.z_avg.shape[1]
    jw = others.z_avg.shape[2]
    inb = (
        (y < ph) & (x < pw) & (ny < jh) & (nx < jw) & (ny >= 0) & (nx >= 0)
    )
    nxc = np.clip(nx, 0, jw - 1)
    nyc = np.clip(ny, 0, jh - 1)
    jj = np.broadcast_to(j[:, None], nxc.shape)
    z2 = cj[:, None] - others.z_avg[jj, nyc, nxc]
    valid = np.abs(a.z_rel[None, :] - z2) < z_check
    resp = others.responses[jj, np.broadcast_to(c, nxc.shape), nyc, nxc].astype(np.float32)
    score = np.where(inb & valid, resp, 0.0).sum(1)
    count = inb.sum(1)
    sim = np.where(count > 0, score / np.maximum(count, 1) / 4.0 * 100.0, 0.0)
    return np.where(ok_j, sim, 0.0)
