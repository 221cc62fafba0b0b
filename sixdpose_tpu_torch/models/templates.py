"""Template extraction and the template bank.

Port of the JAX package's ``models/templates.py``.  Reference behaviour
(linemodLevelup.cpp):

- ``ColorGradientPyramid::extractTemplate`` (cpp:589-643): candidates are
  strong-magnitude quantized pixels on the 1-px eroded border of the mask,
  stable-sorted by magnitude and greedily thinned by
  ``selectScatteredFeatures`` (cpp:279-318) with a relaxing min-distance.
- ``DepthNormalPyramid::extractTemplate`` (cpp:888-966): interior pixels
  scored by the chessboard distance transform of their orientation's
  region, normalized by per-label counts.
- ``cropTemplates`` (cpp:234-277): all levels and modalities of a template
  shift to a common bounding box.

Extraction is host-side numpy and scipy; only the quantization runs on a
device.  The npz bank format is the JAX package's, so one bank file feeds
both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy import ndimage

from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.ops import quantize as Q


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

    Returns indices of the selected candidates, or None if impossible.
    """
    n = len(xs)
    if n < num_features:
        return None
    xs = [int(v) for v in xs]
    ys = [int(v) for v in ys]
    selected: List[int] = []
    dist = float(distance)
    dist_sq = dist * dist
    i = 0
    guard = 0
    while len(selected) < num_features:
        keep = True
        for j in selected:
            dx = xs[i] - xs[j]
            dy = ys[i] - ys[j]
            if dx * dx + dy * dy < dist_sq:
                keep = False
                break
        if keep:
            # Once the distance relaxes to <= 0 already-selected candidates
            # pass too, which guarantees termination (as in the reference).
            selected.append(i)
        i += 1
        if i == n:
            i = 0
            dist -= 1.0
            dist_sq = dist * dist
            guard += 1
            if guard > 10000:
                return None
    return np.array(selected, dtype=np.int64)


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


def extract_template(
    rgb: np.ndarray,
    depth: Optional[np.ndarray],
    mask: np.ndarray,
    cfg: DetectorConfig,
    device=None,
) -> Optional[List[TemplateLevel]]:
    """Extract one multi-level template (reference Detector::addTemplate,
    cpp:1943-1975), quantizing on ``device``: CUDA by default, raising when
    there is none; pass ``device="cpu"`` to run on the CPU.  Returns None if
    any level finds too few features (the reference returns -1)."""
    device = resolve_device(device)
    color_levels = None
    if cfg.use_color:
        color_levels = []
        cur = torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.uint8)).to(device)
        for l in range(cfg.pyramid_levels):
            if l > 0:
                cur = Q.pyr_down_rgb(cur)
            q, mag = Q.quantize_color_gradient(cur, cfg.color.weak_threshold)
            color_levels.append((q.cpu().numpy(), mag.cpu().numpy()))

    depth_levels = None
    if cfg.use_depth and depth is not None:
        d = torch.from_numpy(np.asarray(depth).astype(np.int32)).to(device)
        qs = Q.depth_normal_pyramid(
            d,
            cfg.pyramid_levels,
            cfg.depth.distance_threshold,
            cfg.depth.difference_threshold,
            cfg.depth.focal,
        )
        depth_levels = [q.cpu().numpy() for q in qs]

    return extract_template_from_quantized(color_levels, depth_levels, mask, cfg)


@dataclasses.dataclass
class BankLevel:
    """Match-time arrays for one (class, pyramid level), numpy, of one of
    two kinds fixed when the level is made.  A feature-list level
    (``TemplateBank.finalized``) carries ``feats`` and ``valid`` and no
    kernels; a dense level (``convert.without_features``) carries
    ``kernels`` and no lists.

    nfeat:   (N,) int32 total feature count (for score normalization).
    wh:      (N, 2) int32 template (width, height) at this level.
    kdims:   (kh, kw) coarse extent, (largest height + 1, largest width +
      1) of the whole class: the dense kernels' extent.
    feats:   (N, F, 3) int32 padded (x, y, channel) feature lists, or None.
    valid:   (N, F) bool, or None with ``feats``.
    kernels: (N, C, KH, KW) int8 one-hot conv kernels, or None.
    """

    nfeat: np.ndarray
    wh: np.ndarray
    kdims: Tuple[int, int]
    feats: Optional[np.ndarray] = None
    valid: Optional[np.ndarray] = None
    kernels: Optional[np.ndarray] = None


class TemplateBank:
    """Per-class template store with padded match-time arrays, saved as npz
    (the reference's templates_%s.yml.gz, cpp:2013-2146)."""

    def __init__(self, cfg: DetectorConfig):
        self.cfg = cfg
        self.templates: Dict[str, List[List[TemplateLevel]]] = {}
        self.infos: Dict[str, List[dict]] = {}
        self._finalized: Dict[str, List[BankLevel]] = {}
        self.shards: Dict[str, Dict[str, torch.Tensor]] = {}  # DTensors of load_checkpoint(mesh=...)

    # -- train-time ---------------------------------------------------------

    def add_template(
        self,
        class_id: str,
        rgb: np.ndarray,
        depth: Optional[np.ndarray],
        mask: np.ndarray,
        info: Optional[dict] = None,
        device=None,
    ) -> int:
        """Extract and store one template; returns its id or -1.  Quantizes
        on ``device``, CUDA by default (see ``extract_template``)."""
        tl = extract_template(rgb, depth, mask, self.cfg, device)
        if tl is None:
            return -1
        return self.add_template_levels(class_id, tl, info)

    def add_template_levels(
        self, class_id: str, levels: List[TemplateLevel], info: Optional[dict] = None
    ) -> int:
        """Store a pre-extracted template (e.g. deserialized)."""
        self.templates.setdefault(class_id, []).append(levels)
        self.infos.setdefault(class_id, []).append(info or {})
        self._finalized.pop(class_id, None)
        return len(self.templates[class_id]) - 1

    def num_templates(self, class_id: Optional[str] = None) -> int:
        if class_id is not None:
            return len(self.templates.get(class_id, []))
        return sum(len(v) for v in self.templates.values())

    def class_ids(self) -> List[str]:
        return list(self.templates.keys())

    # -- match-time ---------------------------------------------------------

    def finalized(self, class_id: str) -> List[BankLevel]:
        """Per-level feature-list arrays for matching (built once, cached);
        they hold no kernels."""
        if class_id not in self._finalized:
            self._finalized[class_id] = self._build(class_id)
        return self._finalized[class_id]

    def _build(self, class_id: str) -> List[BankLevel]:
        tmpls = self.templates[class_id]
        n = len(tmpls)
        out = []
        for l in range(self.cfg.pyramid_levels):
            fmax = max(len(t[l].features) for t in tmpls)
            feats = np.zeros((n, fmax, 3), np.int32)
            valid = np.zeros((n, fmax), bool)
            nfeat = np.zeros((n,), np.int32)
            wh = np.zeros((n, 2), np.int32)
            for i, t in enumerate(tmpls):
                f = t[l].features
                feats[i, : len(f)] = f
                valid[i, : len(f)] = True
                nfeat[i] = len(f)
                wh[i] = (t[l].width, t[l].height)
            kdims = (int(wh[:, 1].max()) + 1, int(wh[:, 0].max()) + 1)
            out.append(BankLevel(nfeat=nfeat, wh=wh, kdims=kdims, feats=feats, valid=valid))
        return out

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the bank as one npz, in the JAX package's format."""
        payload = {"__classes__": np.array(self.class_ids(), dtype=object)}
        payload["__config__"] = np.array([repr(self.cfg)], dtype=object)
        for cid in self.class_ids():
            for i, tl in enumerate(self.templates[cid]):
                for l, lev in enumerate(tl):
                    key = f"{cid}|{i}|{l}"
                    payload[f"f|{key}"] = lev.features
                    payload[f"m|{key}"] = np.array([lev.width, lev.height, lev.pyramid_level])
            payload[f"info|{cid}"] = np.array(self.infos[cid], dtype=object)
        np.savez_compressed(path, **payload)

    def to_padded_arrays(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Per class: dense padded arrays keyed by (template, level).

        feats: (N, L, F, 3) int32; valid: (N, L, F) bool;
        whp: (N, L, 3) int32 (width, height, pyramid_level).
        """
        out = {}
        for cid in self.class_ids():
            tmpls = self.templates[cid]
            n = len(tmpls)
            levels = max(len(t) for t in tmpls)
            fmax = max(len(lev.features) for t in tmpls for lev in t)
            feats = np.zeros((n, levels, fmax, 3), np.int32)
            valid = np.zeros((n, levels, fmax), bool)
            whp = np.zeros((n, levels, 3), np.int32)
            for i, t in enumerate(tmpls):
                for l, lev in enumerate(t):
                    f = len(lev.features)
                    feats[i, l, :f] = lev.features
                    valid[i, l, :f] = True
                    whp[i, l] = (lev.width, lev.height, lev.pyramid_level)
            out[cid] = {"feats": feats, "valid": valid, "whp": whp}
        return out

    def save_checkpoint(self, path: str) -> None:
        """Checkpoint the bank as a directory that restores onto a template
        mesh: the JAX package's ``save_orbax``, on
        ``torch.distributed.checkpoint`` (``models/checkpoint.py``).  Infos
        go to ``meta.json`` as JSON, arrays as lists."""
        from sixdpose_tpu_torch.models import checkpoint as CK  # torch.distributed.checkpoint: 1-2 s to import

        path = os.path.abspath(path)
        CK.save_arrays(os.path.join(path, "arrays"), self.to_padded_arrays())
        meta = {
            "classes": self.class_ids(),
            "infos": {cid: self.infos[cid] for cid in self.class_ids()},
            "config": repr(self.cfg),
        }
        with open(os.path.join(path, "meta.json"), "w") as fh:
            # dumps, not dump: the same text, by the C encoder (dump streams through the Python one).
            fh.write(json.dumps(meta, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)))

    @classmethod
    def load_checkpoint(cls, path: str, cfg: DetectorConfig, mesh=None) -> "TemplateBank":
        """Restore a bank written by ``save_checkpoint``: the JAX package's
        ``load_orbax``.

        ``mesh``: optional (data, template, tile) ``DeviceMesh``
        (``parallel.mesh.make_mesh``).  With it, every class's arrays
        restore as DTensors sharded over ``template`` (dimension 0) and
        replicated over the other axes, each rank reading its own rows; they
        stay on the bank as ``shards`` (class -> name -> DTensor), and the
        templates are gathered from them over ``template``, so every rank of
        the mesh must call.  Infos come back as JSON gives them (arrays as
        lists), as from ``load_orbax``.
        """
        from sixdpose_tpu_torch.models import checkpoint as CK

        path = os.path.abspath(path)
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        arrays = os.path.join(path, "arrays")
        shapes = CK.stored_shapes(arrays)
        keys = {CK.key(cid, name): shapes[CK.key(cid, name)] for cid in meta["classes"] for name in CK.ARRAYS}
        sharded = mesh is not None
        tensors = CK.read_sharded(arrays, keys, mesh) if sharded else CK.read_arrays(arrays, keys)[0]
        bank = cls(cfg)
        for cid in meta["classes"]:
            feats, valid, whp = (
                (CK.gather_rows(t, mesh) if sharded else t).cpu().numpy()
                for t in (tensors[CK.key(cid, name)] for name in CK.ARRAYS)
            )
            infos = meta["infos"].get(cid, [])
            for i in range(feats.shape[0]):
                levels = [
                    TemplateLevel(features=feats[i, l, : valid[i, l].sum()].copy(), width=int(whp[i, l, 0]),
                                  height=int(whp[i, l, 1]), pyramid_level=int(whp[i, l, 2]))
                    for l in range(feats.shape[1])
                ]
                bank.add_template_levels(cid, levels, infos[i] if i < len(infos) else {})
        if sharded:
            bank.shards = {cid: {name: tensors[CK.key(cid, name)] for name in CK.ARRAYS} for cid in meta["classes"]}
        return bank

    @classmethod
    def load(cls, path: str, cfg: DetectorConfig) -> "TemplateBank":
        """Read an npz written by ``save`` (of either package)."""
        bank = cls(cfg)
        with np.load(path, allow_pickle=True) as z:
            classes = list(z["__classes__"])
            groups: Dict[str, Dict[int, Dict[int, TemplateLevel]]] = {}
            for key in z.files:
                if not key.startswith("f|"):
                    continue
                _, rest = key.split("|", 1)
                cid, i, l = rest.rsplit("|", 2)
                meta = z[f"m|{rest}"]
                groups.setdefault(cid, {}).setdefault(int(i), {})[int(l)] = TemplateLevel(
                    features=z[key],
                    width=int(meta[0]),
                    height=int(meta[1]),
                    pyramid_level=int(meta[2]),
                )
            for cid in classes:
                infos = list(z[f"info|{cid}"])
                for i in sorted(groups.get(cid, {})):
                    levels = [groups[cid][i][l] for l in sorted(groups[cid][i])]
                    bank.add_template_levels(cid, levels, infos[i] if i < len(infos) else {})
        return bank
