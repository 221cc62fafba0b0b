"""The device banks: a class's match-time and refine-time arrays as tensors.

``bank_levels_from_numpy`` takes the fields of a per-level bank
(``nfeat``, ``wh``, and ``feats`` and ``valid`` or ``kernels``, as numpy
arrays) and moves them to a device.  Both packages' ``BankLevel`` carry
those fields with the same layouts and dtypes (the JAX package's carries
kernels beside its lists, which the port does not read), and both read
and write the same npz (``TemplateBank.save`` / ``load``, the templates'
``infos`` included), so a bank built by either feeds the other.  ``refine_bank_from_numpy`` does the
same for the six arrays of a ``RefineBank``.

For several classes at once, the ``multiclass_*`` functions build the
superbanks of the multi-class matcher and of the fused multi-class frame
from the per-class arrays (class-major, padded to common shapes), as the
JAX package's ``MultiClassMatcher._build`` and ``FusedMultiClassPipeline``
do.

``multiscale_arrays`` builds the feature arrays of the multi-scale
matchers (one class or several) from template lists, as the
JAX package's ``MultiScaleDetector._feature_arrays`` and
``MultiScaleMultiClass._build`` do (``multiscale_bank_from_arrays`` moves
them to a device).

``lchf_tables_from_model`` builds the padded pivot-patch and per-tree node
tables of the LCHF forest walk (``lchf.device.DeviceForest``) from an
``LchfModel`` of either package, as the JAX ``DeviceForest`` does.

The segmentation path (``seg/``) has nothing to convert: it has no learned
parameters, and its model clouds are numpy arrays in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sixdpose_tpu_torch.models.templates import BankLevel
from sixdpose_tpu_torch.ops.similarity import build_template_kernels


@dataclasses.dataclass(frozen=True)
class DeviceBank:
    """Per pyramid level (level 0 first) device tensors of one class, of one
    of two kinds, as its numpy ``BankLevel``s are.

    nfeats:  (N,) int32 feature counts.
    whs:     (N, 2) int32 template (width, height).
    kdims:   (kh, kw) coarse extent of each level, which both kinds carry:
      (largest height + 1, largest width + 1), the dense kernels' extent.
    feats:   (N, F, 3) int32 padded (x, y, channel) feature lists, or None.
    valids:  (N, F) bool, or None.
    kernels: (N, C, KH, KW) int8 one-hot conv kernels, or None.

    A feature-list bank (``feats`` and ``valids``) is scored at the coarse
    level by ``ops.similarity.similarity_multiscale_auto`` and refined by
    the local-refine kernel.  A bank without feature lists, as the JAX
    package's ``Detector.device_bank`` triple is, carries kernels and takes
    the dense-kernel route: the coarse level by the dense conv and the
    refinement by the grouped conv of ``ops.similarity.similarity_local``.
    """

    nfeats: Tuple[torch.Tensor, ...]
    whs: Tuple[torch.Tensor, ...]
    kdims: Tuple[Tuple[int, int], ...]
    feats: Optional[Tuple[torch.Tensor, ...]] = None
    valids: Optional[Tuple[torch.Tensor, ...]] = None
    kernels: Optional[Tuple[torch.Tensor, ...]] = None

    @classmethod
    def from_kernels(cls, kernels: Sequence, nfeats: Sequence, whs: Sequence, device) -> "DeviceBank":
        """A bank without feature lists on ``device`` from the per-level
        (kernels, nfeats, whs) numpy arrays of the JAX package's
        ``Detector.device_bank``."""
        return cls(
            nfeats=tuple(_to(n, np.int32, device) for n in nfeats),
            whs=tuple(_to(w, np.int32, device) for w in whs),
            kdims=tuple(tuple(int(d) for d in np.shape(k)[-2:]) for k in kernels),
            kernels=tuple(_to(k, np.int8, device) for k in kernels),
        )

    def without_features(self) -> "DeviceBank":
        """The dense-kernel route's bank: ``convert.without_features`` of
        this bank's levels, on its device."""
        if self.feats is None:
            return self
        host = lambda ts: [t.cpu().numpy() for t in ts]  # noqa: E731
        levels = [BankLevel(nfeat=n, wh=w, kdims=d, feats=f, valid=v)
                  for n, w, d, f, v in zip(host(self.nfeats), host(self.whs), self.kdims, host(self.feats),
                                           host(self.valids))]
        return bank_levels_from_numpy(without_features(levels), self.nfeats[0].device)


def _to(a, dtype: np.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a), dtype=dtype)).to(device)


def level_kdims(b) -> Tuple[int, int]:
    """The coarse extent (kh, kw) of a numpy level of either package: the
    port's ``BankLevel`` carries it; the JAX package's level has none, and
    its kernels' extent is its extent."""
    return tuple(b.kdims) if isinstance(b, BankLevel) else tuple(int(d) for d in b.kernels.shape[-2:])


def _channels(feats: Sequence[np.ndarray], valids: Sequence[np.ndarray]) -> int:
    """Kernel channels of a bank's feature lists: 8 per modality (channel =
    modality * 8 + label).  Every extracted template has features of each
    of its detector's modalities at every level, so the largest channel
    names the last modality."""
    top = max((int(f[..., 2][v].max()) for f, v in zip(feats, valids) if v.any()), default=0)
    return 8 * (top // 8 + 1)


def bank_levels_from_numpy(levels: Sequence, device) -> DeviceBank:
    """Device bank from per-level numpy banks (a ``BankLevel`` of either
    package), of the levels' kind: a level with feature lists is a
    feature-list level, even where the JAX package's level carries kernels
    too; levels whose ``feats`` are None give a bank of kernels."""
    lists = levels[0].feats is not None
    return DeviceBank(
        nfeats=tuple(_to(b.nfeat, np.int32, device) for b in levels),
        whs=tuple(_to(b.wh, np.int32, device) for b in levels),
        kdims=tuple(level_kdims(b) for b in levels),
        feats=tuple(_to(b.feats, np.int32, device) for b in levels) if lists else None,
        valids=tuple(_to(b.valid, np.bool_, device) for b in levels) if lists else None,
        kernels=None if lists else tuple(_to(b.kernels, np.int8, device) for b in levels),
    )


def without_features(levels: Sequence) -> list:
    """A class's per-level numpy bank (either package's levels) as the
    dense-kernel route's bank: each level's kernels built from its feature
    lists at its extent (``build_template_kernels``), the lists dropped.
    This and ``DeviceBank.without_features`` are where a feature-list bank
    becomes a dense one."""
    c = _channels([b.feats for b in levels], [b.valid for b in levels])
    return [BankLevel(nfeat=b.nfeat, wh=b.wh, kdims=level_kdims(b),
                      kernels=build_template_kernels(b.feats, b.valid, *level_kdims(b), c)) for b in levels]


@dataclasses.dataclass(frozen=True)
class RefineBank:
    """Per-class device tensors of the fused refine stage
    (``models/pipeline.py``).

    clouds:  (N, P, 3) float32 template clouds (meters, render frame).
    valids:  (N, P) bool.
    chroma:  (N, P, 2) float32 lighting-normalized chroma, or None.
    src_c:   (N, 3) float32 cloud centroids.
    bbox_wh: (N, 2) int32 render bbox (w, h) at level 0.
    base_T:  (N, 4, 4) float32 template pose (cam_R_w2c | cam_t_w2c with
      the reference's z mm->m quirk, linemodLevelup.cpp:37).
    win:     (win_h, win_w) median window covering the largest bbox.
    """

    clouds: torch.Tensor
    valids: torch.Tensor
    chroma: Optional[torch.Tensor]
    src_c: torch.Tensor
    bbox_wh: torch.Tensor
    base_T: torch.Tensor
    win: Tuple[int, int]


def refine_bank_from_numpy(fields: Sequence, win: Tuple[int, int], device) -> RefineBank:
    """The refine bank on ``device`` from its six arrays as numpy, in the
    order of both packages' ``RefineBank`` fields: (clouds, valids, chroma
    or None, src_c, bbox_wh, base_T)."""
    clouds, valids, chroma, src_c, bbox_wh, base_T = fields
    return RefineBank(
        clouds=_to(clouds, np.float32, device),
        valids=_to(valids, np.bool_, device),
        chroma=_to(chroma, np.float32, device) if chroma is not None else None,
        src_c=_to(src_c, np.float32, device),
        bbox_wh=_to(bbox_wh, np.int32, device),
        base_T=_to(base_T, np.float32, device),
        win=(int(win[0]), int(win[1])),
    )


@dataclasses.dataclass(frozen=True)
class MultiClassBank:
    """Every class's bank as one superbank on a device.

    bank:    the per-class ``DeviceBank`` arrays concatenated class-major
      (global template ids), of the classes' kind: feature lists padded to
      their largest F, or kernels zero-padded to their largest (KH, KW);
      the extent is the classes' largest, per level.
    pad_map: (C, Nmax) int32 global id of each class's local template, -1
      past the class's count.
    nmax:    the largest class's template count.
    """

    bank: DeviceBank
    pad_map: torch.Tensor
    nmax: int


def multiclass_bank_from_numpy(per_class: Sequence[Sequence], device) -> MultiClassBank:
    """The superbank of the classes' per-level banks (``BankLevel``s of
    either package, one list per class in class order), on ``device``, of
    the levels' kind (``bank_levels_from_numpy``)."""
    counts = [levels[0].nfeat.shape[0] for levels in per_class]
    merged = []
    for l in range(len(per_class[0])):
        lv = [levels[l] for levels in per_class]
        khm, kwm = (max(level_kdims(b)[i] for b in lv) for i in (0, 1))
        cat = dict(nfeat=np.concatenate([b.nfeat for b in lv]), wh=np.concatenate([b.wh for b in lv]),
                   kdims=(khm, kwm))
        if lv[0].feats is not None:
            fm = max(b.feats.shape[1] for b in lv)
            cat["feats"] = np.concatenate([np.pad(b.feats, ((0, 0), (0, fm - b.feats.shape[1]), (0, 0))) for b in lv])
            cat["valid"] = np.concatenate([np.pad(b.valid, ((0, 0), (0, fm - b.valid.shape[1]))) for b in lv])
        else:
            cat["kernels"] = np.concatenate([
                np.pad(b.kernels, ((0, 0), (0, 0), (0, khm - b.kernels.shape[2]), (0, kwm - b.kernels.shape[3])))
                for b in lv
            ])
        merged.append(BankLevel(**cat))
    pad_map = np.full((len(counts), max(counts)), -1, np.int32)
    start = 0
    for ci, cnt in enumerate(counts):
        pad_map[ci, :cnt] = np.arange(start, start + cnt)
        start += cnt
    return MultiClassBank(bank_levels_from_numpy(merged, device), _to(pad_map, np.int32, device), max(counts))


def multiclass_refine_bank_from_numpy(per_class: Sequence[Tuple[Sequence, Tuple[int, int]]], device) -> RefineBank:
    """The global refine bank of several classes: each class's six
    ``RefineBank`` arrays and median window ``(fields, win)``, in class
    order, concatenated class-major (the global template order of
    ``multiclass_bank_from_numpy``), with the largest window of each side.
    Chroma is kept only if every class has it."""
    fields = [f for f, _ in per_class]
    has_chroma = all(f[2] is not None for f in fields)
    cat = [np.concatenate([f[i] for f in fields]) if i != 2 or has_chroma else None for i in range(6)]
    win = (max(w[0] for _, w in per_class), max(w[1] for _, w in per_class))
    return refine_bank_from_numpy(cat, win, device)


def multiclass_verify_points(pts: Sequence[np.ndarray], colors: Optional[Sequence[np.ndarray]], device):
    """Each class's verification points (P_c, 3) mm and, if every class has
    them, colours (P_c, 3), padded to the largest P: (points (C, P, 3)
    float32, valid (C, P) bool, colours (C, P, 3) float32 or None) on
    ``device``."""
    p_max = max(len(p) for p in pts)
    vp = np.zeros((len(pts), p_max, 3), np.float32)
    vv = np.zeros((len(pts), p_max), bool)
    vc = np.zeros((len(pts), p_max, 3), np.float32)
    has_colors = colors is not None and all(c is not None for c in colors)
    for ci, p in enumerate(pts):
        vp[ci, : len(p)] = p
        vv[ci, : len(p)] = True
        if has_colors:
            vc[ci, : len(p)] = colors[ci]
    return _to(vp, np.float32, device), _to(vv, np.bool_, device), _to(vc, np.float32, device) if has_colors else None


@dataclasses.dataclass(frozen=True)
class MultiScaleBank:
    """The feature arrays of the multi-scale matchers on a device, for one
    class or for several (class-major, global template ids), per pyramid
    level (level 0 first).

    feats:   (N, F, 3) int32 (x, y, channel), padded to the largest F.
    valids:  (N, F) bool.
    whs:     (N, 2) int32 template (width, height).
    kdims:   per level the static (kh, kw) that covers every template at the
      largest scale: ceil((max extent + 1) * max_scale).
    pad_map: (C, Nmax) int32 global id of each class's local template, -1
      past the class's count.
    cls_kb:  (C, 2) int32 each class's own coarse (khb, kwb) shift buckets.
    pad_kb:  the coarse maps' bottom/right padding in blocks, (khb - min
      class khb, kwb - min class kwb), so that one sweep covers every class's
      own anchors.
    """

    feats: Tuple[torch.Tensor, ...]
    valids: Tuple[torch.Tensor, ...]
    whs: Tuple[torch.Tensor, ...]
    kdims: Tuple[Tuple[int, int], ...]
    pad_map: torch.Tensor
    cls_kb: torch.Tensor
    pad_kb: Tuple[int, int]


def multiscale_arrays(per_class: Sequence[Sequence], max_scale: float, t_coarse: int) -> dict:
    """The numpy arrays of a ``MultiScaleBank`` from each class's templates
    (per class, per template, per level objects with ``features``,
    ``width`` and ``height``: a ``TemplateLevel`` of either package)."""
    counts = [len(tmpls) for tmpls in per_class]
    flat = [t for tmpls in per_class for t in tmpls]
    out = {"feats": [], "valids": [], "whs": [], "kdims": []}
    for l in range(len(flat[0])):
        fmax = max(len(t[l].features) for t in flat)
        fa = np.zeros((len(flat), fmax, 3), np.int32)
        va = np.zeros((len(flat), fmax), bool)
        wh = np.zeros((len(flat), 2), np.int32)
        for i, t in enumerate(flat):
            f = np.asarray(t[l].features)
            fa[i, : len(f)] = f
            va[i, : len(f)] = True
            wh[i] = (t[l].width, t[l].height)
        out["feats"].append(fa)
        out["valids"].append(va)
        out["whs"].append(wh)
        out["kdims"].append(_scaled_extent(wh, max_scale))
    pad_map = np.full((len(counts), max(counts)), -1, np.int32)
    cls_kb = np.zeros((len(counts), 2), np.int32)
    start = 0
    for ci, cnt in enumerate(counts):
        pad_map[ci, :cnt] = np.arange(start, start + cnt)
        kh, kw = _scaled_extent(out["whs"][-1][start : start + cnt], max_scale)
        cls_kb[ci] = (-(-kh // t_coarse), -(-kw // t_coarse))
        start += cnt
    kh, kw = out["kdims"][-1]
    out["pad_map"], out["cls_kb"] = pad_map, cls_kb
    out["pad_kb"] = (int(-(-kh // t_coarse) - cls_kb[:, 0].min()), int(-(-kw // t_coarse) - cls_kb[:, 1].min()))
    return out


def _scaled_extent(wh: np.ndarray, max_scale: float) -> Tuple[int, int]:
    """(kh, kw) covering templates of (width, height) ``wh`` at ``max_scale``."""
    return int(np.ceil((wh[:, 1].max() + 1) * max_scale)), int(np.ceil((wh[:, 0].max() + 1) * max_scale))


def multiscale_bank_from_arrays(a: dict, device) -> MultiScaleBank:
    """The ``MultiScaleBank`` of ``multiscale_arrays``' output on ``device``."""
    return MultiScaleBank(
        feats=tuple(_to(x, np.int32, device) for x in a["feats"]),
        valids=tuple(_to(x, np.bool_, device) for x in a["valids"]),
        whs=tuple(_to(x, np.int32, device) for x in a["whs"]),
        kdims=tuple(a["kdims"]),
        pad_map=_to(a["pad_map"], np.int32, device),
        cls_kb=_to(a["cls_kb"], np.int32, device),
        pad_kb=a["pad_kb"],
    )



@dataclasses.dataclass(frozen=True)
class LchfPivotTables:
    """The LCHF training patches as padded device tables (pivot side of the
    similarity).

    feats:  (N, F, 3) int32 (x, y, channel), zero past each patch's count.
    valid:  (N, F) bool.
    zrel:   (N, F) float32 relative depths.
    center: (N,) float32 patch center depths.
    shape:  (N, 2) int32 patch (height, width).
    """

    feats: torch.Tensor
    valid: torch.Tensor
    zrel: torch.Tensor
    center: torch.Tensor
    shape: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LchfTreeTables:
    """One tree's nodes: split pivot (N,) int64, threshold (N,) float32,
    leaf flag (N,) bool, children (N, 2) int64."""

    split: torch.Tensor
    thresh: torch.Tensor
    leaf: torch.Tensor
    child: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LchfTables:
    """Pivot tables shared by every tree, one node table per tree, and the
    number of walk steps (the trees' largest ``max_depth``)."""

    pivots: LchfPivotTables
    trees: Tuple[LchfTreeTables, ...]
    max_depth: int


def lchf_pivot_tables(patches: Sequence, device) -> LchfPivotTables:
    """Pivot tables of ``PatchFeature``s (either package's) on ``device``."""
    fmax = max(len(p.features) for p in patches)
    n = len(patches)
    feats = np.zeros((n, fmax, 3), np.int32)
    valid = np.zeros((n, fmax), bool)
    zrel = np.zeros((n, fmax), np.float32)
    centers = np.zeros((n,), np.float32)
    shapes = np.zeros((n, 2), np.int32)
    for i, p in enumerate(patches):
        f = len(p.features)
        feats[i, :f] = p.features
        valid[i, :f] = True
        zrel[i, :f] = p.z_rel
        centers[i] = p.center_dep
        shapes[i] = p.shape
    return LchfPivotTables(
        feats=_to(feats, np.int32, device),
        valid=_to(valid, np.bool_, device),
        zrel=_to(zrel, np.float32, device),
        center=_to(centers, np.float32, device),
        shape=_to(shapes, np.int32, device),
    )


def lchf_tables_from_model(model, device) -> LchfTables:
    """The forest walk's tables of an ``LchfModel`` (either package's) on
    ``device``."""
    trees = []
    for tree in model.forest.trees:
        nodes = tree.nodes
        trees.append(LchfTreeTables(
            split=_to([nd.split_feat_idx for nd in nodes], np.int64, device),
            thresh=_to([nd.simi_thresh for nd in nodes], np.float32, device),
            leaf=_to([nd.isleafnode for nd in nodes], np.bool_, device),
            child=_to(np.array([nd.cnodes for nd in nodes], np.int64).reshape(-1, 2), np.int64, device),
        ))
    return LchfTables(
        pivots=lchf_pivot_tables(model.patches, device),
        trees=tuple(trees),
        max_depth=max(t.max_depth for t in model.forest.trees),
    )
