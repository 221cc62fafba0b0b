"""Sharded detection: data-parallel frames x template-parallel bank.

Port of the JAX package's ``parallel/sharded_match.py`` on
``torch.distributed``.  Every rank holds one position of a (data, template,
tile) mesh (``parallel.mesh.make_mesh``) and takes its part of the global
inputs by its coordinate:

- the frame batch splits over ``data`` (independent frames, no
  communication);
- the template bank splits over ``template`` (``shard_bank``; the last
  shard padded with all-zero templates whose ``nfeat`` is 1, so they never
  reach the threshold).  Each rank scores and refines its own sub-bank, then
  the ranks of a ``template`` group exchange their K candidates with one
  ``all_gather`` and keep the top K of the S * K in shard order, ties to the
  lower flat index (``jax.lax.top_k``'s order), before box NMS on the merged
  set.  The payload is K candidates per shard, never a similarity map.

A rank can also take its template shard straight from a bank checkpoint
(``restore_local_bank``: ``TemplateBank.save_checkpoint``'s directory),
reading its own rows only.

Each candidate travels with its template's level-0 (width, height), so the
NMS boxes need no gathered template table.  The fields of a candidate
(int32 and float32) travel as one float64 tensor, which holds both exactly.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.convert import (
    DeviceBank,
    MultiScaleBank,
    bank_levels_from_numpy,
    multiscale_arrays,
    multiscale_bank_from_arrays,
)
from sixdpose_tpu_torch.models.detector import _image, detect_frame_core
from sixdpose_tpu_torch.models.multiscale import multiscale_multiclass_core
from sixdpose_tpu_torch.models.templates import BankLevel
from sixdpose_tpu_torch.ops.scale_proposal import bin_centers
from sixdpose_tpu_torch.ops.similarity import build_template_kernels
from sixdpose_tpu_torch.ops.topk_nms import nms_boxes


def pad_templates(arrays: Tuple[np.ndarray, ...], shards: int):
    """Pad the template axis (axis 0) of bank arrays with zeros to a
    multiple of ``shards``."""
    out = []
    for a in arrays:
        pad = (-a.shape[0]) % shards
        if pad:
            a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)], 0)
        out.append(a)
    return tuple(out)


def _rows(a: np.ndarray, shards: int, index: int) -> np.ndarray:
    n_local = a.shape[0] // shards
    return a[index * n_local : (index + 1) * n_local]


def shard_bank(levels: Sequence, shards: int, index: int, device) -> DeviceBank:
    """Shard ``index`` of ``shards`` of a class's per-level bank (numpy
    ``BankLevel``s of either package) on ``device``: templates
    ``[index * n_local, (index + 1) * n_local)`` of the bank padded to a
    multiple of ``shards``, padded templates all zero with ``nfeat`` 1."""
    out = []
    for b in levels:
        kern, wh, feats, valid = pad_templates(
            tuple(np.asarray(a) for a in (b.kernels, b.wh, b.feats, b.valid)), shards
        )
        nf = np.asarray(b.nfeat)
        nf = np.concatenate([nf, np.ones((-len(nf)) % shards, nf.dtype)])
        out.append(BankLevel(*(_rows(a, shards, index) for a in (kern, nf, wh, feats, valid))))
    return bank_levels_from_numpy(out, device)


def shard_multiscale_bank(arrays: dict, shards: int, index: int, device) -> MultiScaleBank:
    """Shard ``index`` of ``shards`` of one class's multi-scale arrays
    (``convert.multiscale_arrays`` of a single class) on ``device``.  The
    rows are sliced as ``shard_bank`` slices them (padded templates have
    no valid feature); the kernel extents and coarse buckets stay the whole
    class's, so every shard scores the same placements."""
    if len(arrays["pad_map"]) != 1:
        raise ValueError("shard_multiscale_bank takes the arrays of one class")
    cut = {}
    for key in ("feats", "valids", "whs"):
        cut[key] = [_rows(a, shards, index) for a in pad_templates(tuple(arrays[key]), shards)]
    n_local = cut["feats"][0].shape[0]
    return multiscale_bank_from_arrays(
        {**arrays, **cut, "pad_map": np.arange(n_local, dtype=np.int32)[None]}, device
    )


def local_bank(mesh, levels: Sequence, device) -> DeviceBank:
    """This rank's template shard of a class's per-level bank."""
    return shard_bank(levels, mesh.size(1), _coordinate(mesh)[1], device)


def restore_local_levels(mesh, path: str, class_id: str, cfg: DetectorConfig) -> Tuple[List[BankLevel], int]:
    """This rank's template shard of class ``class_id`` of a bank checkpoint
    (``TemplateBank.save_checkpoint`` at ``path``), as numpy ``BankLevel``s
    in ``shard_bank``'s layout, and the bytes the rank read.

    The rank reads its rows of ``feats`` (its ``Shard(0)`` block over
    ``template``, as ``load_checkpoint(mesh=...)`` places it, into a plain
    tensor) and the class's whole ``valid`` and ``whp``, which are small:
    each level's kernel extent and feature count are the whole class's, as
    ``TemplateBank.finalized`` builds them.  ``Shard(0)`` splits as
    ``torch.chunk`` does, in blocks of ``ceil(N / shards)``: the rows of
    ``shard_bank``'s shard, whose padding (zero templates with ``nfeat`` 1)
    fills the rest of the block."""
    from sixdpose_tpu_torch.models import checkpoint as CK  # torch.distributed.checkpoint: 1-2 s to import

    arrays = os.path.join(path, "arrays")
    shapes = CK.class_shapes(arrays, class_id)
    valid_key, whp_key, feats_key = (CK.key(class_id, n) for n in ("valid", "whp", "feats"))
    first, rows, block = CK.shard_rows(shapes[feats_key][0][0], mesh)
    got, nbytes = CK.read_arrays(arrays, shapes, {feats_key: (first, rows)})
    valid, whp, feats = (got[k].numpy() for k in (valid_key, whp_key, feats_key))
    mine = slice(first, first + rows)
    out = []
    for l in range(cfg.pyramid_levels):
        counts = valid[:, l].sum(-1).astype(np.int32)
        fmax = int(counts.max())
        f = np.zeros((block, fmax, 3), np.int32)
        v = np.zeros((block, fmax), bool)
        nfeat = np.ones((block,), np.int32)
        wh = np.zeros((block, 2), np.int32)
        f[:rows], v[:rows] = feats[:, l, :fmax], valid[mine, l, :fmax]
        nfeat[:rows], wh[:rows] = counts[mine], whp[mine, l, :2]
        kern = build_template_kernels(f, v, int(whp[:, l, 1].max()) + 1, int(whp[:, l, 0].max()) + 1,
                                      8 * cfg.num_modalities)
        out.append(BankLevel(kernels=kern, nfeat=nfeat, wh=wh, feats=f, valid=v))
    return out, nbytes


def restore_local_bank(mesh, path: str, class_id: str, cfg: DetectorConfig, device) -> DeviceBank:
    """This rank's template shard of class ``class_id`` of a bank checkpoint
    on ``device``, built from the rows the rank reads
    (``restore_local_levels``): equal to ``local_bank(mesh,
    bank.finalized(class_id), device)`` of the saved bank."""
    return bank_levels_from_numpy(restore_local_levels(mesh, path, class_id, cfg)[0], device)


def local_multiscale_bank(mesh, arrays: dict, device) -> MultiScaleBank:
    """This rank's template shard of one class's multi-scale arrays."""
    return shard_multiscale_bank(arrays, mesh.size(1), _coordinate(mesh)[1], device)


def multiscale_class_arrays(templates: Sequence, train_depth: float, t_coarse: int,
                            bins: Tuple[int, int, int] = (100, 400, 2000)) -> dict:
    """``convert.multiscale_arrays`` of one class's templates for the depth
    bins of a bank trained at ``train_depth`` mm, as ``MultiScaleDetector``
    builds them (the input of ``shard_multiscale_bank``)."""
    max_scale = float((train_depth / bin_centers(*bins)).astype(np.float32).max())
    return multiscale_arrays([templates], max_scale, t_coarse)


def _coordinate(mesh):
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank holds no position of the mesh")
    return coord


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(n, *x.shape): ``x`` of every rank of this rank's ``axis`` group, in
    mesh order."""
    out = torch.empty((mesh.size(mesh.mesh_dim_names.index(axis)),) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=mesh.get_group(axis))
    return out


def _pack(fields, dim: int) -> torch.Tensor:
    """int32 and float32 fields stacked as float64, which holds both
    exactly."""
    return torch.stack([f.to(torch.float64) for f in fields], dim=dim)


def merge_topk(fields: torch.Tensor, k: int) -> torch.Tensor:
    """Top ``k`` of the candidates of every shard: ``fields`` is
    ([B,] S, R, K), R fields per candidate (tid, x, y, score, ...);
    returns ([B,] R, k), ordered by score descending with ties to the lower
    flat index over (S, K) (``jax.lax.top_k``'s order)."""
    s, r, kk = fields.shape[-3:]
    flat = fields.movedim(-3, -2).reshape(*fields.shape[:-3], r, s * kk)
    order = torch.sort(flat[..., 3, :], dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(flat, -1, order.unsqueeze(-2).expand(*flat.shape[:-1], k))


def sharded_detect(
    mesh,
    rgb_batch,
    depth_batch,
    bank: DeviceBank,
    cfg: DetectorConfig,
    threshold: float,
):
    """Detect over a batch of frames on a (data, template[, tile]) mesh.

    Args:
      rgb_batch: (B, H, W, 3) uint8 (array or tensor), the global batch; B
        divisible by the mesh's data size.
      depth_batch: (B, H, W) depth in mm, or None (matched as zeros).
      bank: this rank's template shard (``shard_bank`` with the mesh's
        template size and this rank's template coordinate), on the rank's
        device.

    Returns this rank's data shard (tid, x, y, score, keep), each (B_l, K)
    on the bank's device: tid in global template ids, score sorted
    descending (-1 on dead slots), keep the NMS survivors.
    """
    rgb, dep = data_shard(mesh, rgb_batch, depth_batch, bank.kernels[0].device)
    return detect_shard(mesh, rgb, dep, bank, cfg, threshold)


def detect_shard(mesh, rgb: torch.Tensor, depth: Optional[torch.Tensor], bank: DeviceBank, cfg: DetectorConfig,
                 threshold: float):
    """``sharded_detect`` of this rank's frames (``data_shard``'s)."""
    t_idx = _coordinate(mesh)[1]
    if depth is None:
        depth = torch.zeros(rgb.shape[:3], dtype=torch.int32, device=rgb.device)
    tid, x, y, score, _ = detect_frame_core(rgb if cfg.use_color else None, depth, bank, cfg, threshold,
                                            apply_nms=False)
    wh = bank.whs[0][tid.long()]
    n_local = bank.kernels[0].shape[0]
    fields = _pack([tid + t_idx * n_local, x, y, score, wh[..., 0], wh[..., 1]], dim=-2)
    merged = merge_topk(all_gather(fields, mesh, "template").movedim(0, 1), cfg.top_k)  # (B_l, 6, K)
    mtid, mx, my, mw, mh = (merged[:, i].to(torch.int32) for i in (0, 1, 2, 4, 5))
    mscore = merged[:, 3].to(torch.float32)
    boxes = torch.stack([mx, my, mw, mh], dim=-1).to(torch.float32)
    return mtid, mx, my, mscore, nms_boxes(boxes, mscore, cfg.nms_iou)


def data_shard(mesh, rgb_batch, depth_batch, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """This rank's frames of a global batch that splits over ``data``: rgb
    (B_l, H, W, 3) uint8 and depth (B_l, H, W) int32 (None without a depth
    batch) on ``device``.  The ranks of one data coordinate take the same
    frames, as JAX's ``P("data")`` replicates them over the other axes."""
    d_idx = _coordinate(mesh)[0]
    n_data = mesh.size(0)
    b = rgb_batch.shape[0]
    if b % n_data:
        raise ValueError(f"batch {b} does not divide over {n_data} data shards")
    part = slice(d_idx * (b // n_data), (d_idx + 1) * (b // n_data))
    rgb = _image(rgb_batch[part], torch.uint8, device)
    return rgb, _image(depth_batch[part], torch.int32, device) if depth_batch is not None else None


def gather_data(mesh, *shards: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The full-batch outputs (B, ...) from each rank's data shard (B_l,
    ...), on every rank.  The shards travel as one float64 tensor, which
    holds int32, float32 and bool exactly: one ``all_gather`` a call."""
    b_l = shards[0].shape[0]
    full = all_gather(torch.cat([s.reshape(b_l, -1).to(torch.float64) for s in shards], dim=1), mesh, "data")
    full = full.flatten(0, 1)
    out, at = [], 0
    for s in shards:
        n = s[0].numel()
        out.append(full[:, at : at + n].reshape(-1, *s.shape[1:]).to(s.dtype))
        at += n
    return tuple(out)


def sharded_multiscale_detect(
    mesh,
    rgb,
    depth,
    bank: MultiScaleBank,
    bin_scales: torch.Tensor,
    cfg: DetectorConfig,
    threshold: float,
    num_scales: int,
    bins: Tuple[int, int, int] = (100, 400, 2000),
):
    """Multi-scale detection of one class with its templates sharded over
    ``template``.  Each rank runs ``multiscale_multiclass_core`` (proposals,
    the scaled coarse sweep, scaled refinement) over its shard
    (``shard_multiscale_bank``), then the shards' top-K merge as in
    ``sharded_detect`` and box NMS runs on the merged set with each box
    ``round(wh0 * scale)``.

    Args:
      rgb: (H, W, 3) uint8 or None; depth: (H, W) depth in mm.
      bin_scales: (NB,) float32 feature scale of each depth bin, on the
        bank's device.

    Returns (tid, x, y, score, keep, depth_mm, scale), each (K,) and the
    same on every rank, tid in global template ids.
    """
    _, t_idx, _ = _coordinate(mesh)
    dev = bank.feats[0].device
    out = multiscale_multiclass_core(
        _image(rgb, torch.uint8, dev), _image(depth, torch.int32, dev), bank, bin_scales, cfg, threshold,
        num_scales, cfg.top_k, apply_nms=False, bins=bins,
    )
    tid, x, y, score, _, dmm, scale = (a[0] for a in out)
    wh = bank.whs[0][tid.long()]
    n_local = bank.feats[0].shape[0]
    fields = _pack([tid + t_idx * n_local, x, y, score, dmm, scale, wh[:, 0], wh[:, 1]], dim=0)
    merged = merge_topk(all_gather(fields, mesh, "template"), cfg.top_k)  # (8, K)
    mtid, mx, my = (merged[i].to(torch.int32) for i in range(3))
    mscore, md, msc = (merged[i].to(torch.float32) for i in (3, 4, 5))
    wh_sel = torch.round(merged[6:8].to(torch.float32).T * msc[:, None])
    boxes = torch.cat([mx[:, None].to(torch.float32), my[:, None].to(torch.float32), wh_sel], dim=1)
    return mtid, mx, my, mscore, nms_boxes(boxes, mscore, cfg.nms_iou), md, msc
