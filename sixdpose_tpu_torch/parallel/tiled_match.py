"""Spatial (tile) sharding of detection with halo exchange.

Port of the JAX package's ``parallel/tiled_match.py`` on
``torch.distributed``.  The frame splits into row slabs over the ``tile``
mesh axis; each rank extends its slab by a halo of raw pixels from its
neighbours (rows past the image's top and bottom are zeros, not the
border), runs the whole detection on the extended slab, keeps only the
candidates whose origin row it owns, and the ranks merge their top K with
one ``all_gather``.

The halo moves as raw pixels, as in the JAX package: 4 or 5 bytes a pixel
against the 16 response channels, and the recompute of quantization over
the halo costs little.  It moves by one ``all_gather`` of every slab's top
and bottom bands, where the JAX package hops whole slabs around a
``ppermute`` ring: gloo cannot send a CUDA tensor point to point (ranks
sharing a card) but gathers one, and NCCL gathers as well.
"""

from __future__ import annotations

import torch

from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.convert import DeviceBank
from sixdpose_tpu_torch.models.detector import _image, detect_frame_core
from sixdpose_tpu_torch.parallel.sharded_match import _coordinate, _pack, all_gather, merge_topk


def required_halo(cfg: DetectorConfig, kh0: int) -> int:
    """Rows of context a tile needs beyond its slab on each side.

    Bottom: a placement whose origin row is owned may read down the
    template extent at level 0 (kh0) plus the 16-placement refinement
    window (16 * t0); top: the refinement may move an origin up by
    8 * t0.  Both plus the quantization neighborhood (blur/sobel/normals/
    median ~ 16 px) and pyramid rounding.
    """
    t0 = cfg.t_at_level[0]
    quant = 16
    down = kh0 + 16 * t0 + quant
    up = 8 * t0 + quant
    pow2 = 2 ** (cfg.pyramid_levels - 1)
    h = max(down, up)
    return -(-h // pow2) * pow2  # multiple of the pyramid factor


def _halo_window(x: torch.Tensor, mesh, halo: int, hops: int) -> torch.Tensor:
    """Rows ``[i * slab - halo, (i + 1) * slab + halo)`` of the frame around
    slab ``x`` of tile ``i`` (zeros past the frame's edges), from one
    ``all_gather`` of each slab's top and bottom ``min(halo, slab)`` rows
    (whole slabs when the halo spans ``hops`` > 1 of them)."""
    _, _, i = _coordinate(mesh)
    n, slab = mesh.size(2), x.shape[0]
    band = min(halo, slab)
    bands = all_gather(torch.stack([x[:band], x[slab - band :]]), mesh, "tile")  # (n, 2, band, ...)
    zero = torch.zeros_like(x[:band])
    up = torch.cat([bands[j, 1] if j >= 0 else zero for j in range(i - hops, i)])[band * hops - halo :]
    down = torch.cat([bands[j, 0] if j < n else zero for j in range(i + 1, i + hops + 1)])[:halo]
    return torch.cat([up, x, down])


def tiled_detect(
    mesh,
    rgb,
    depth,
    bank: DeviceBank,
    cfg: DetectorConfig,
    threshold: float,
):
    """Detect one frame with its rows split over the mesh axis ``tile``.

    Args:
      rgb: (H, W, 3) uint8, the whole frame (array or tensor); each rank
        takes its slab. H divisible by the tile size.
      depth: (H, W) depth in mm, or None when the depth modality is off.
      bank: the whole class bank (the template axis is not split here), on
        the rank's device, with or without feature lists.

    Returns (tid, x, y, score), each (top_k,) and the same on every rank of
    the tile group: merged candidates in frame coordinates, score sorted
    descending (-1 on dead slots).
    """
    tidx = _coordinate(mesh)[2]
    n_tile = mesh.size(2)
    dev = bank.nfeats[0].device
    h = rgb.shape[0]
    if h % n_tile:
        raise ValueError(f"{h} rows do not divide over {n_tile} tiles")
    slab = h // n_tile
    halo = min(required_halo(cfg, bank.kdims[0][0]), slab * (n_tile - 1))
    hops = -(-halo // slab)  # slabs the halo spans
    rows = slice(tidx * slab, (tidx + 1) * slab)

    def with_halo(a, dtype):
        s = _image(a[rows], dtype, dev)
        return _halo_window(s, mesh, halo, hops) if halo else s

    rgb_h = with_halo(rgb, torch.uint8)
    dep_h = with_halo(depth, torch.int32) if depth is not None else None
    tid, x, y, score, _ = detect_frame_core(rgb_h, dep_h, bank, cfg, threshold, apply_nms=False)
    # Frame coordinates; keep only origins inside this rank's slab.
    own = (y >= halo) & (y < halo + slab) & (score >= 0)
    score = torch.where(own, score, torch.full_like(score, -1.0))
    fields = _pack([tid, x, y - halo + tidx * slab, score], dim=0)
    merged = merge_topk(all_gather(fields, mesh, "tile"), cfg.top_k)
    return tuple(merged[i].to(torch.int32) for i in range(3)) + (merged[3].to(torch.float32),)
