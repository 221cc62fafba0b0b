"""Data-parallel fused frames over ranks: detection followed by ICP, the
fused multi-class detect -> refine -> verify frame, and the multi-scale
multi-class frame, each with its frames split over the mesh's ``data``
axis.

Port of the three programs of the JAX package's multi-device dry run
(``__graft_entry__.py::dryrun_multichip``) beyond matching: ``full_step``
(``sharded_detect``, then ICP per frame over ``data``), ``fused_mc_step``
(``detect_refine_multiclass_core`` over ``data``, the refine bank
replicated) and ``fused_ms_step`` (``multiscale_multiclass_core`` over
``data``).  The data axis carries no collective: each rank takes its frames
(``sharded_match.data_shard``) and runs the single-process code on each,
so a rank's frame equals that code's frame to the bit.  The ranks of one
data coordinate compute the same frames.  Outputs are this rank's shard;
``sharded_match.gather_data`` gives the full batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from sixdpose_tpu_torch.config import DetectorConfig, IcpConfig
from sixdpose_tpu_torch.convert import DeviceBank
from sixdpose_tpu_torch.models.multiscale import MultiScaleMultiClass, multiscale_multiclass_core
from sixdpose_tpu_torch.models.pipeline import FusedMultiClassPipeline
from sixdpose_tpu_torch.models.refine import backproject, icp_batch, scene_normals
from sixdpose_tpu_torch.parallel.sharded_match import data_shard, detect_shard


def _stacked(frames: list) -> tuple:
    """Per-frame output tuples as one tuple of (B_l, ...) tensors."""
    return tuple(torch.stack(a) for a in zip(*frames))


def sharded_detect_refine(
    mesh,
    rgb_batch,
    depth_batch,
    bank: DeviceBank,
    cfg: DetectorConfig,
    threshold: float,
    model_pts: torch.Tensor,
    model_valid: torch.Tensor,
    K: torch.Tensor,
    init_T: torch.Tensor,
    icp: IcpConfig,
):
    """``sharded_detect``, then ICP of every candidate of each of this
    rank's frames.

    Args:
      rgb_batch, depth_batch: (B, H, W, 3) uint8 and (B, H, W) depth in mm,
        the global batch (depth is needed: ICP runs against it).
      bank, cfg, threshold: as ``sharded_detect``.
      model_pts: (N, 3) float32 model points (meters); model_valid: (N,)
        bool; K: (3, 3) float32 camera; all on the bank's device.
      init_T: (top_k, 4, 4) float32, one initial pose per candidate slot,
        the same for every frame.
      icp: the ICP's ``corr_dist`` and ``max_iters`` (the rest at
        ``icp_batch``'s defaults, as the JAX program calls it).

    Returns this rank's data shard (tid, x, y, score, keep), each (B_l, K),
    T (B_l, K, 4, 4) and fitness (B_l, K).
    """
    rgb, dep = data_shard(mesh, rgb_batch, depth_batch, bank.nfeats[0].device)
    tid, x, y, score, keep = detect_shard(mesh, rgb, dep, bank, cfg, threshold)
    k = init_T.shape[0]
    pts = model_pts[None].expand(k, *model_pts.shape)
    valid = model_valid[None].expand(k, *model_valid.shape)
    refined = []
    for depth in dep:
        scene = backproject(depth, K)
        T, fitness, _ = icp_batch(pts, valid, scene, scene_normals(scene), K, init_T, icp.corr_dist, icp.max_iters)
        refined.append((T, fitness))
    T, fitness = _stacked(refined)
    return tid, x, y, score, keep, T, fitness


def fused_multiclass_over_data(mesh, rgb_batch, depth_batch, pipe: FusedMultiClassPipeline, threshold: float):
    """The fused multi-class frame (``FusedMultiClassPipeline``, whose
    superbank, refine bank and verification points every rank holds whole)
    on each of this rank's frames.

    Returns this rank's shard of the nine outputs stacked (B_l, C, R, ...):
    (tid_local, x, y, score, R, t_mm, fitness, verify, active).
    """
    rgb, dep = data_shard(mesh, rgb_batch, depth_batch, pipe.device)
    return _stacked([pipe(rgb[f], dep[f], threshold) for f in range(rgb.shape[0])])


def multiscale_multiclass_over_data(mesh, rgb_batch, depth_batch, ms: MultiScaleMultiClass, threshold: float,
                                    top_k: Optional[int] = None):
    """The multi-scale frame of every class (``multiscale_multiclass_core``
    over ``ms``'s superbank, with NMS) on each of this rank's frames,
    ``top_k`` candidates a class (the config's by default).

    Returns this rank's shard of the seven outputs stacked (B_l, C, K):
    (tid_local, x, y, score, keep, depth_mm, scale).
    """
    rgb, dep = data_shard(mesh, rgb_batch, depth_batch, ms.device)
    k = top_k or ms.cfg.top_k
    return _stacked([
        multiscale_multiclass_core(rgb[f], dep[f], ms.bank, ms.bin_scales, ms.cfg, float(threshold), ms.num_scales,
                                   k, True, ms.bins)
        for f in range(rgb.shape[0])
    ])
