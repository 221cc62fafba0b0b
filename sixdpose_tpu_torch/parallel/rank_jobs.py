"""What one rank runs for the parallel entry points, as jobs for
``distributed.run_ranks``.

A job is a dict naming an entry point (``kind``: ``"sharded"``,
``"tiled"`` or ``"multiscale"``), the mesh shape (data, template, tile) and
the global inputs as numpy arrays; ``run_jobs`` runs a list of them in
turn on every rank and returns, per job, the outputs as numpy (the full
batch for ``"sharded"``), the rank's local-refine kernel launches in the
job's first step, with ``reps`` the step's milliseconds and those of its
merge collective alone (CUDA events on the card, the host clock on the
CPU), and with ``profile`` on rank 0 of a card mesh its device time per
step (``utils.timing.device_ms_per_call``: the kernels' time, the profiled
wall time and kernels per step).  Ranks beyond a job's mesh return None
for it.

Job keys: ``kind``, ``mesh``, ``cfg``, ``threshold``, ``rgb``, ``depth``
and optionally ``reps`` (timed steps after one warm-up), ``profile``
(profiled steps after them), and

- ``"sharded"``: ``levels``, the class's per-level numpy bank;
- ``"tiled"``: ``levels``;
- ``"multiscale"``: ``arrays`` (``convert.multiscale_arrays`` of one
  class), ``train_depth``, ``num_scales`` and optionally ``bins``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from sixdpose_tpu_torch.convert import bank_levels_from_numpy
from sixdpose_tpu_torch.ops import local_refine as LR
from sixdpose_tpu_torch.ops.scale_proposal import bin_centers
from sixdpose_tpu_torch.parallel.mesh import make_mesh, rank_device
from sixdpose_tpu_torch.parallel.sharded_match import (
    all_gather,
    gather_data,
    local_bank,
    local_multiscale_bank,
    sharded_detect,
    sharded_multiscale_detect,
)
from sixdpose_tpu_torch.parallel.tiled_match import tiled_detect
from sixdpose_tpu_torch.utils.timing import device_ms_per_call, ms_per_call


def _frames(job, dev):
    """The job's global frames on the rank's device (each rank uploads them
    once and takes its part there)."""
    rgb = torch.from_numpy(np.ascontiguousarray(job["rgb"], np.uint8)).to(dev)
    dep = job.get("depth")
    return rgb, torch.from_numpy(dep.astype(np.int32)).to(dev) if dep is not None else None


def _sharded(mesh, job, dev):
    bank = local_bank(mesh, job["levels"], dev)
    rgb, dep = _frames(job, dev)
    payload = ((rgb.shape[0] // mesh.size(0), 6, job["cfg"].top_k), "template")

    def step():
        return sharded_detect(mesh, rgb, dep, bank, job["cfg"], job["threshold"])

    return step, lambda out: gather_data(mesh, *out), payload


def _tiled(mesh, job, dev):
    bank = bank_levels_from_numpy(job["levels"], dev)
    rgb, dep = _frames(job, dev)

    def step():
        return tiled_detect(mesh, rgb, dep, bank, job["cfg"], job["threshold"])

    return step, lambda out: out, ((4, job["cfg"].top_k), "tile")


def _multiscale(mesh, job, dev):
    bank = local_multiscale_bank(mesh, job["arrays"], dev)
    rgb, dep = _frames(job, dev)
    bins = tuple(job.get("bins", (100, 400, 2000)))
    scales = torch.from_numpy((job["train_depth"] / bin_centers(*bins)).astype(np.float32)).to(dev)

    def step():
        return sharded_multiscale_detect(mesh, rgb, dep, bank, scales, job["cfg"], job["threshold"],
                                         job["num_scales"], bins)

    return step, lambda out: out, ((8, job["cfg"].top_k), "template")


KINDS = {"sharded": _sharded, "tiled": _tiled, "multiscale": _multiscale}


def run_jobs(rank: int, world: int, device_type: str, jobs: list) -> list:
    """Run ``jobs`` in turn on this rank (the target of ``run_ranks``)."""
    dev = rank_device(device_type, rank)
    results = []
    for job in jobs:
        mesh = make_mesh(*job["mesh"], device_type=device_type)
        res = None
        if mesh.get_coordinate() is not None:
            step, gather, (shape, axis) = KINDS[job["kind"]](mesh, job, dev)
            LR.similarity_local_sparse_cuda.launches = 0
            out = step()
            launches = LR.similarity_local_sparse_cuda.launches
            res = {
                "outputs": tuple(a.cpu().numpy() for a in gather(out)),
                "launches": launches,
                "coordinate": tuple(mesh.get_coordinate()),
            }
            if job.get("reps"):
                payload = torch.zeros(shape, dtype=torch.float64, device=dev)
                res["ms"] = ms_per_call(step, job["reps"], dev)
                res["merge_ms"] = ms_per_call(lambda: all_gather(payload, mesh, axis), job["reps"], dev)
            if job.get("profile") and dev.type == "cuda":  # every rank steps; rank 0 under the profiler
                if rank == 0:
                    res["profile"] = device_ms_per_call(step, job["profile"])
                else:
                    for _ in range(job["profile"]):
                        step()
        dist.barrier()
        results.append(res)
    return results
