"""What one rank runs for the parallel entry points, as jobs for
``distributed.run_ranks``.

A job is a dict naming an entry point (``kind``: ``"sharded"``,
``"tiled"``, ``"multiscale"``, ``"detect_icp"``, ``"fused_mc"`` or
``"fused_ms"``), the mesh shape (data, template, tile) and the global
inputs as numpy arrays; ``run_jobs`` runs a list of them in turn on every
rank and returns, per job, the outputs as numpy (the full batch for the
kinds that split frames over ``data``), the rank's local-refine kernel
launches in the job's first step, the host seconds of its set-up (banks
and pipelines), of its first step and of the whole job, with ``reps`` the
step's milliseconds and those of its merge collective alone (CUDA events
on the card, the host clock on the CPU), and with ``profile`` on rank 0 of
a card mesh its device time per step (``utils.timing.device_ms_per_call``: the kernels'
time, the profiled wall time and kernels per step).  On the card each
result also carries ``peak_bytes``, the rank's peak of allocated device
memory in the job.  Ranks beyond a job's mesh return None for it.

Job keys: ``kind``, ``mesh``, ``cfg``, ``threshold``, ``rgb``, ``depth``
and optionally ``reps`` (timed steps after one warm-up), ``profile``
(profiled steps after them), and

- ``"sharded"``: ``levels``, the class's per-level numpy bank, or
  ``checkpoint`` (the directory of ``TemplateBank.save_checkpoint``) and
  ``class_id``: each rank restores its own template shard
  (``sharded_match.restore_local_levels``), and its result carries
  ``restore``: the seconds, the bytes it read, the restored numpy
  ``BankLevel``s and the seconds of the process's first import of
  ``torch.distributed.checkpoint`` (``import_s``, zero after the first);
- ``"tiled"``: ``levels``, or ``checkpoint`` and ``class_id`` (the whole
  class: the mesh's template size must be 1);
- ``"multiscale"``: ``arrays`` (``convert.multiscale_arrays`` of one
  class), ``train_depth``, ``num_scales`` and optionally ``bins``;
- ``"detect_icp"`` (``fused.sharded_detect_refine``): ``levels`` (or
  ``checkpoint`` and ``class_id``),
  ``model_pts`` (N, 3) m, optionally ``model_valid`` (N,), ``K`` (3, 3),
  ``init_T`` (top_k, 4, 4) and ``icp`` (an ``IcpConfig``);
- ``"fused_mc"`` (``fused.fused_multiclass_over_data``): ``class_ids``,
  ``templates`` (per class, per template, per level ``TemplateLevel``s),
  optionally ``infos`` (per class, per template, with the refine infos),
  ``K``, ``pipeline`` (the keyword arguments of ``FusedMultiClassPipeline``
  after the detector and the camera) and optionally ``refine`` (the
  global refine bank's six numpy arrays and window, in place of the one
  built from the infos);
- ``"fused_ms"`` (``fused.multiscale_multiclass_over_data``):
  ``class_ids``, ``templates``, ``train_depth``, ``num_scales`` and
  optionally ``top_k``.

The fused kinds ship their banks as the templates' numpy feature lists
(and infos), and each rank builds its ``Detector`` and pipeline from them
as a single process does: a fraction of the bytes of the dense per-level
kernels.  Their merge is ``sharded_match.gather_data``'s one
``all_gather`` over ``data``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from sixdpose_tpu_torch.convert import bank_levels_from_numpy, refine_bank_from_numpy
from sixdpose_tpu_torch.models.detector import Detector
from sixdpose_tpu_torch.models.multiscale import MultiScaleMultiClass
from sixdpose_tpu_torch.models.pipeline import FusedMultiClassPipeline
from sixdpose_tpu_torch.ops import local_refine as LR
from sixdpose_tpu_torch.ops.scale_proposal import bin_centers
from sixdpose_tpu_torch.parallel.fused import (
    fused_multiclass_over_data,
    multiscale_multiclass_over_data,
    sharded_detect_refine,
)
from sixdpose_tpu_torch.parallel.mesh import make_mesh, rank_device
from sixdpose_tpu_torch.parallel.sharded_match import (
    all_gather,
    gather_data,
    local_bank,
    local_multiscale_bank,
    restore_local_levels,
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


def _class_bank(mesh, job, dev):
    """The job's class bank on this rank: restored from its ``checkpoint``
    by ``run_jobs``, or this rank's template shard of its ``levels``."""
    return job["bank"] if "bank" in job else local_bank(mesh, job["levels"], dev)


def _restore(mesh, job, dev) -> dict:
    """This rank's bank of a job with a ``checkpoint``: the bank, and the
    seconds, bytes read and numpy levels of its restore, with the seconds
    of the process's first import of ``torch.distributed.checkpoint``
    apart (``import_s``)."""
    if job["kind"] == "tiled" and mesh.size(1) != 1:
        raise ValueError("a tiled job takes the whole bank: its mesh must not split templates")
    t0 = time.perf_counter()
    import sixdpose_tpu_torch.models.checkpoint  # noqa: F401
    t1 = time.perf_counter()
    levels, nbytes = restore_local_levels(mesh, job["checkpoint"], job["class_id"], job["cfg"])
    bank = bank_levels_from_numpy(levels, dev)
    return {"bank": bank, "seconds": time.perf_counter() - t1, "import_s": t1 - t0, "bytes_read": nbytes,
            "levels": levels}


def _sharded(mesh, job, dev):
    bank = _class_bank(mesh, job, dev)
    rgb, dep = _frames(job, dev)
    payload = ((rgb.shape[0] // mesh.size(0), 6, job["cfg"].top_k), "template")

    def step():
        return sharded_detect(mesh, rgb, dep, bank, job["cfg"], job["threshold"])

    return step, lambda out: gather_data(mesh, *out), lambda out: payload


def _tiled(mesh, job, dev):
    bank = job["bank"] if "bank" in job else bank_levels_from_numpy(job["levels"], dev)
    rgb, dep = _frames(job, dev)

    def step():
        return tiled_detect(mesh, rgb, dep, bank, job["cfg"], job["threshold"])

    return step, lambda out: out, lambda out: ((4, job["cfg"].top_k), "tile")


def _multiscale(mesh, job, dev):
    bank = local_multiscale_bank(mesh, job["arrays"], dev)
    rgb, dep = _frames(job, dev)
    bins = tuple(job.get("bins", (100, 400, 2000)))
    scales = torch.from_numpy((job["train_depth"] / bin_centers(*bins)).astype(np.float32)).to(dev)

    def step():
        return sharded_multiscale_detect(mesh, rgb, dep, bank, scales, job["cfg"], job["threshold"],
                                         job["num_scales"], bins)

    return step, lambda out: out, lambda out: ((8, job["cfg"].top_k), "template")


def _over_data(mesh, step):
    """The step, the full batch's gather and the gather's payload for a
    kind whose frames split over ``data``."""
    return (step, lambda out: gather_data(mesh, *out),
            lambda out: ((out[0].shape[0], sum(a[0].numel() for a in out)), "data"))


def _tensor(a, dtype, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


def _detect_icp(mesh, job, dev):
    bank = _class_bank(mesh, job, dev)
    rgb, dep = _frames(job, dev)
    pts = _tensor(job["model_pts"], np.float32, dev)
    valid = _tensor(job.get("model_valid", np.ones(len(pts), bool)), np.bool_, dev)
    K, init_T = _tensor(job["K"], np.float32, dev), _tensor(job["init_T"], np.float32, dev)

    def step():
        return sharded_detect_refine(mesh, rgb, dep, bank, job["cfg"], job["threshold"], pts, valid, K, init_T,
                                     job["icp"])

    return _over_data(mesh, step)


def _detector(job, dev) -> Detector:
    """The job's classes in a ``Detector`` on ``dev``."""
    det = Detector(job["cfg"], device=dev)
    infos = job.get("infos") or [[None] * len(t) for t in job["templates"]]
    for cid, templates, class_infos in zip(job["class_ids"], job["templates"], infos):
        for levels, info in zip(templates, class_infos):
            det.bank.add_template_levels(cid, levels, info)
    return det


def _fused_mc(mesh, job, dev):
    refine = job.get("refine")
    pipe = FusedMultiClassPipeline(_detector(job, dev), job["K"], job["class_ids"], device=dev,
                                   refine_bank=refine_bank_from_numpy(*refine, dev) if refine else None,
                                   **job["pipeline"])
    rgb, dep = _frames(job, dev)
    return _over_data(mesh, lambda: fused_multiclass_over_data(mesh, rgb, dep, pipe, job["threshold"]))


def _fused_ms(mesh, job, dev):
    ms = MultiScaleMultiClass(_detector(job, dev), job["train_depth"], job["class_ids"], job["num_scales"],
                              device=dev)
    rgb, dep = _frames(job, dev)
    return _over_data(mesh, lambda: multiscale_multiclass_over_data(mesh, rgb, dep, ms, job["threshold"],
                                                                   job.get("top_k")))


KINDS = {"sharded": _sharded, "tiled": _tiled, "multiscale": _multiscale, "detect_icp": _detect_icp,
         "fused_mc": _fused_mc, "fused_ms": _fused_ms}


def run_jobs(rank: int, world: int, device_type: str, jobs: list) -> list:
    """Run ``jobs`` in turn on this rank (the target of ``run_ranks``).
    Jobs of one mesh shape share its ``DeviceMesh``: over NCCL on four
    cards, ranks holding six meshes' communicators hung in
    ``destroy_process_group`` after their last job."""
    dev = rank_device(device_type, rank)
    results = []
    meshes = {}  # one mesh, and one set of communicators, a shape
    for job in jobs:
        shape = tuple(job["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device_type=device_type)
        mesh = meshes[shape]
        res = None
        if mesh.get_coordinate() is not None:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            restore = _restore(mesh, job, dev) if "checkpoint" in job else None
            if restore:
                job = dict(job, bank=restore.pop("bank"))
            step, gather, merge = KINDS[job["kind"]](mesh, job, dev)
            t1 = time.perf_counter()
            LR.similarity_local_sparse_cuda.launches = 0
            out = step()
            launches = LR.similarity_local_sparse_cuda.launches
            res = {
                "outputs": tuple(a.cpu().numpy() for a in gather(out)),
                "launches": launches,
                "coordinate": tuple(mesh.get_coordinate()),
                "setup_s": t1 - t0,
                "first_step_s": time.perf_counter() - t1,
            }
            if restore:
                res["restore"] = restore
            if job.get("reps"):
                shape, axis = merge(out)
                payload = torch.zeros(shape, dtype=torch.float64, device=dev)
                res["ms"] = ms_per_call(step, job["reps"], dev)
                res["merge_ms"] = ms_per_call(lambda: all_gather(payload, mesh, axis), job["reps"], dev)
            if job.get("profile") and dev.type == "cuda":  # every rank steps; rank 0 under the profiler
                if rank == 0:
                    res["profile"] = device_ms_per_call(step, job["profile"])
                else:
                    for _ in range(job["profile"]):
                        step()
            if dev.type == "cuda":
                res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            res["job_s"] = time.perf_counter() - t0
        dist.barrier()
        results.append(res)
    return results
