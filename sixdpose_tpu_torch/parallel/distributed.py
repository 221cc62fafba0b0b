"""Process-group initialization, rank launching and scaling measurement.

Port of the JAX package's ``parallel/distributed.py`` on
``torch.distributed``.  The JAX package runs one controller over every
device; here each mesh position is a process (a rank) and the collectives
run between processes.  ``initialize`` makes the process group (a group of
one for a single process, so the same program runs from one rank to N),
``run_ranks`` starts the ranks of one host and collects what each returns,
and ``measure_scaling`` times a step over growing data meshes.

The backend is chosen by a fixed rule, never by trying: NCCL when the ranks
run on CUDA and each has a card of its own, gloo when they run on the CPU
or share cards (NCCL refuses two ranks on one card).  A rank never changes
backend or device after a failure.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sixdpose_tpu_torch.parallel.mesh import make_mesh, rank_device
from sixdpose_tpu_torch.utils.timing import ms_per_call


def backend_for(device_type: str, ranks_on_host: int) -> str:
    """``"nccl"`` when the ``ranks_on_host`` CUDA ranks of this host each
    have a card of their own, else ``"gloo"``."""
    if device_type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device_type: str = "cuda",
    backend: Optional[str] = None,
) -> str:
    """Make the default process group; returns its backend.

    Arguments left out come from the launcher's environment (``torchrun``
    sets ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``);
    without either, the process is a group of one (an in-memory store).
    ``backend`` defaults to ``backend_for`` of this host's ranks:
    ``LOCAL_WORLD_SIZE`` when the launcher sets it, else the whole world.
    """
    if dist.is_initialized():
        return dist.get_backend()
    env = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"]) if env else 1
    if rank is None:
        rank = int(os.environ["RANK"]) if env else 0
    backend = backend or backend_for(device_type, int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda", rank))
        if backend == "nccl":
            kw["device_id"] = rank_device("cuda", rank)  # NCCL binds the rank to its card
    if init_method is None and not env and world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank, **kw)
    return backend


def global_mesh(template: int = 1, tile: int = 1, device_type: Optional[str] = None):
    """A mesh over every rank: the data axis takes what the template and
    tile factors leave."""
    n = dist.get_world_size()
    return make_mesh(data=max(n // (template * tile), 1), template=template, tile=tile, device_type=device_type)


def _rank_main(rank, world, init_method, device_type, backend, threads, out_dir):
    torch.set_num_threads(threads)
    try:
        with open(os.path.join(out_dir, "job.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        initialize(init_method, world, rank, device_type, backend)
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        err = os.path.join(out_dir, f"rank{rank}.err")
        with open(err, "w") as f:
            f.write(f"rank {rank} of {world} failed first:\n{traceback.format_exc()}")
        try:  # the first rank to fail links its traceback, before it leaves the group and its peers fail in turn
            os.link(err, os.path.join(out_dir, "first_failure"))
        except FileExistsError:
            pass
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(
    fn: Callable,
    world: int,
    args: Sequence = (),
    device_type: str = "cuda",
    backend: Optional[str] = None,
    timeout: float = 300.0,
    threads: int = 1,
) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes of this
    host, each a rank of one process group, and return their results in
    rank order.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function).  The
    ranks read them, and meet, through files in a fresh temporary directory
    (a process start blocks on what its pipe carries), use
    ``threads`` torch threads each, and run on ``device_type``: CUDA by
    default (ranks on ``cuda:<rank % device count>``), raising
    ``RuntimeError`` before any rank starts when there is no CUDA device;
    ``"cpu"`` for the CPU.  They talk over ``backend``
    (``backend_for(device_type, world)`` by default).  A rank that raises,
    dies or is still running after ``timeout`` seconds ends every rank and
    raises ``RuntimeError``, with the traceback of the first rank that
    raised (its peers then fail in their collectives).
    """
    if device_type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"run_ranks asks for {device_type!r} and no CUDA device is available; "
                           "pass device_type='cpu' for the CPU")
    ctx = mp.get_context("spawn")
    backend = backend or backend_for(device_type, world)
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [
            ctx.Process(target=_rank_main, args=(r, world, init, device_type, backend, threads, tmp))
            for r in range(world)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            pending = procs
            while pending and time.monotonic() < deadline:
                wait([p.sentinel for p in pending], timeout=deadline - time.monotonic())
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                pending = [p for p in procs if p.exitcode is None]
        finally:
            alive = [r for r, p in enumerate(procs) if p.exitcode is None]
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        first = os.path.join(tmp, "first_failure")
        if os.path.exists(first):
            with open(first) as f:
                raise RuntimeError(f.read())
        died = [r for r, p in enumerate(procs) if r not in alive and p.exitcode != 0]
        if died:
            raise RuntimeError(f"rank {died[0]} of {world} died with exit code {procs[died[0]].exitcode}")
        if alive:
            raise RuntimeError(f"ranks {alive} of {world} still running after {timeout} s; all were ended")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def measure_scaling(step_fn, args_for, sizes, warmup: int = 1, iters: int = 5, device_type: str = "cuda"):
    """Throughput scaling across data meshes of the given sizes.

    Every rank calls it; for each size the first ``size`` ranks form a data
    mesh (``make_mesh(data=size)``), build their inputs with
    ``args_for(mesh)`` and run ``step_fn(mesh, *args)`` ``warmup`` times,
    then ``iters`` times under the clock: CUDA events on the rank's card,
    the host clock on the CPU.  The other ranks wait at a barrier.

    Returns this rank's ``{size: {"s_per_step", "efficiency"}}`` for the
    sizes it took part in (rank 0 takes part in all).  ``args_for`` is
    meant to hold the work per rank constant (weak scaling), so linear
    scaling keeps the seconds per step: efficiency is the smallest size's
    seconds per step over this size's, 1.0 when linear.  (The JAX package's
    ``measure_scaling`` returns this times the size ratio, the speedup.)
    """
    results = {}
    base = None
    for size in sizes:
        mesh = make_mesh(data=size, device_type=device_type)
        if mesh.get_coordinate() is not None:
            args = args_for(mesh)
            for _ in range(warmup):
                step_fn(mesh, *args)
            dist.barrier(group=mesh.get_group("data"))
            dt = ms_per_call(lambda: step_fn(mesh, *args), iters, rank_device(device_type)) / 1e3
            if base is None:
                base = dt
            results[size] = {"s_per_step": dt, "efficiency": base / dt}
        dist.barrier()
    return results
