"""Device-mesh helpers.

Port of the JAX package's ``parallel/mesh.py`` on ``torch.distributed``:
a mesh is a ``DeviceMesh`` over the ranks of the current process group,
one rank per mesh position.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "template", "tile")


def rank_device(device_type: str = "cuda", rank: Optional[int] = None) -> torch.device:
    """A rank's device: the CPU, or ``cuda:<local rank % device count>``
    (ranks may share a card).  The local rank is ``LOCAL_RANK`` when a
    launcher sets it, else ``rank``, else this process's global rank."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh asks for CUDA and no CUDA device is available")
    if "LOCAL_RANK" in os.environ:
        rank = int(os.environ["LOCAL_RANK"])
    elif rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(data: int = 1, template: int = 1, tile: int = 1, device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, template, tile) mesh over the first data * template * tile
    ranks of the process group (every rank must call it; a rank beyond
    them gets no coordinate).

    Collectives along ``template`` and ``tile`` run between neighbouring
    ranks and ``data`` is outermost, as in the JAX package's layout.
    ``device_type`` defaults to ``"cuda"``.
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize first")
    need = data * template * tile
    have = dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} ranks, have {have}")
    return DeviceMesh(device_type or "cuda", torch.arange(need).reshape(data, template, tile), mesh_dim_names=AXES)
