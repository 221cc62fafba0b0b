"""The template bank's array checkpoint on ``torch.distributed.checkpoint``.

The counterpart of the orbax directory of the JAX package's
``TemplateBank.save_orbax`` / ``load_orbax``: a bank checkpoint is a
directory with

- ``arrays/``: a DCP checkpoint of each class's padded arrays
  (``TemplateBank.to_padded_arrays``: ``feats`` (N, L, F, 3) int32,
  ``valid`` (N, L, F) bool, ``whp`` (N, L, 3) int32), under the keys
  ``<class>/feats``, ``<class>/valid`` and ``<class>/whp``;
- ``meta.json``: the classes in order, the infos and the config's ``repr``.

Every array is stored in blocks of ``ROWS_PER_BLOCK`` templates, so a rank
that restores its template shard reads the blocks that hold its rows and no
others.  Each rank plans its own reads (DCP's ``no_dist``, and
``RowsPlanner`` for a block of rows into a plain tensor): no collective
runs, so a read crosses no process group (gloo aborts a rank that sends a
CUDA tensor point to point), and a rank outside a mesh takes no part in its
ranks' reads.  Only ``TemplateBank.load_checkpoint(mesh=...)`` makes
DTensors, and a process's first DTensor costs about a second of imports
(``torch._dynamo``), so a rank's restore of its own shard makes none.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import DefaultLoadPlanner, DefaultSavePlanner, FileSystemReader, FileSystemWriter
from torch.distributed.checkpoint.metadata import ChunkStorageMetadata, MetadataIndex, TensorProperties
from torch.distributed.checkpoint.planner import LoadPlan, SavePlan, TensorWriteData, WriteItem, WriteItemType
from torch.distributed.checkpoint.planner_helpers import create_read_items_for_chunk_list

ARRAYS = ("feats", "valid", "whp")
ROWS_PER_BLOCK = 16
# DCP warns on every planned-per-rank read or write; nothing is amiss.
_NO_DIST_WARNING = "torch.distributed is disabled, unavailable or uninitialized"


class RowBlockPlanner(DefaultSavePlanner):
    """Writes each tensor of a flat state dict as blocks of ``rows`` rows
    (dimension 0), each block a chunk of its own in the checkpoint."""

    def __init__(self, rows: int):
        super().__init__()
        self.rows = rows

    def create_local_plan(self) -> SavePlan:
        items = []
        for fqn, t in self.state_dict.items():
            props = TensorProperties.create_from_tensor(t)
            for r0 in range(0, t.shape[0], self.rows):
                offsets = torch.Size((r0,) + (0,) * (t.dim() - 1))
                sizes = torch.Size((min(self.rows, t.shape[0] - r0),) + tuple(t.shape[1:]))
                items.append(WriteItem(
                    index=MetadataIndex(fqn, offsets), type=WriteItemType.SHARD,
                    tensor_data=TensorWriteData(ChunkStorageMetadata(offsets, sizes), props, t.size()),
                ))
        self.plan = SavePlan(items, planner_data=self.mappings)
        return self.plan

    def resolve_data(self, write_item: WriteItem) -> torch.Tensor:
        r0 = write_item.index.offset[0]
        # A copy: torch.save of a view would write its whole storage.
        return self.state_dict[write_item.index.fqn][r0 : r0 + write_item.tensor_data.chunk.sizes[0]].clone()


class RowsPlanner(DefaultLoadPlanner):
    """Reads into each tensor of a flat state dict the rows ``[first, first
    + len(tensor))`` of the stored array of its key (``first``: key -> first
    row; 0 for keys it does not name)."""

    def __init__(self, first: Dict[str, int]):
        super().__init__()
        self.first = first

    def create_local_plan(self) -> LoadPlan:
        items = []
        for fqn, t in self.state_dict.items():
            offsets = torch.Size((self.first.get(fqn, 0),) + (0,) * (t.dim() - 1))
            items += create_read_items_for_chunk_list(fqn, self.metadata.state_dict_metadata[fqn],
                                                      [ChunkStorageMetadata(offsets, t.size())])
        return LoadPlan(items)

    def lookup_tensor(self, index: MetadataIndex) -> torch.Tensor:
        return self.state_dict[index.fqn]  # the block of rows that starts at index.offset


class CountingReader(FileSystemReader):
    """A ``FileSystemReader`` that counts the bytes of the stored chunks it
    reads (``bytes_read``)."""

    def __init__(self, path: str):
        super().__init__(path)
        self.bytes_read = 0
        self._metadata = None

    def read_metadata(self):
        self._metadata = super().read_metadata()
        return self._metadata

    def read_data(self, plan, planner):
        stored = {item.storage_index for item in plan.items}
        self.bytes_read += sum(self._metadata.storage_data[s].length for s in stored)
        return super().read_data(plan, planner)


def key(class_id: str, name: str) -> str:
    return f"{class_id}/{name}"


def save_arrays(path: str, arrays: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Write ``arrays`` (class -> name -> numpy array) as a DCP checkpoint
    at ``path``, in blocks of ``ROWS_PER_BLOCK`` rows."""
    state = {key(cid, name): torch.from_numpy(np.ascontiguousarray(a))
             for cid, named in arrays.items() for name, a in named.items()}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_NO_DIST_WARNING)
        dcp.save(state, storage_writer=FileSystemWriter(path), planner=RowBlockPlanner(ROWS_PER_BLOCK), no_dist=True)


def stored_shapes(path: str) -> Dict[str, tuple]:
    """(shape, dtype) of every array of the checkpoint at ``path``."""
    md = FileSystemReader(path).read_metadata().state_dict_metadata
    return {fqn: (tuple(m.size), m.properties.dtype) for fqn, m in md.items()}


def template_placements(mesh) -> list:
    """``Shard(0)`` on the mesh's ``template`` dimension, replicated over
    the others (the JAX package's ``NamedSharding(mesh, P("template"))``)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == "template" else Replicate() for name in mesh.mesh_dim_names]


def read_arrays(path: str, shapes: Dict[str, tuple], rows: Optional[Dict[str, tuple]] = None) -> tuple:
    """Read the arrays ``shapes`` names (key -> ``stored_shapes``' entry)
    of the checkpoint at ``path`` as CPU tensors: whole, or the rows
    ``[first, first + n)`` of the keys ``rows`` maps to ``(first, n)``.
    Returns ({key: tensor}, bytes of the stored chunks read)."""
    rows = rows or {}
    out = {k: torch.empty((rows[k][1],) + shape[1:] if k in rows else shape, dtype=dtype)
           for k, (shape, dtype) in shapes.items()}
    reader = CountingReader(path)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_NO_DIST_WARNING)
        dcp.load(out, storage_reader=reader, planner=RowsPlanner({k: r[0] for k, r in rows.items()}), no_dist=True)
    return out, reader.bytes_read


def read_sharded(path: str, shapes: Dict[str, tuple], mesh) -> dict:
    """The arrays ``shapes`` names as DTensors of ``template_placements``:
    this rank reads its ``shard_rows`` block of each, which goes to the
    mesh's device type."""
    from torch.distributed.tensor import DTensor

    blocks = {k: shard_rows(shape[0], mesh)[:2] for k, (shape, _) in shapes.items()}
    local, _ = read_arrays(path, shapes, blocks)
    return {k: DTensor.from_local(local[k], mesh, template_placements(mesh), run_check=False,
                                  shape=torch.Size(shape), stride=torch.empty(shape, device="meta").stride())
            for k, (shape, _) in shapes.items()}


def shard_rows(n: int, mesh) -> tuple:
    """(first row, rows, block) of this rank's ``Shard(0)`` block of ``n``
    rows over ``template``: blocks of ``ceil(n / shards)`` rows in order
    (``torch.chunk``'s), so the last ranks may hold fewer rows, or none."""
    dim = mesh.mesh_dim_names.index("template")
    block = -(-n // mesh.size(dim))
    first = min(mesh.get_coordinate()[dim] * block, n)
    return first, min(block, n - first), block


def gather_rows(t, mesh) -> torch.Tensor:
    """The whole array of a ``template_placements`` DTensor, on every rank
    of its template group: each rank's rows, padded to the block size, go
    as bytes through one ``all_gather`` over ``template``."""
    n = t.shape[0]
    _, rows, block = shard_rows(n, mesh)
    local = t.to_local()
    padded = torch.zeros((block,) + tuple(local.shape[1:]), dtype=local.dtype, device=local.device)
    padded[:rows] = local
    raw = padded.reshape(block, -1).view(torch.uint8)
    group = mesh.get_group("template")
    parts = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    return torch.cat(parts).view(local.dtype).reshape((-1,) + tuple(local.shape[1:]))[:n]


def class_shapes(path: str, class_id: str) -> Dict[str, tuple]:
    """``stored_shapes`` of one class's three arrays."""
    shapes = stored_shapes(path)
    if key(class_id, ARRAYS[0]) not in shapes:
        raise KeyError(f"no class {class_id!r} in the checkpoint at {path}")
    return {key(class_id, name): shapes[key(class_id, name)] for name in ARRAYS}
