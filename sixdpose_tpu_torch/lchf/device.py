"""The device route of LCHF similarity: training matrix and forest walk.

Port of the JAX package's ``lchf/device.py``.  ``predict_scene`` with
``on_device=True`` walks each tree level-synchronously on the device:
every ROI carries its node id, and each of ``max_depth`` steps gathers its
own pivot patch's features, evaluates the similarity and moves to the
chosen child (leaves loop on themselves), with no readback between levels.
``similarity_matrix_device`` computes the whole pivots x targets matrix of
forest training, in blocks of pivots so that one block's gather stays
small; every row is independent, so the blocking changes no bit.

Semantics of feature.similarity_one_to_many (lchf.cpp:716-792), in float32
as the JAX jit route computes them: ratio = ca / max(cj, 1e-6), then
x * ratio, then score / max(count, 1) / 4 * 100, every divisor a tensor.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sixdpose_tpu_torch.convert import LchfPivotTables, lchf_pivot_tables, lchf_tables_from_model
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.lchf.feature import PatchFeature, PatchSet

# Gather elements (pivot rows x targets x features) per block of the
# training matrix: about 64 MB per float32 temporary.
_BLOCK_ELEMENTS = 1 << 24


class _Targets:
    """The target side of the similarity (a ``PatchSet``) on a device."""

    def __init__(self, roi_set: PatchSet, device):
        self.responses = torch.from_numpy(np.ascontiguousarray(roi_set.responses, np.uint8)).to(device)
        self.z_avg = torch.from_numpy(np.ascontiguousarray(roi_set.z_avg, np.float32)).to(device)
        self.center = torch.from_numpy(np.ascontiguousarray(roi_set.center, np.float32)).to(device)


def similarity_rows(
    piv: LchfPivotTables, pivot: torch.Tensor, targets: _Targets, rows: torch.Tensor, z_check: float
) -> torch.Tensor:
    """similarity(patches[pivot[r]] -> targets[rows[r]]) for every r: (R,)
    float32, elementwise in R."""
    f3 = piv.feats[pivot]  # (R, F, 3)
    zr = piv.zrel[pivot]
    ca = piv.center[pivot]  # (R,)
    sh = piv.shape[pivot]  # (R, 2)
    cj = targets.center[rows]  # (R,)
    jh, jw = targets.z_avg.shape[1:]
    x = f3[..., 0].to(torch.float32)
    y = f3[..., 1].to(torch.float32)
    c = f3[..., 2].to(torch.int64)
    ratio = (ca / torch.clamp(cj, min=1e-6))[:, None]
    nx = (x * ratio).to(torch.int32)
    ny = (y * ratio).to(torch.int32)
    inb = (
        piv.valid[pivot]
        & (y < sh[:, 0:1]) & (x < sh[:, 1:2])
        & (ny < jh) & (nx < jw) & (ny >= 0) & (nx >= 0)
    )
    nxc = nx.clamp(0, jw - 1).to(torch.int64)
    nyc = ny.clamp(0, jh - 1).to(torch.int64)
    rr = rows[:, None]
    z2 = cj[:, None] - targets.z_avg[rr, nyc, nxc]
    z_ok = (zr - z2).abs() < z_check
    resp = targets.responses[rr, c, nyc, nxc].to(torch.float32)
    score = torch.where(inb & z_ok, resp, 0.0).sum(dim=1)
    count = inb.sum(dim=1)
    four = torch.full((), 4.0, dtype=torch.float32, device=score.device)
    hundred = torch.full((), 100.0, dtype=torch.float32, device=score.device)
    sim = torch.where(count > 0, score / count.clamp(min=1).to(torch.float32) / four * hundred, 0.0)
    return torch.where((cj > 0) & (ca > 0), sim, 0.0)


class DeviceRoiSet:
    """A ``PatchSet`` staged on a device + the padded pivot-feature table."""

    def __init__(self, roi_set: PatchSet, patches: Sequence[PatchFeature], z_check: float = 200.0, device=None):
        device = resolve_device(device)
        self.device = device
        self.targets = _Targets(roi_set, device)
        self.pivots = lchf_pivot_tables(patches, device)
        self.z_check = float(z_check)

    def sim_rows(self, pivot: int, idx: np.ndarray) -> np.ndarray:
        """similarity(patches[pivot] -> rois[idx]); host in, host out."""
        rows = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
        piv = torch.full_like(rows, int(pivot))
        return similarity_rows(self.pivots, piv, self.targets, rows, self.z_check).cpu().numpy()

    def matrix(self) -> torch.Tensor:
        """(N_pivots, M_targets) float32 similarity matrix on the device."""
        n = self.pivots.feats.shape[0]
        m = self.targets.center.shape[0]
        f = self.pivots.feats.shape[1]
        block = max(1, _BLOCK_ELEMENTS // max(m * f, 1))
        cols = torch.arange(m, device=self.device)
        out = []
        for s in range(0, n, block):
            b = min(block, n - s)
            piv = torch.arange(s, s + b, device=self.device).repeat_interleave(m)
            sims = similarity_rows(self.pivots, piv, self.targets, cols.repeat(b), self.z_check)
            out.append(sims.reshape(b, m))
        return torch.cat(out, dim=0)


class DeviceForest:
    """Scene prediction as one level-synchronous walk per tree on a device.

    Each ROI carries its node id; each of ``max_depth`` steps gathers every
    ROI's pivot-patch feature table, evaluates the similarity and advances
    to the chosen child; leaves loop on themselves.  No readback until the
    leaves of every tree are known.

    Semantics of forest.Tree.predict over feature.similarity_one_to_many
    (forest.h:497-512, lchf.cpp:716-792), in the jit route's float32.
    """

    def __init__(self, model, z_check: float = 200.0, device=None):
        self.device = resolve_device(device)
        self.z_check = float(z_check)
        self.tables = lchf_tables_from_model(model, self.device)
        self.max_depth = self.tables.max_depth

    def predict_tensor(self, roi_set: PatchSet) -> torch.Tensor:
        """Leaf id per (roi, tree): (M, T) int64 on the device."""
        targets = _Targets(roi_set, self.device)
        m = targets.center.shape[0]
        rows = torch.arange(m, device=self.device)
        outs = []
        for tree in self.tables.trees:
            node = torch.zeros((m,), dtype=torch.int64, device=self.device)
            for _ in range(self.max_depth):
                sims = similarity_rows(self.tables.pivots, tree.split[node], targets, rows, self.z_check)
                nxt = torch.where(sims <= tree.thresh[node], tree.child[node, 0], tree.child[node, 1])
                node = torch.where(tree.leaf[node], node, nxt)
            outs.append(node)
        return torch.stack(outs, dim=1)

    def predict(self, roi_set: PatchSet) -> np.ndarray:
        """Leaf id per (roi, tree): (M, T) int64, one readback."""
        return self.predict_tensor(roi_set).cpu().numpy()


def similarity_matrix_device(patches, roi_set: PatchSet, z_check: float = 200.0, device=None) -> np.ndarray:
    """Full patches x roi_set similarity matrix on the device, one readback.
    Semantics of feature.similarity_one_to_many per row, in float32."""
    return DeviceRoiSet(roi_set, patches, z_check, device).matrix().cpu().numpy()
