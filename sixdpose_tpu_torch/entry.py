"""The fused detection forward and its example inputs.

Port of the JAX package's entry program ``__graft_entry__.entry()``: one
detection step (``detect_frame_core``) of a 16-template synthetic class on a
VGA RGB-D frame, at threshold 50, with the class's bank passed as its
per-level (kernels, nfeats, whs) only.  Without feature lists the step takes
the dense-kernel route: the coarse level by the dense conv and the
refinement by the grouped conv of ``ops.similarity.similarity_local``.

    fn, (rgb, depth) = entry()          # on the card
    tid, x, y, score, keep = fn(rgb, depth)

``entry(device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.models.detector import Detector, detect_frame_core
from sixdpose_tpu_torch.models.templates import TemplateLevel

CLASS_ID = "obj"
THRESHOLD = 50.0


def toy_bank(num_templates: int, seed: int = 0, size0: int = 24) -> List[List[TemplateLevel]]:
    """A small synthetic template bank: per template, two levels of
    ``32 >> l`` random features (x, y in the level's ``size0 >> l`` square,
    channel in 0..15), drawn from ``default_rng(seed)`` in the JAX
    package's order."""
    rng = np.random.default_rng(seed)
    templates = []
    for _ in range(num_templates):
        levels = []
        for l in (0, 1):
            size = size0 >> l
            f = 32 >> l
            feats = np.stack([rng.integers(0, size, f), rng.integers(0, size, f), rng.integers(0, 16, f)], 1)
            levels.append(TemplateLevel(features=feats, width=size, height=size, pyramid_level=l))
        templates.append(levels)
    return templates


def entry(device=None):
    """Returns ``(fn, (rgb, depth))``: the fused detection forward of a
    16-template bank (``size0`` 32) without feature lists, at
    ``DetectorConfig(t_at_level=(4, 8), top_k=32)`` and threshold 50, and a
    VGA frame drawn from ``default_rng(1)`` (rgb (480, 640, 3) uint8, depth
    (480, 640) int32 mm from uint16), both on ``device`` (the card unless
    ``"cpu"``).  ``fn(rgb, depth)`` returns (tid, x, y, score, keep), each
    (32,)."""
    dev = resolve_device(device)
    cfg = DetectorConfig(t_at_level=(4, 8), top_k=32)
    det = Detector(cfg, device=dev)
    for tl in toy_bank(16, size0=32):
        det.bank.add_template_levels(CLASS_ID, tl)
    bank = det.device_bank(CLASS_ID).without_features()

    def fn(rgb, depth):
        return detect_frame_core(rgb, depth, bank, cfg, THRESHOLD)

    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 255, (480, 640, 3), np.uint8)
    dep = (900 + 60 * rng.standard_normal((480, 640))).astype(np.uint16)
    return fn, (torch.from_numpy(rgb).to(dev), torch.from_numpy(dep.astype(np.int32)).to(dev))
