"""Per-stage time of the match frame on one card.

Twin of the JAX package's ``tools/bench_stage_breakdown.py``: the frame of
``detect_frame_core`` (quantize -> spread -> response maps -> coarse
similarity -> top-K -> pyramid refinement -> sort and NMS) runs as growing
prefixes, ``quantize``, ``spread``, ``maps``, ``coarse``, ``topk``,
``refine`` and ``full``, each timed whole; a stage's time is its prefix's
less the one before it.  The JAX tool chains K calls of a prefix in one jit
and fits a slope over two K; eager PyTorch launches every call, so here
each prefix is timed by CUDA events around ``--reps`` back-to-back calls,
the median of ``--repeats`` such windows (the host clock on the CPU).

The workload is the bench bank (``synthetic.bench_bank``: 89 templates,
VGA RGB-D, ``t_at_level=(5, 8)``, threshold 75), where the JAX tool reads
the case1 bank and falls back to the same synthetic bank when case1 is not
mounted.  It prints each prefix's milliseconds, then one JSON line with the
JAX tool's keys (``prefix_ms``, ``stage_ms``, ``fps_full``).

Usage: python -m sixdpose_tpu_torch.tools.bench_stage_breakdown [--out JSON]
           [--device cpu] [--templates 89] [--hw 480 640]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.convert import bank_levels_from_numpy
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.models.detector import (
    _build_response_pyramid,
    _offset,
    coarse_scores,
    detect_frame_core,
    pyramid_refine,
)
from sixdpose_tpu_torch.models.templates import TemplateBank
from sixdpose_tpu_torch.ops import quantize as Q
from sixdpose_tpu_torch.ops.spread import spread_orientations
from sixdpose_tpu_torch.ops.topk_nms import topk_candidates
from sixdpose_tpu_torch.utils.artifacts import provenance
from sixdpose_tpu_torch.utils.timing import median_ms_per_call

STAGES = ("quantize", "spread", "maps", "coarse", "topk", "refine", "full")
CFG = DetectorConfig(t_at_level=(5, 8))
THRESHOLD = 75.0


def prefixes(rgb, depth, bank, cfg: DetectorConfig = CFG, threshold: float = THRESHOLD) -> dict:
    """Stage name -> the frame's prefix through that stage, a function of
    no arguments over one frame (rgb (1, H, W, 3) uint8 and depth (1, H, W)
    int32 tensors, the class's ``DeviceBank``), each as
    ``detect_frame_core`` runs the stages."""
    tal = tuple(cfg.t_at_level)

    def depth_levels():
        return Q.depth_normal_pyramid(depth, cfg.pyramid_levels, cfg.depth.distance_threshold,
                                      cfg.depth.difference_threshold, cfg.depth.focal, cfg.depth.lut_parity)

    def color_levels():
        cur, out = rgb, []
        for l in range(cfg.pyramid_levels):
            if l > 0:
                cur = Q.pyr_down_rgb(cur)
            out.append(Q.quantize_color_gradient(cur, cfg.color.weak_threshold)[0])
        return out

    def quantize():
        return color_levels(), depth_levels()

    def spread():
        colors, depths = quantize()
        return [spread_orientations(q, cfg.t_at_level[l]) for l, pair in enumerate(zip(colors, depths)) for q in pair]

    def maps():
        return _build_response_pyramid(rgb, depth, cfg)

    def coarse():
        pyramid = maps()
        return pyramid, coarse_scores(pyramid, bank.kernels, bank.nfeats, tal, bank.feats, bank.valids)

    def topk():
        pyramid, scores = coarse()
        return pyramid, topk_candidates(scores, threshold, cfg.top_k)

    def refine():
        pyramid, (tid, yi, xi, score) = topk()
        t_c = tal[-1]
        return pyramid_refine(pyramid, bank.nfeats, bank.whs, bank.feats, bank.valids, tal, threshold, tid,
                              xi * t_c + _offset(t_c), yi * t_c + _offset(t_c), score)

    def full():
        return detect_frame_core(rgb, depth, bank, cfg, threshold)

    return dict(zip(STAGES, (quantize, spread, maps, coarse, topk, refine, full)))


def workload(device, templates: int = 89, hw=(480, 640)) -> tuple:
    """(rgb, depth, bank) of the bench bank on ``device``: the first
    ``templates`` templates and the frame's top-left ``hw`` pixels."""
    cid, tmpls, rgb, dep = synthetic.bench_bank(templates)
    bank = TemplateBank(CFG)
    for levels in tmpls:
        bank.add_template_levels(cid, levels)
    h, w = hw
    rgb_t = torch.from_numpy(np.ascontiguousarray(rgb[:h, :w])).to(device)[None]
    dep_t = torch.from_numpy(dep[:h, :w].astype(np.int32)).to(device)[None]
    return rgb_t, dep_t, bank_levels_from_numpy(bank.finalized(cid), device)


def breakdown(device=None, templates: int = 89, hw=(480, 640), reps: int = 10, repeats: int = 5) -> dict:
    """The JAX tool's report on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    stages = prefixes(*workload(dev, templates, hw))
    prefix_ms = {}
    for name, fn in stages.items():
        prefix_ms[name] = median_ms_per_call(fn, reps, repeats, dev)
        print(f"prefix through {name:<8s}: {prefix_ms[name]:8.3f} ms", flush=True)
    stage_ms = {STAGES[0]: prefix_ms[STAGES[0]]}
    for a, b in zip(STAGES, STAGES[1:]):
        stage_ms[b] = prefix_ms[b] - prefix_ms[a]
    return {"prefix_ms": prefix_ms, "stage_ms": stage_ms, "fps_full": 1e3 / prefix_ms["full"],
            "workload": {"bank": "synthetic.bench_bank", "templates": templates, "hw": list(hw),
                         "t_at_level": list(CFG.t_at_level), "threshold": THRESHOLD},
            "timing": {"reps": reps, "repeats": repeats, "clock": "cuda events" if dev.type == "cuda" else "host"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None)
    ap.add_argument("--templates", type=int, default=89)
    ap.add_argument("--hw", type=int, nargs=2, default=[480, 640], help="frame rows and columns (a crop of VGA)")
    ap.add_argument("--reps", type=int, default=10, help="calls per timed window")
    ap.add_argument("--repeats", type=int, default=5, help="timed windows; the median is reported")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    report = breakdown(args.device, args.templates, tuple(args.hw), args.reps, args.repeats)
    report["provenance"] = provenance(vars(args), resolve_device(args.device))
    print(json.dumps({k: report[k] for k in ("prefix_ms", "stage_ms", "fps_full")}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
