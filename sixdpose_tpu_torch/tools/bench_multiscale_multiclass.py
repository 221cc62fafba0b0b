"""Measure the multi-object multi-scale sweep on one card.

Twin of the JAX package's ``tools/bench_multiscale_multiclass.py``, on
``synthetic.multiscale_workload`` (15 classes x 337 templates, VGA RGB-D,
5 depth proposals, train depth 600 mm by default) in place of the case1
bank the JAX tool clones.  It reports the milliseconds per frame of one
class (``MultiScaleDetector``), of every class one at a time, and of every
class in one pass (``MultiScaleMultiClass``), by CUDA events on the card
or the host clock on the CPU.  The port builds the coarse weights per frame
and has no prebuilt per-depth-bin tables, so the JAX tool's table budget
and its table rows have no counterpart here.

Usage: python -m sixdpose_tpu_torch.tools.bench_multiscale_multiclass
           [--classes 15] [--views 337] [--out MULTISCALE_SWEEP.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.models.multiscale import MultiScaleDetector, MultiScaleMultiClass
from sixdpose_tpu_torch.utils.timing import ms_per_call


def sweep_report(w: dict, device=None, reps: int = 5, topk: int = None) -> dict:
    """Milliseconds per frame of the three sweeps over workload ``w``
    (``synthetic.multiscale_workload``), each after one warm-up frame."""
    dev = resolve_device(device)
    if topk:
        w = {**w, "cfg": dataclasses.replace(w["cfg"], top_k=topk)}
    det = synthetic.multiscale_detector(w, dev)
    ms = MultiScaleDetector(det, w["train_depth"], num_scales=w["num_scales"], device=dev)
    mc = MultiScaleMultiClass(det, w["train_depth"], num_scales=w["num_scales"], device=dev)
    rgb = torch.from_numpy(w["rgb"]).to(dev)
    dep = torch.from_numpy(w["depth"].astype(np.int32)).to(dev)
    thr = w["threshold"]
    one = lambda: ms.match_arrays(rgb, dep, thr, w["class_ids"][0])  # noqa: E731
    each = lambda: [ms.match_arrays(rgb, dep, thr, c) for c in w["class_ids"]]  # noqa: E731
    fused = lambda: mc.match_arrays(rgb, dep, thr)  # noqa: E731
    report = {"classes": len(w["class_ids"]), "templates_per_class": len(w["templates"][0]),
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for key, fn in (("ms_per_frame_per_class_scatter", one), ("ms_per_frame_all_classes", each),
                    ("ms_per_frame_one_dispatch", fused)):
        fn()
        report[key] = ms_per_call(fn, reps, dev)
    report["one_dispatch_topk_per_class"] = det.cfg.top_k
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--classes", type=int, default=synthetic.MS_CLASSES)
    ap.add_argument("--views", type=int, default=synthetic.MS_VIEWS)
    ap.add_argument("--fused-topk", type=int, default=None,
                    help="per-class top_k of the one-pass sweep (default: the workload's)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    w = synthetic.multiscale_workload(classes=args.classes, views=args.views)
    report = sweep_report(w, args.device, args.reps, args.fused_topk)
    for key in ("ms_per_frame_per_class_scatter", "ms_per_frame_all_classes", "ms_per_frame_one_dispatch"):
        print(f"{key}: {report[key]:.3f} ms")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
