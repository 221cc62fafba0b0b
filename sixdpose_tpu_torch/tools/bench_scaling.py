"""Data-parallel scaling benchmark over the port's ``parallel`` package.

Twin of the JAX package's ``tools/bench_scaling.py``: the sharded
detection runs over growing data meshes with the per-rank workload held
constant (weak scaling: at each size every rank takes the same batch of
``frames_per_dev`` frames), and each size reports seconds per step and the
efficiency against the smallest mesh.  Two workloads: ``random``, the JAX
tool's (random 32 x 32 templates on random RGB frames), and ``bench``,
bench.py's (VGA RGB-D, 89 templates x 2 modalities, t_at_level (5, 8),
top_k 128, threshold 30).  The ranks are processes of this host
(``parallel.distributed.run_ranks``); rank 0 times each size with CUDA
events on the card (the JAX tool's chained-jit slope is not needed: the
events time the device) or with the host clock on the CPU.

Rows whose ranks share a card (more ranks than cards, over gloo) and CPU
rows carry no efficiency: ranks that share a device share its time, so
their weak-scaling efficiency says nothing about scaling.  With two or more
rows on cards of their own, ``--artifact`` asserts the >= 80 % efficiency
north star (exit 1 below it).

Examples:
  python -m sixdpose_tpu_torch.tools.bench_scaling --sizes 1 2 4 --artifact SCALING.json
  python -m sixdpose_tpu_torch.tools.bench_scaling --workload bench --frames-per-dev 4 --sizes 1 2 4
  python -m sixdpose_tpu_torch.tools.bench_scaling --device cpu --sizes 1 2 4 8
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence, Tuple

import numpy as np
import torch

from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import ColorGradientConfig, DetectorConfig
from sixdpose_tpu_torch.models.templates import TemplateBank, TemplateLevel
from sixdpose_tpu_torch.parallel.distributed import measure_scaling, run_ranks
from sixdpose_tpu_torch.parallel.mesh import rank_device
from sixdpose_tpu_torch.parallel.sharded_match import shard_bank, sharded_detect

def random_workload(templates: int = 8, frames_per_dev: int = 2, hw: Tuple[int, int] = (128, 160), seed: int = 0):
    """The JAX tool's workload as (cfg, per-level bank, per-rank rgb batch,
    depth None, threshold 50): ``templates`` random 32 x 32 templates of 24
    colour features (12 at level 1), random RGB frames."""
    cfg = DetectorConfig(t_at_level=(4, 8), use_depth=False, top_k=16, color=ColorGradientConfig(num_features=24))
    bank = TemplateBank(cfg)
    rng = np.random.default_rng(seed)
    for _ in range(templates):
        levels = []
        for l, size in ((0, 32), (1, 16)):
            f = 24 >> l
            feats = np.stack([rng.integers(0, size, f), rng.integers(0, size, f), rng.integers(0, 8, f)], 1)
            levels.append(TemplateLevel(feats, size, size, l))
        bank.add_template_levels("obj", levels)
    rgb = rng.integers(0, 255, (frames_per_dev,) + tuple(hw) + (3,), dtype=np.uint8)
    return cfg, bank.finalized("obj"), rgb, None, 50.0


def bench_workload(frames_per_dev: int = 4):
    """bench.py's workload (``synthetic.bench_bank``) as (cfg, per-level
    bank, per-rank rgb batch, depth batch, threshold 30): VGA RGB-D, 89
    templates x 2 modalities, ``DetectorConfig(t_at_level=(5, 8))``, the
    frames bench.py batches (the scene xor the frame index)."""
    cid, templates, rgb, dep = synthetic.bench_bank()
    cfg = DetectorConfig(t_at_level=(5, 8))
    bank = TemplateBank(cfg)
    for levels in templates:
        bank.add_template_levels(cid, levels)
    frames = np.stack([rgb ^ np.uint8(i) for i in range(frames_per_dev)])
    return cfg, bank.finalized(cid), frames, np.stack([dep] * frames_per_dev), 30.0


WORKLOADS = {"random": random_workload, "bench": bench_workload}


def scaling_rank(rank: int, world: int, device_type: str, cfg, levels, rgb: np.ndarray, depth, threshold: float,
                 sizes: Sequence[int], iters: int):
    """One rank of the sweep (the target of ``run_ranks``): at each size the
    global batch is ``size`` copies of the per-rank batch ``rgb`` (and
    ``depth``, or None); returns ``measure_scaling``'s rows of this rank."""
    dev = rank_device(device_type, rank)
    bank = shard_bank(levels, 1, 0, dev)

    def args_for(mesh):
        n = mesh.size(0)
        dep = torch.from_numpy(np.concatenate([depth] * n).astype(np.int32)).to(dev) if depth is not None else None
        return torch.from_numpy(np.concatenate([rgb] * n)).to(dev), dep

    def step(mesh, rgb_t, dep_t):
        return sharded_detect(mesh, rgb_t, dep_t, bank, cfg, threshold)

    return measure_scaling(step, args_for, sizes, iters=iters, device_type=device_type)


def scaling_rows(results: dict, device_type: str, world: int) -> list:
    """Artifact rows; efficiency only where each rank has a card."""
    own_cards = device_type == "cuda" and world <= torch.cuda.device_count()
    rows = []
    for size, r in sorted(results.items()):
        row = {"devices": size, "platform": "gpu" if device_type == "cuda" else "cpu",
               "method": "cuda_events" if device_type == "cuda" else "host_clock", "s_per_step": r["s_per_step"]}
        if own_cards:
            row["efficiency"] = r["efficiency"]
        else:
            row["correctness_only"] = True
            row["shared_device"] = device_type == "cuda"
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="random")
    ap.add_argument("--frames-per-dev", type=int, default=2)
    ap.add_argument("--hw", type=int, nargs=2, default=[128, 160], help="frame size of the random workload")
    ap.add_argument("--templates", type=int, default=8, help="templates of the random workload")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--artifact", default=None, help="write the scaling record")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_scaling: no CUDA device; pass --device cpu for the CPU", file=sys.stderr)
        return 2
    if args.workload == "bench":
        workload = bench_workload(args.frames_per_dev)
    else:
        workload = random_workload(args.templates, args.frames_per_dev, tuple(args.hw))
    world = max(args.sizes)
    results = run_ranks(scaling_rank, world, (args.device,) + workload + (args.sizes, args.iters),
                        device_type=args.device, timeout=args.timeout)[0]
    rows = scaling_rows(results, args.device, world)
    for row in rows:
        print(json.dumps(row))
    if not args.artifact:
        return 0
    rgb = workload[2]
    record = {
        "workload": {"name": args.workload, "hw": list(rgb.shape[1:3]), "templates": len(workload[1][0].nfeat),
                     "frames_per_dev": args.frames_per_dev, "depth": workload[3] is not None},
        "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
        "rows": rows,
        "note": "efficiency is weak scaling against the smallest mesh, given only where each rank has a card; "
                "rows of ranks sharing a device are correctness-only",
    }
    ok = True
    if len(rows) >= 2 and all("efficiency" in r for r in rows[1:]):
        worst = min(r["efficiency"] for r in rows[1:])
        record["efficiency_assertion"] = {"threshold": 0.8, "worst": worst}
        ok = worst >= 0.8
    record["ok"] = ok
    with open(args.artifact, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {args.artifact} (ok={ok})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
