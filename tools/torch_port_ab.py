"""A/B timing of two checkouts of the PyTorch port on one GPU: the bench
workload's match frame (``detect_frame_core`` at B=1) and fused frame
(``detect_refine_core`` at thresholds 75 and 30), each sample in a fresh
process, the pairs alternating which side runs first.

    python3 tools/torch_port_ab.py PARENT_DIR CHANGE_DIR [--pairs 10]

Each directory holds a checkout's ``chip_smoke.py`` and
``sixdpose_tpu_torch/`` with its bench twin ``bench.py`` (for instance ``git archive HEAD chip_smoke.py
sixdpose_tpu_torch`` unpacked into a git-ignored directory); a sample
imports that checkout's own package and builds its kernels.  Prints the
``nvidia-smi`` name and power limit, then one JSON line per sample: the
side and the CUDA-event medians (ms) of 20 calls of each frame, as
``chip_smoke.py``'s ``timing`` phase takes them.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def sample(checkout: str) -> dict:
    """The three frame medians of one checkout, in this process."""
    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import torch

    import chip_smoke as CS
    from sixdpose_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.build()
    dev = torch.device("cuda:0")
    cid, det, _, frames, depths = CS.bench_detectors(dev)
    stage = CS.synthetic.bench_refine_bank(det.device_bank(cid).whs[0].cpu().numpy())
    rgb, dep = CS.frame_tensors(frames, depths, dev)
    bank = det.device_bank(cid)
    run = {t: CS.TBN.refine_runner(dep, bank, stage, t) for t in (75.0, 30.0)}
    return {
        "match_b1": CS.cuda_ms(lambda: CS.detect_frame_core(rgb, dep, bank, CS.BENCH_CFG, 75.0), reps=20),
        "fused_75": CS.cuda_ms(lambda: run[75.0](rgb), reps=20),
        "fused_30": CS.cuda_ms(lambda: run[30.0](rgb), reps=20),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--sample", action="store_true", help="time PARENT alone in this process (internal)")
    args = ap.parse_args()
    if args.sample:
        print(json.dumps(sample(args.parent)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    sides = {"parent": args.parent, "change": args.change}
    for i in range(args.pairs):
        for side in ("parent", "change") if i % 2 == 0 else ("change", "parent"):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), sides[side], "--sample"],
                                 capture_output=True, text=True, check=True, timeout=600)
            print(json.dumps({"pair": i, "side": side, **json.loads(out.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
