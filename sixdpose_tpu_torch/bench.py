"""Benchmark: detection throughput against the reference CPU baseline, on the GPU.

Twin of the JAX package's ``bench.py``: the same workload, the same chained
slope and the same streamed record, computed by the port on the card.

    python -m sixdpose_tpu_torch.bench

Prints a cumulative JSON line after every stage (the last line is the most
complete record), so a timeout loses only the stages not yet measured:
  {"metric": "match_fps", "value": N, "unit": "frames/s", "vs_baseline": R,
   "nvidia_smi": "<name>, <power limit>", "local_refine_launches": L, ...}
then ``detect_refine_fps``, ``detect_refine_vs_baseline`` and
``match_fps_b{2,4,8}`` as their stages end.

Baseline: the reference's single-scale one-class match at ~0.03 s a frame
on VGA (linemodLevelup/notes.md:29; BASELINE.md): 33.33 fps.

Workload: the reference's case1 fixture (``linemodLevelup/test/case1`` of
the reference checkout named by ``SIXDPOSE_REFERENCE_DIR``) when it is
there, read with ``data.inout``; else ``synthetic.bench_bank()``, bench.py's
synthetic bank (VGA RGB-D, 89 templates of 254 and 127 features).  The
detector is ``DetectorConfig(t_at_level=(5, 8))`` at threshold 75.  On case1
the last frame of a one-frame chain must give the top kept match at
(327, 127) before anything is timed (bench.py's golden gate); the synthetic
bank has no gate here, as in bench.py (``chip_smoke.py`` holds its matches
against the CPU).

Methodology: as bench.py's, k frames are chained, each frame a
data-dependent perturbation of the last (``r ^ (score[0] % 2)``), so every
frame must really run; each chain length is timed on the wall clock (best of
3, a small readout ending the chain), and the per-frame time is the slope
over two chain lengths.  The port is eager PyTorch: a chain is a Python loop
of eager frames with no host read inside it, so the slope holds the host's
dispatch of each frame's kernels as well as the card's work.  That is what a
caller of the port gets per frame, and the eager match frame is host-bound
(the card idles most of it), so the slope can differ from the CUDA-event
medians of ``chip_smoke.py``'s ``timing`` phase, which time single calls.
No CUDA graph and no ``torch.compile``: the record is the eager port's.

Time budget: ``SIXDPOSE_BENCH_BUDGET_S`` (default 480 s).  The optional
stages (detect+refine, the batch sweep) are skipped once it is spent.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.convert import refine_bank_from_numpy
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.models.detector import Detector, detect_frame_core
from sixdpose_tpu_torch.models.pipeline import detect_refine_core
from sixdpose_tpu_torch.ops import local_refine as LR

BASELINE_FPS = 1.0 / 0.03  # reference ~0.03 s/frame (notes.md:29)
CFG = DetectorConfig(t_at_level=(5, 8))
THRESHOLD = 75.0
GOLDEN = (327, 127)  # case1's top kept match (test.cpp:76-88)
MATCH_CHAINS = (4, 36)
REFINE_CHAINS = (2, 18)
BATCHES = (2, 4, 8)
RECORD_KEYS = ("value", "vs_baseline", "detect_refine_fps", "detect_refine_vs_baseline") + tuple(
    f"match_fps_b{b}" for b in BATCHES)

class Record:
    """bench.py's cumulative record and its time budget: ``emit`` updates
    the record and prints it whole, with the refine kernel's launches so
    far; ``over_budget`` says when the optional stages must stop."""

    def __init__(self, budget_s: float, **fields):
        self.start = time.time()
        self.budget_s = budget_s
        self.fields = dict(metric="match_fps", value=0.0, unit="frames/s", vs_baseline=0.0, **fields)

    def emit(self, **kw) -> None:
        self.fields.update(kw, local_refine_launches=LR.similarity_local_sparse_cuda.launches)
        print(json.dumps(self.fields), flush=True)

    def over_budget(self, reserve_s: float = 30.0) -> bool:
        return (time.time() - self.start) > (self.budget_s - reserve_s)


def nvidia_smi() -> str:
    """The first card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def case1_dir():
    """The reference's case1 fixture directory, or None when it is absent."""
    ref = os.environ.get("SIXDPOSE_REFERENCE_DIR")
    path = os.path.join(ref, "linemodLevelup", "test", "case1") if ref else None
    return path if path and os.path.isdir(path) else None


def load_case1(path: str):
    """(class_id, templates, rgb, depth) of the case1 fixture (bench.py:61-73)."""
    from sixdpose_tpu_torch.data.inout import load_depth, load_im, load_reference_template_bank

    cid, templates = load_reference_template_bank(os.path.join(path, "127", "06_template.yaml"))
    rgb = load_im(os.path.join(path, "0000_rgb.png"))
    dep = load_depth(os.path.join(path, "0000_dep.png"))
    return cid, templates, rgb, dep


def match_chain(k: int, rgb: torch.Tensor, depth: torch.Tensor, bank, threshold: float = THRESHOLD):
    """``k`` chained matches (bench.py's ``match_chain``): each frame is the
    last one XOR its top score's parity.  Returns the frame after the chain
    and the matches (tid, x, y, score, keep) of the chain's last frame (None
    when ``k`` is 0)."""
    r, out = rgb, None
    for _ in range(k):
        out = detect_frame_core(r, depth, bank, CFG, threshold)
        r = r ^ (out[3][0] % 2.0).to(torch.uint8)
    return r, out


def batch_chain(k: int, rgb_b: torch.Tensor, depth_b: torch.Tensor, bank, threshold: float = THRESHOLD):
    """``k`` chained steps of a batch of frames (B, H, W, 3) with their
    depths (B, H, W): each frame is perturbed by its own top score's parity
    (bench.py's ``batch_chain``).  Returns the batch after the chain and the
    matches (tid, x, y, score, keep), each (B, K), of the chain's last step
    (None when ``k`` is 0)."""
    r, out = rgb_b, None
    for _ in range(k):
        out = detect_frame_core(r, depth_b, bank, CFG, threshold)
        r = r ^ (out[3][:, 0] % 2.0).to(torch.uint8)[:, None, None, None]
    return r, out


def refine_runner(depth: torch.Tensor, bank, stage: dict, threshold: float = THRESHOLD):
    """``run(rgb)``: ``detect_refine_core`` of one frame over ``bank`` and
    bench.py's refine stage ``stage`` (``synthetic.bench_refine_bank``), on
    the depth's device."""
    dev = depth.device
    rb = refine_bank_from_numpy(stage["fields"], stage["win"], dev)
    K, vp, vc = (torch.from_numpy(stage[n]).to(dev) for n in ("K", "verify_pts", "verify_colors"))

    def run(rgb):
        return detect_refine_core(rgb, depth, bank, CFG, threshold, rb, stage["icp"], K, stage["max_refine"], vp, vc)

    return run


def refine_chain(k: int, rgb: torch.Tensor, run) -> torch.Tensor:
    """``k`` chained detect+refine frames: each frame is the last one XOR
    the parity of its first fitness times 255 (bench.py's
    ``refine_chain``).  Returns the frame after the chain."""
    r = rgb
    for _ in range(k):
        fit = run(r)[6]
        r = r ^ (fit[0].abs() * 255.0 % 2.0).to(torch.uint8)
    return r


def readout(r: torch.Tensor) -> float:
    """The small read that ends a chain: the sum of the first channel."""
    return float(r[..., :1].to(torch.float32).sum())


def _slope_fps(prog, x0, read, k1: int, k2: int, retries: int = 5, clock=time.time) -> float:
    """Frames a second from the slope over two chain lengths: ``prog(k, x0)``
    runs a k-frame chain and ``read(result)`` ends it; each length is the
    best of 3 runs on ``clock``; retried while the slope is not positive."""

    def run(k):
        best = float("inf")
        for _ in range(3):
            t0 = clock()
            read(prog(k, x0))
            best = min(best, clock() - t0)
        return best

    dt = None
    for _ in range(retries):
        t1, t2 = run(k1), run(k2)
        dt = (t2 - t1) / (k2 - k1)
        if dt > 0:
            return 1.0 / dt
    return 1.0 / max(dt, 1e-9)


def main(device=None, workload=None, match_chains=MATCH_CHAINS, refine_chains=REFINE_CHAINS) -> int:
    """Run the benchmark on ``device`` (the card unless ``"cpu"``) and print
    the record after each stage.  ``workload``: (class_id, templates, rgb,
    depth) in place of case1 or the synthetic bank; ``match_chains`` and
    ``refine_chains``: the two chain lengths of the match and of the
    detect+refine stage.  Returns 1 when the golden gate fails."""
    dev = resolve_device(device)
    rec = Record(float(os.environ.get("SIXDPOSE_BENCH_BUDGET_S", "480")),
                 nvidia_smi=nvidia_smi() if dev.type == "cuda" else None)
    LR.similarity_local_sparse_cuda.launches = 0
    if workload is None:
        case1 = case1_dir()
        workload = load_case1(case1) if case1 else synthetic.bench_bank()
    cid, templates, rgb, dep = workload
    det = Detector(CFG, device=dev)
    for tl in templates:
        det.bank.add_template_levels(cid, tl)
    bank = det.device_bank(cid)
    rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
    dep_t = torch.from_numpy(dep.astype(np.int32)).to(dev)

    def chain_prog(k, r):
        return match_chain(k, r, dep_t, bank)[0]

    # Golden gate: the program being timed must find case1's top match.
    _, (tid, x, y, score, keep) = match_chain(1, rgb_t, dep_t, bank)
    if cid != "synthetic":
        x_np, y_np, s_np, k_np = (a.cpu().numpy() for a in (x, y, score, keep))
        ok = [(int(x_np[i]), int(y_np[i])) for i in range(len(s_np)) if k_np[i] and s_np[i] >= 0]
        if not ok or ok[0] != GOLDEN:
            rec.emit(error=f"golden {GOLDEN} FAILED: got {ok[:3]}")
            return 1

    # Headline: single-frame match fps.
    k1, k2 = match_chains
    for k in (k1, k2):
        readout(chain_prog(k, rgb_t))
    fps = _slope_fps(chain_prog, rgb_t, readout, k1, k2)
    rec.emit(value=round(fps, 1), vs_baseline=round(fps / BASELINE_FPS, 2))

    # Detect+refine fps: match -> seed -> batched ICP -> verify, chained.
    if not rec.over_budget():
        run = refine_runner(dep_t, bank, synthetic.bench_refine_bank(bank.whs[0].cpu().numpy()))

        def refine_prog(k, r):
            return refine_chain(k, r, run)

        for k in refine_chains:
            readout(refine_prog(k, rgb_t))
        refine_fps = _slope_fps(refine_prog, rgb_t, readout, *refine_chains)
        rec.emit(detect_refine_fps=round(refine_fps, 1), detect_refine_vs_baseline=round(refine_fps / BASELINE_FPS, 2))

    # Batched frames: per-frame cost at B > 1; the chains shorten with B.
    for b_n in BATCHES:
        if rec.over_budget():
            break
        rgb_b0 = torch.from_numpy(np.stack([rgb] * b_n) ^ np.arange(b_n, dtype=np.uint8)[:, None, None, None]).to(dev)
        dep_b = dep_t.expand(b_n, -1, -1).contiguous()

        def batch_prog(k, r):
            return batch_chain(k, r, dep_b, bank)[0]

        k1b = max(2, k1 // b_n)
        k2b = max(k1b + 4, k2 // b_n)
        for k in (k1b, k2b):
            readout(batch_prog(k, rgb_b0)[0])
        fps_b = _slope_fps(batch_prog, rgb_b0, lambda r: readout(r[0]), k1b, k2b)
        rec.emit(**{f"match_fps_b{b_n}": round(b_n * fps_b, 1)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
