"""Equivalence gate and timing of the local-refine kernel on one card.

Twin of the JAX package's ``tools/bench_pallas_refine.py``, at its case1
scale and inputs (seed 0: K = 128 candidates, F = 254 features, VGA maps of
16 channels, t = 5).  The JAX package has five Pallas variants of this
kernel (``ops/pallas/local_refine.py``, v1-v5, one contract); here they are
one hand-written CUDA kernel, ``csrc/local_refine.cu``, behind
``ops.local_refine.similarity_local_sparse_cuda``.

It prints the JAX tool's ``{"variant", "equivalent"}`` line for the kernel
against its plain version (``ops.similarity.similarity_local_sparse``):
equivalent means equal scores and counts, exactly.  Then the milliseconds
of the kernel, of the plain version and of the grouped convolution that
computes the same scores (``ops.similarity.similarity_local``), CUDA-event
medians on the card (the host clock on the CPU, where the wrapper runs the
plain version), beside the bound: the least bytes the call must move (the
map bytes its in-range windows touch, the feature tables and the outputs,
each once) at the H100's memory rate.

Usage: python -m sixdpose_tpu_torch.tools.bench_local_refine [--K 128] [--F 254]
           [--device cpu] [--out JSON]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.ops.local_refine import similarity_local_sparse_cuda
from sixdpose_tpu_torch.ops.similarity import (
    _feature_table,
    build_template_kernels,
    similarity_local,
    similarity_local_sparse,
)
from sixdpose_tpu_torch.utils.artifacts import provenance
from sixdpose_tpu_torch.utils.timing import median_ms_per_call

# NVIDIA H100 SXM data sheet, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # the kernel's int32 adds run on these pipes
T = 5
WINDOW = 16
REPEATS = 5  # timed windows; the median is reported


def case(k: int = 128, f: int = 254, seed: int = 0) -> dict:
    """The JAX tool's inputs, drawn in its order: maps (16, 480, 640)
    uint8 in [0, 5), features (K, F, 3) with x < 120, y < 90 and channel
    < 16, 95% valid, origins (K, 2) multiples of t."""
    rng = np.random.default_rng(seed)
    maps = rng.integers(0, 5, (16, 480, 640)).astype(np.uint8)
    feats = np.stack([rng.integers(0, 120, (k, f)), rng.integers(0, 90, (k, f)),
                      rng.integers(0, 16, (k, f))], -1).astype(np.int32)
    valid = rng.random((k, f)) < 0.95
    origins = (rng.integers(0, 60, (k, 2)) * T).astype(np.int32)
    return {"maps": maps, "feats": feats, "valid": valid, "origins": origins}


def bound(maps, feats, valid, origins, t: int = T, window: int = WINDOW) -> dict:
    """Least bytes and operations of one call on these inputs: the map
    bytes its valid in-range windows touch, the feature tables and the
    outputs, each once; one add per touched window cell."""
    ch, h, w = maps.shape
    ok, cprime, by, bx = _feature_table(feats, valid, origins, t, -(-h // t), -(-w // t))
    chan, dy, dx = cprime // (t * t), (cprime % (t * t)) // t, cprime % t
    steps = torch.arange(window, device=maps.device)
    rows = (by[..., None] + steps) * t + dy[..., None]  # (K, F, window)
    cols = (bx[..., None] + steps) * t + dx[..., None]
    cell = ok[..., None, None] & (rows[..., :, None] < h) & (cols[..., None, :] < w)
    addr = ((chan[..., None, None] * h + rows[..., :, None]) * w + cols[..., None, :]).long()
    touched = torch.zeros(maps.numel(), dtype=torch.bool, device=maps.device)
    touched[addr[cell]] = True
    k, f = feats.shape[:2]
    nbytes = int(touched.sum()) + k * (f * 13 + 8) + k * (window * window * 4 + 4)
    ops = int(cell.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def report(k: int = 128, f: int = 254, device=None, reps: int = 20) -> dict:
    """The equivalence line's verdict and the times of one call at
    ``case(k, f)`` on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    arrays = case(k, f)
    c = {n: torch.from_numpy(a).to(dev) for n, a in arrays.items()}
    args = (c["maps"], c["feats"], c["valid"], c["origins"], T)
    ks, kc = similarity_local_sparse_cuda(*args)
    ps, pc = similarity_local_sparse(*args)
    equivalent = bool(torch.equal(ks, ps) and torch.equal(kc, pc))
    kh, kw = int(arrays["feats"][..., 1].max()) + 1, int(arrays["feats"][..., 0].max()) + 1
    kernels = torch.from_numpy(build_template_kernels(arrays["feats"], arrays["valid"], kh, kw, 16)).to(dev)
    conv = similarity_local(c["maps"], kernels, c["origins"], T)
    slow = max(1, reps // 10)  # the plain version and the conv are tens to thousands of times slower
    out = {
        "variant": "local_refine", "equivalent": equivalent, "grouped_conv_equal": bool(torch.equal(conv, ps)),
        "K": k, "F": f, "t": T, "maps": list(c["maps"].shape),
        "kernel_ms": median_ms_per_call(lambda: similarity_local_sparse_cuda(*args), reps, REPEATS, dev),
        "plain_ms": median_ms_per_call(lambda: similarity_local_sparse(*args), slow, REPEATS, dev),
        "grouped_conv_ms": median_ms_per_call(lambda: similarity_local(c["maps"], kernels, c["origins"], T), slow,
                                              REPEATS, dev),
        **bound(*args),
    }
    out["us_per_feature"] = out["kernel_ms"] * 1e3 / (k * f)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--K", type=int, default=128)
    ap.add_argument("--F", type=int, default=254)
    ap.add_argument("--reps", type=int, default=20, help="kernel calls per timed window")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    r = report(args.K, args.F, args.device, args.reps)
    print(json.dumps({"variant": r["variant"], "equivalent": r["equivalent"]}), flush=True)
    if not r["equivalent"]:
        return 1
    dev = resolve_device(args.device)
    r["provenance"] = provenance({"K": args.K, "F": args.F, "reps": args.reps}, dev)
    print(json.dumps({k: r[k] for k in ("variant", "kernel_ms", "plain_ms", "grouped_conv_ms", "bound_ms", "bound_by",
                                         "bytes", "us_per_feature")}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(r, fh, indent=1)
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
