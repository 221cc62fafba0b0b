"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main path, single-class template matching
(``detect_frame_core`` through ``Detector``), at the full width of the JAX
package's bench workload (VGA RGB-D, 89 templates x 2 modalities,
``t_at_level=(5, 8)``, top_k 128), and checks every result.  One JSON line
per phase; a failing phase raises, so the script exits non-zero:

1. env: versions, device, ``nvidia-smi`` name and power limit;
2. build: compiles every kernel in ``sixdpose_tpu_torch/csrc`` with nvcc;
3. match_vga: a few frames through ``Detector.match`` / ``match_arrays``
   at threshold 75 and at one low enough that most of the 128 candidates
   reach the refine kernel, and a batch of 4 through
   ``match_batch_arrays``, with the kernels' launch counts set to 0 just
   before and read just after; the GPU results must equal the port's CPU
   results (plain versions) and the batch the single-frame calls;
4. kernel_parity: the local-refine kernel against its plain version on the
   card, exactly, at the shapes of tests/test_pallas.py and at the inputs
   the main path gave it;
5. match_golden: the JAX golden of ``tools/torch_port_golden.py`` on the
   planted-object VGA scene;
6. timing: CUDA-event medians of ``detect_frame_core`` per frame at B=1 and
   B=4, and of the kernel, its plain version and one PyTorch library call
   computing the same function at the main path's shapes (replayed from
   CUDA graphs, so host launch overhead is left out), beside the bound;
7. profile: torch.profiler's split of a B=1 frame into device kernels and
   host ops, and the device's idle share;
8. kernels: one line ``{"kernels": [...]}`` with, per kernel, its route,
   source, the TPU kernels it replaces, its launches in phase 3, its error
   against the plain version, and its time beside the plain version's, the
   library call's and the bound; then the ``nvidia-smi`` line again.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script prints no result and exits 2.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.models import detector as D
from sixdpose_tpu_torch.models.detector import Detector, detect_frame_core
from sixdpose_tpu_torch.ops import _build
from sixdpose_tpu_torch.ops import local_refine as LR
from sixdpose_tpu_torch.ops.similarity import (
    _feature_table,
    _local_conv_operands,
    similarity_local,
    similarity_local_sparse,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(ROOT, "sixdpose_tpu_torch", "testdata")
BENCH_CFG = DetectorConfig(t_at_level=(5, 8))
LOW_THRESHOLD = 30.0
MIN_LIVE = 64
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # non-tensor-core rate; the kernel's int32 adds run there
REPLACES = [
    "sixdpose_tpu/ops/pallas/local_refine.py:772 similarity_local_sparse_pallas (v1, _refine_kernel :51)",
    "sixdpose_tpu/ops/pallas/local_refine.py:162 similarity_local_sparse_pallas_v2 (_refine_kernel_v2 :108)",
    "sixdpose_tpu/ops/pallas/local_refine.py:308 similarity_local_sparse_pallas_v3 (_refine_kernel_v3 :251)",
    "sixdpose_tpu/ops/pallas/local_refine.py:472 similarity_local_sparse_pallas_v4 (_refine_kernel_v4 :400)",
    "sixdpose_tpu/ops/pallas/local_refine.py:646 similarity_local_sparse_pallas_v5 (_refine_kernel_v5 :578)",
]


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3), **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@contextmanager
def recording_refine_calls(calls: list):
    """Record the inputs of every local-refine call the main path makes, at
    the detector's dispatch; the calls still go through the wrapper and its
    launch count."""
    original = D.similarity_local_sparse_auto

    def recorder(maps, feats, valid, origins, t, window=16, scale=None, active=None):
        calls.append(dict(maps=maps, feats=feats, valid=valid, origins=origins, t=t,
                          window=window, scale=scale, active=active))
        return original(maps, feats, valid, origins, t, window, scale, active)

    D.similarity_local_sparse_auto = recorder
    try:
        yield
    finally:
        D.similarity_local_sparse_auto = original


def same_live(a, b) -> bool:
    """(tid, x, y, score, keep) equal on live entries (score >= 0); keep and
    deadness equal everywhere."""
    a = [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in a]
    b = [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in b]
    live = a[3] >= 0
    if not (np.array_equal(b[3] >= 0, live) and np.array_equal(a[4], b[4])):
        return False
    return all(np.array_equal(x[live], y[live]) for x, y in zip(a[:4], b[:4]))


def bench_detectors(dev):
    cid, templates, rgb, dep = synthetic.bench_bank()
    dets = []
    for device in (dev, "cpu"):
        det = Detector(BENCH_CFG, device=device)
        for tl in templates:
            det.bank.add_template_levels(cid, tl)
        dets.append(det)
    frames = np.stack([rgb ^ np.uint8(i) for i in range(4)])  # bench.py's batch frames
    depths = np.stack([dep] * 4)
    return cid, dets[0], dets[1], frames, depths


def phase_match_vga(dev, cid, det, det_cpu, frames, depths):
    t0 = time.perf_counter()
    calls: list = []
    LR.similarity_local_sparse_cuda.launches = 0
    with recording_refine_calls(calls):
        matches = [det.match(frames[i], depths[i], 75.0) for i in range(2)]
        gpu_75 = [det.match_arrays(frames[i], depths[i], 75.0, cid) for i in range(2)]
        n_before_low = len(calls)
        gpu_low = [det.match_arrays(frames[i], depths[i], LOW_THRESHOLD, cid) for i in range(2)]
        batch = det.match_batch_arrays(frames, depths, LOW_THRESHOLD, cid)
        torch.cuda.synchronize()
    launches = LR.similarity_local_sparse_cuda.launches
    live_in = [c["active"].sum(dim=-1).tolist() for c in calls]  # per call, per frame
    check(launches == len(calls) and launches > 0, f"refine launches {launches} for {len(calls)} calls")
    low_live = [n for per_frame in live_in[n_before_low:] for n in per_frame]
    check(min(low_live) >= MIN_LIVE, f"only {min(low_live)} live candidates reached the kernel at {LOW_THRESHOLD}")

    cpu_75 = [det_cpu.match_arrays(frames[i], depths[i], 75.0, cid) for i in range(2)]
    cpu_low = [det_cpu.match_arrays(frames[i], depths[i], LOW_THRESHOLD, cid) for i in range(2)]
    for g, c in zip(gpu_75 + gpu_low, cpu_75 + cpu_low):
        check(same_live(g, c), "GPU and CPU results differ on the bench workload")
    batch_eq = True
    for i in range(4):
        single = det.match_arrays(frames[i], depths[i], LOW_THRESHOLD, cid)
        batch_eq &= all(torch.equal(b[i], s) for b, s in zip(batch, single))
    check(batch_eq, "match_batch_arrays differs from single-frame calls")
    emit(
        "match_vga", t0, launches=launches, refine_calls=len(calls),
        live_into_kernel=live_in, thresholds=[75.0, LOW_THRESHOLD],
        live_out_75=[int((m[3] >= 0).sum()) for m in gpu_75],
        live_out_low=[int((m[3] >= 0).sum()) for m in gpu_low],
        matches_75=[len(m) for m in matches], gpu_equals_cpu=True, batch4_equals_single=True,
    )
    return calls, launches


def _random_case(rng, dev, c, h, w, t, k, f, with_scale, b=None):
    lead = (k,) if b is None else (b, k)
    maps = rng.integers(0, 5, ((c, h, w) if b is None else (b, c, h, w))).astype(np.uint8)
    feats = np.stack(
        [rng.integers(0, 120, lead + (f,)), rng.integers(0, 150, lead + (f,)), rng.integers(0, c, lead + (f,))], -1
    ).astype(np.int32)
    valid = rng.random(lead + (f,)) < 0.9
    org = (rng.integers(0, min(h, w) // t - 8, lead + (2,)) * t).astype(np.int32)
    case = dict(maps=maps, feats=feats, valid=valid, origins=org, t=t, window=16, scale=None, active=None)
    if with_scale:
        case["scale"] = rng.uniform(0.4, 1.3, lead).astype(np.float32)
    return {n: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v for n, v in case.items()}


def _run(fn, c):
    return fn(c["maps"], c["feats"], c["valid"], c["origins"], c["t"], c["window"], c["scale"], c["active"])


def phase_kernel_parity(dev, calls):
    t0 = time.perf_counter()
    rng = np.random.default_rng(42)
    cases = {
        "vga_t5_K16_F64_scale": _random_case(rng, dev, 16, 480, 640, 5, 16, 64, True),
        "production_pool_K1020_F136_scale": _random_case(rng, dev, 16, 480, 640, 5, 1020, 136, True),
        "batch4_vga_t5_K16_F64_scale": _random_case(rng, dev, 16, 480, 640, 5, 16, 64, True, b=4),
    }
    wide = _random_case(rng, dev, 16, 480, 640, 4, 64, 120, False)  # s2d width 160, as v1 took
    wide["window"] = 11
    cases["vga_t4_K64_F120_window11"] = wide
    act = _random_case(rng, dev, 8, 128, 128, 4, 8, 16, False)
    act["valid"][:, 10:] = False  # padded tails
    act["active"] = torch.tensor([True, False] * 4, device=dev)
    cases["active_t4_K8_F16_tails"] = act
    cases["main_path_B1"] = next(c for c in calls if c["maps"].shape[0] == 1)
    cases["main_path_B4"] = next(c for c in calls if c["maps"].shape[0] == 4)
    results = {}
    max_err = 0.0
    for name, c in cases.items():
        ks, kc = _run(LR.similarity_local_sparse_cuda, c)
        ps, pc = _run(similarity_local_sparse, c)
        torch.cuda.synchronize()
        err = float((ks - ps).abs().max()) if ks.numel() else 0.0
        exact = torch.equal(ks, ps) and torch.equal(kc, pc)
        results[name] = {"shape": list(ks.shape), "exact": exact, "max_abs_err": err}
        max_err = max(max_err, err)
        check(exact, f"kernel differs from its plain version in case {name}")
    emit("kernel_parity", t0, tolerance="exact (sums of small integers in float32)", cases=results)
    return max_err


def phase_match_golden(dev):
    t0 = time.perf_counter()
    g = np.load(os.path.join(TESTDATA, "planted_golden.npz"))
    cfg = DetectorConfig(t_at_level=tuple(int(v) for v in g["t_at_level"]))
    det = Detector.read_classes(os.path.join(TESTDATA, "planted_bank.npz"), cfg, device=dev)
    rgb, depth = synthetic.planted_scene(*(int(v) for v in g["scene_xy"]), seed=int(g["scene_seed"]))
    out = det.match_arrays(rgb, depth, float(g["threshold"]), "planted")
    golden = [g[k] for k in ("tid", "x", "y", "score", "keep")]
    check(same_live(golden, out), "GPU result differs from the JAX golden")
    tid, x, y, score, keep = (a.cpu().numpy() for a in out)
    top = int(np.flatnonzero(keep & (score >= 0))[0])
    check((int(tid[top]), int(x[top]), int(y[top])) == (0, *(int(v) for v in g["expected_xy"])),
          "top match is not the planted object")
    emit("match_golden", t0, equals_jax=True, top_match=[int(tid[top]), int(x[top]), int(y[top]), float(score[top])],
         planted=[int(v) for v in g["expected_xy"]], live=int((score >= 0).sum()))


def cuda_ms(fn, reps: int, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_ms(fn, reps: int, inner: int) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph and
    replayed back to back, median over ``reps`` CUDA-event windows.  Unlike
    ``cuda_ms`` this leaves out the host's launch overhead between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, reps) / inner


def refine_bound(c) -> dict:
    """Least bytes and operations of one local-refine call on these inputs:
    the map bytes its live in-range windows touch, the feature tables and
    the outputs, each once; one add per touched window cell."""
    single = c["maps"].dim() == 3
    maps, feats, valid, origins, active = (
        x[None] if single else x for x in (c["maps"], c["feats"], c["valid"], c["origins"], c["active"])
    )
    b, ch, h, w = maps.shape
    t, win = c["t"], c["window"]
    hb, wb = -(-h // t), -(-w // t)
    ok, cprime, by, bx = _feature_table(feats, valid, origins, t, hb, wb, None)
    ok = ok & active[..., None]
    chan, dy, dx = cprime // (t * t), (cprime % (t * t)) // t, cprime % t
    steps = torch.arange(win, device=maps.device)
    rows = (by[..., None] + steps) * t + dy[..., None]  # (B, K, F, win)
    cols = (bx[..., None] + steps) * t + dx[..., None]
    cell = ok[..., None, None] & (rows[..., :, None] < h) & (cols[..., None, :] < w)
    frame = torch.arange(b, device=maps.device).view(b, 1, 1, 1, 1)
    addr = (((frame * ch + chan[..., None, None]) * h + rows[..., :, None]) * w + cols[..., None, :]).long()
    touched = torch.zeros(maps.numel(), dtype=torch.bool, device=maps.device)
    touched[addr[cell]] = True
    k, f = feats.shape[1:3]
    table_bytes = b * k * (f * 12 + f + 8 + 1)
    out_bytes = b * k * (win * win * 4 + 4)
    nbytes = int(touched.sum()) + table_bytes + out_bytes
    ops = int(cell.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_timing(dev, cid, det, frames, depths, calls):
    t0 = time.perf_counter()
    bank = det.device_bank(cid)
    rgb1 = torch.from_numpy(frames[0]).to(dev)
    dep1 = torch.from_numpy(depths[0].astype(np.int32)).to(dev)
    rgb4 = torch.from_numpy(frames).to(dev)
    dep4 = torch.from_numpy(depths.astype(np.int32)).to(dev)
    frame_b1 = cuda_ms(lambda: detect_frame_core(rgb1, dep1, bank, BENCH_CFG, 75.0), reps=20)
    frame_b4 = cuda_ms(lambda: detect_frame_core(rgb4, dep4, bank, BENCH_CFG, 75.0), reps=10) / 4

    # The kernel at the main path's level-0 call, threshold LOW_THRESHOLD
    # (the last single-frame call recorded), its plain version and the
    # grouped conv of similarity_local on the same inputs.
    c = [c for c in calls if c["maps"].shape[0] == 1][-1]
    c = {n: v[0] if isinstance(v, torch.Tensor) else v for n, v in c.items()}  # the frame's (C, H, W) call
    kern_eager_ms = cuda_ms(lambda: _run(LR.similarity_local_sparse_cuda, c), reps=7, inner=100)
    kern_ms = graph_ms(lambda: _run(LR.similarity_local_sparse_cuda, c), reps=7, inner=100)
    plain_ms = graph_ms(lambda: _run(similarity_local_sparse, c), reps=7, inner=10)
    # One PyTorch call computing the same function: the grouped conv of
    # similarity_local over the candidates' template kernels.  The recorded
    # feature lists are rows of the bank's level-0 lists; matching them
    # recovers each candidate's template id.
    rows_equal = (c["feats"][:, None] == bank.feats[0][None]).all(-1).all(-1)  # (K, N)
    kernels_sel = bank.kernels[0][rows_equal.to(torch.int8).argmax(dim=1)]
    lhs, rhs = _local_conv_operands(c["maps"], kernels_sel, c["origins"], c["t"], c["window"])
    lib_ms = graph_ms(lambda: torch.nn.functional.conv2d(lhs, rhs, groups=rhs.shape[0]), reps=7, inner=3)
    live = c["active"]
    lib_scores = similarity_local(c["maps"], kernels_sel, c["origins"], c["t"])
    check(torch.equal(lib_scores[live], _run(LR.similarity_local_sparse_cuda, c)[0][live]),
          "the grouped conv disagrees with the kernel on live candidates")
    bound = refine_bound(c)
    emit(
        "timing", t0, nvidia_smi=nvidia_smi(),
        detect_frame_core_ms_per_frame={"B1": frame_b1, "B4": frame_b4},
        refine_shapes={"maps": list(c["maps"].shape), "feats": list(c["feats"].shape),
                       "live": int(live.sum()), "t": c["t"]},
        refine_ms={"kernel": kern_ms, "kernel_eager_launches": kern_eager_ms, "plain": plain_ms,
                   "library_grouped_conv": lib_ms},
        bound=bound,
        method=("CUDA events, medians; detect_frame_core: whole eager calls; refine: 100 (kernel), "
                "10 (plain) or 3 (conv) calls replayed from one CUDA graph per window, warm L2 as on the "
                "main path; kernel_eager_launches: the same 100 launches issued from Python"),
    )
    return kern_ms, plain_ms, lib_ms, bound


def phase_profile(dev, cid, det, frames, depths, n: int = 5):
    """Where a B=1 frame's time goes: torch.profiler over ``n`` frames of
    ``detect_frame_core`` after warm-up.  Device time is the sum of kernel
    self times (one stream, so they do not overlap); the idle share is the
    rest of the profiled wall time, which the profiler itself lengthens."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    bank = det.device_bank(cid)
    rgb = torch.from_numpy(frames[0]).to(dev)
    dep = torch.from_numpy(depths[0].astype(np.int32)).to(dev)
    for _ in range(3):
        detect_frame_core(rgb, dep, bank, BENCH_CFG, 75.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(n):
            detect_frame_core(rgb, dep, bank, BENCH_CFG, 75.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3 / n
    rows = prof.key_averages()
    dev_rows = [r for r in rows if r.device_type == DeviceType.CUDA]
    cpu_rows = [r for r in rows if r.device_type == DeviceType.CPU]

    def dev_us(r):
        return getattr(r, "self_device_time_total", 0.0)

    device_ms = sum(dev_us(r) for r in dev_rows) / 1e3 / n
    top_dev = sorted(dev_rows, key=dev_us, reverse=True)[:8]
    top_cpu = sorted(cpu_rows, key=lambda r: r.self_cpu_time_total, reverse=True)[:8]
    emit(
        "profile", t0, frames=n, wall_ms_per_frame_profiled=wall_ms, device_ms_per_frame=device_ms,
        device_idle_share=1.0 - device_ms / wall_ms if wall_ms else None,
        kernel_launches_per_frame=sum(r.count for r in dev_rows) / n,
        top_device=[[r.key[:70], dev_us(r) / 1e3 / n, r.count / n] for r in top_dev],
        top_cpu_self=[[r.key[:70], r.self_cpu_time_total / 1e3 / n, r.count / n] for r in top_cpu],
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("env", t0, python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), device_count=torch.cuda.device_count(), nvidia_smi=smi,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.perf_counter()
    built = _build.build()
    emit("build", t0, kernels={
        n: {"seconds": round(b["seconds"], 3),
            "ptxas": [ln.strip() for ln in b["log"].splitlines() if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]}
        for n, b in built.items()
    })

    cid, det, det_cpu, frames, depths = bench_detectors(dev)
    calls, launches = phase_match_vga(dev, cid, det, det_cpu, frames, depths)
    max_err = phase_kernel_parity(dev, calls)
    phase_match_golden(dev)
    kern_ms, plain_ms, lib_ms, bound = phase_timing(dev, cid, det, frames, depths, calls)
    phase_profile(dev, cid, det, frames, depths)

    print(json.dumps({"kernels": [{
        "name": "local_refine",
        "route": "cuda",
        "source": "sixdpose_tpu_torch/csrc/local_refine.cu",
        "replaces": REPLACES,
        "launches": launches,
        "exact_vs_plain": True,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": lib_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
