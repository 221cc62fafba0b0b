"""One run of one cell: set-up, warm-up, the measured or traced window, and
the check against the plain reference.

Everything that belongs to a cell is found by name under the benchmark's
root: the cell in ``BENCHMARK.json``, its configuration file, its traffic
mix ``perfbench/traffic/<mix>.json`` (whose ``driver`` names the program
entry it drives, ``perfbench/drivers/<driver>.py``), its limits
``perfbench/limits/<cell>.json``, and each per-layer metric's reader
``perfbench/metrics/<name with dots as underscores>.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import resource
import statistics
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench.core import generate, trace as T
from perfbench.core.guard import forbidden_modules
from perfbench.core.peaks import H100
from perfbench.reference.precision import set_precision

WINDOW_SPAN = "perfbench.window"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _reader(root: Path, name: str):
    path = root / "perfbench" / "metrics" / (name.replace(".", "_") + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_file).read_text())
    mix = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "perfbench" / "limits" / f"{name}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, config, mix, limits, [m for m in bench["end_to_end"] if _applies(m, name)], per_layer,
                {m["name"]: _reader(root, m["name"]) for m in per_layer})


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    trace: Optional[T.Trace]
    frames: int  # frames completed in the traced window
    frame_s: float  # mean seconds a frame of the untraced window took
    stages: dict  # the program's stage timers over the untraced window: name -> (s, count)
    refine_calls: list
    peaks: dict


def latency_stats(latencies_s: List[float], window_s: float) -> dict:
    """The closed loop's end-to-end numbers over every frame of a window:
    frames completed over the window's seconds, and the 90th percentile of
    the frames' latencies (ms)."""
    return {
        "frames_per_s": len(latencies_s) / window_s,
        "frame_ms_p90": 1000.0 * (statistics.quantiles(latencies_s, n=10, method="inclusive")[-1]
                                  if len(latencies_s) > 1 else latencies_s[0]),
    }


def closed_loop(frame, seconds: float):
    """One camera's closed loop: frame ``i`` is sent when frame ``i - 1``'s
    results are on the host, until ``seconds`` have passed.  Returns every
    frame's latency (s) and the window's length: from the first frame's
    hand-over to the last frame's results, so a stall anywhere in it
    counts."""
    lat, t0 = [], time.perf_counter()
    t_end, i = t0, 0
    while t_end - t0 < seconds:
        a = time.perf_counter()
        frame(i)
        t_end = time.perf_counter()
        lat.append(t_end - a)
        i += 1
    return lat, t_end - t0


class _RefineCalls:
    """Keeps the inputs of every local-refine call the program makes while
    active (the dispatch the matchers call, ``models/detector.py``)."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        from sixdpose_tpu_torch.models import detector as D

        self._mod, self._orig = D, D.similarity_local_sparse_auto

        def recorder(maps, feats, valid, origins, t, window=16, scale=None, active=None):
            self.calls.append(dict(maps=maps, feats=feats, valid=valid, origins=origins, t=t, window=window,
                                   scale=scale, active=active))
            return self._orig(maps, feats, valid, origins, t, window, scale, active)

        D.similarity_local_sparse_auto = recorder
        return self

    def __exit__(self, *exc):
        self._mod.similarity_local_sparse_auto = self._orig


def _stage_deltas(before: dict, after: dict) -> dict:
    """The stage timers' (seconds, count) added between two readings."""
    return {k: (v[0] - before.get(k, (0.0, 0))[0], v[1] - before.get(k, (0.0, 0))[1]) for k, v in after.items()}


def _cpu_s() -> float:
    """The process's host CPU seconds so far, every thread's."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def host_peak_gib() -> float:
    """The process's peak resident host memory (GiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # kB on Linux


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i",
                            str(device.index or 0)], capture_output=True, text=True, timeout=20)
        out["power_limit_w"] = float(q.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return out


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False) -> dict:
    """One run of cell ``name``.  Returns the contract's result (without
    printing it) with the numbers compared under ``check``."""
    cell = load_cell(Path(root), name)
    drv = importlib.import_module(f"perfbench.drivers.{cell.mix['driver']}")
    wl = generate.generate(cell.config, cell.mix, seed, device)
    pool = len(wl.frames)
    check_ids = generate.check_frames(cell.mix, seed)
    kept: Dict[int, list] = {f: [] for f in check_ids}
    attempted = failed = 0
    metrics: dict = {}
    extra: dict = {}
    prog = None
    if not control:
        prog = drv.Program(cell.config, cell.mix, wl, device)
        for i in range(cell.mix["warmup_frames"]):
            prog.step(*wl.frames[i % pool], keep=False)
        _sync(device)
        if forbidden_modules():
            raise RuntimeError(f"JAX modules loaded: {forbidden_modules()}")
        setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start

        def frame(idx):
            nonlocal attempted, failed
            attempted += 1
            try:
                out = prog.step(*wl.frames[idx], keep=idx in kept)
            except Exception as e:  # a frame that raises has failed; the rest of the window goes on
                failed += 1
                errors = extra.setdefault("errors", [])
                if len(errors) < 5:
                    errors.append(f"{type(e).__name__}: {e}")
                return
            if idx in kept:
                kept[idx].append(out)

        # The measured window.  A traced run measures it too, untraced, and
        # then traces a few frames: the profiler slows the host, so what
        # the host does a frame is read from the untraced window.
        first = cell.mix["warmup_frames"]
        before, cpu0 = prog.stages(), _cpu_s()
        lat, window_s = closed_loop(lambda i: frame((first + i) % pool), seconds)
        stages = _stage_deltas(before, prog.stages())
        stats = latency_stats(lat, window_s)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        half = len(lat) // 2
        extra.update(window_s=window_s, frames=len(lat), host_cpu_share=(_cpu_s() - cpu0) / window_s,
                     halves_ms=[1000.0 * statistics.fmean(lat[:half] or lat), 1000.0 * statistics.fmean(lat[half:])])
        if not trace:
            values = {"setup_s": setup_s, "device_mem_peak_gib": peak / 2**30, **stats}
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        else:
            from torch.profiler import ProfilerActivity, profile, record_function

            extra.update(stats)
            traced_before = attempted - failed
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with _RefineCalls() as rc, profile(activities=acts) as p:
                with record_function(WINDOW_SPAN):
                    t0 = time.perf_counter()
                    for j in range(cell.mix["trace_frames"]):
                        frame(check_ids[j % len(check_ids)])
                    _sync(device)
                    traced_s = time.perf_counter() - t0
            tr = T.from_profiler(p, WINDOW_SPAN)
            ctx = Context(tr, attempted - failed - traced_before, window_s / max(len(lat), 1), stages, rc.calls, H100)
            for m in cell.per_layer:
                v = cell.readers[m["name"]](ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            peak = max(peak, torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
            extra["busy_s"] = T.busy_s(tr) if tr is not None else 0.0
            extra["traced_s"] = traced_s
            extra["breakdown"] = {"device_ops": T.device_ops(tr) if tr else [], "idle_gaps": T.idle_gaps(tr) if tr else []}
            del rc, ctx, tr, p
        # A window too short to reach every checked frame (only a run far
        # shorter than the cell's) sends the rest once, after it has closed.
        for f in check_ids:
            if not kept[f]:
                frame(f)
        extra["memory_peak_bytes"] = max(setup_peak, peak)
        host = {f: [drv.host_outputs(o) for o in runs] for f, runs in kept.items() if runs}
        del prog, kept
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # The check, once the program's state is freed: the reference on the
    # checked frames (in control mode, also in bfloat16 in the program's place).
    if control:
        set_precision("bfloat16")
        low = drv.reference_frames(cell.config, wl, check_ids, device)
        set_precision("float32")
        host = {f: [low[f]] for f in check_ids}
        attempted = len(check_ids)
        extra["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    refs = drv.reference_frames(cell.config, wl, sorted(host), device)
    values = drv.compare(host, refs)
    check = {k: {"value": values[k], "limit": cell.limits[k]} for k in cell.limits}
    correct = (failed == 0 and attempted > 0 and bool(host) and all(c["value"] <= c["limit"] for c in check.values()))
    dev = card(device)
    dev["memory_peak_bytes"] = int(extra.get("memory_peak_bytes", 0))
    if trace:
        dev["busy_s"], dev["window_s"] = extra.get("busy_s", 0.0), extra.get("traced_s", 0.0)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace and "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    keys = ("frames", "window_s", "frames_per_s", "frame_ms_p90", "halves_ms", "host_cpu_share", "errors")
    result["info"] = {k: extra[k] for k in keys if k in extra}
    result["info"]["host_peak_gib"] = host_peak_gib()
    result["info"]["checked_frames"] = sorted(host)
    result["check"] = check
    return result
