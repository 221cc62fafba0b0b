"""Where a traced run's frames go, stage by stage: the program's
``sixdpose.*`` spans (``core/spans.py``) over one ``--trace 1`` run of a cell.

    python3 perfbench/stage_table.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a card.  Prints one JSON line: the run's
result, and per stage (the innermost span that enqueued the work; ``null``
outside every span) the kernels, copies and sets and the device time a
traced frame, the spans' host time a traced frame (under the profiler), and
the device's idle seconds over the traced frames by the innermost span open
when each gap began; beside them the enqueuing calls and device
activities counted by name, which pin ``core/spans.py``'s pairing.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter, defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.core.spans import PREFIX, innermost, stage_totals  # noqa: E402
from perfbench.core.trace import COPY_PREFIXES, Span, _union  # noqa: E402


def _idle_by_stage(trace) -> dict:
    gaps, t = [], trace.start_us
    for a, b in _union(trace.device, trace.start_us, trace.end_us):
        if a > t:
            gaps.append((t, a))
        t = b
    if trace.end_us > t:
        gaps.append((t, trace.end_us))
    spans = sorted((s for s in trace.host if s.name.startswith(PREFIX)), key=lambda s: s.start_us)
    out: dict = defaultdict(float)
    for (a, b), name in zip(gaps, innermost([Span("gap", a, b) for a, b in gaps], spans)):
        out[name[len(PREFIX):] if name else None] += (b - a) / 1e6
    return dict(out)


def table(trace, frames: int) -> dict:
    api = Counter(s.name for s in trace.host if s.name.startswith(("cuda", "cu")))
    acts = Counter(s.name.split("(")[0][:48] if s.name.startswith(COPY_PREFIXES)
                   else "kernel" for s in trace.device)
    out = {"frames": frames, "host_cuda_calls": dict(api.most_common()), "device_activities": dict(acts)}
    host: dict = defaultdict(float)
    for s in trace.host:
        if s.name.startswith(PREFIX):
            host[s.name[len(PREFIX):]] += (s.end_us - s.start_us) / 1e3
    try:
        totals = stage_totals(trace, frames) or {}
    except RuntimeError as e:
        out["error"] = str(e)
        totals = {}
    stages = {}
    for name in sorted(set(totals) | set(host), key=lambda n: -(totals.get(n, {}).get("device_ms", 0.0))):
        t = totals.get(name, {"kernels": 0, "device_ms": 0.0})
        stages[str(name)] = {"kernels_per_frame": t["kernels"] / frames, "device_ms_per_frame": t["device_ms"] / frames,
                             "span_host_ms_per_frame": host.get(name, 0.0) / frames}
    out["stages"] = stages
    out["idle_s_by_stage"] = {str(k): v for k, v in sorted(_idle_by_stage(trace).items(), key=lambda kv: -kv[1])}
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from perfbench.run import _environment

    _environment()
    import torch

    from perfbench.core import harness

    if not torch.cuda.is_available():
        print("stage_table: needs a CUDA card", file=sys.stderr)
        return 2
    seen = {}
    real = harness.Context

    def keep(*a, **k):  # the traced window's context, as the per-layer readers get it
        ctx = real(*a, **k)
        seen["table"] = table(ctx.trace, ctx.frames)
        return ctx

    harness.Context = keep
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, True, torch.device("cuda:0"), T_START)
    finally:
        harness.Context = real
    print(json.dumps({"result": result, "stage_table": seen["table"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
