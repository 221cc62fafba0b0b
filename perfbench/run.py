"""The benchmark of the PyTorch and CUDA port (``sixdpose_tpu_torch``) on one
NVIDIA H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A run makes its bank and frames from the
seed, builds the program, warms up every shape (all counted in
``setup_s``), then measures a closed loop of frames for ``--seconds``
(``--trace 0``: the cell's end-to-end metrics).  With ``--trace 1`` it
measures the same window and then traces a few frames under
``torch.profiler`` (its per-layer metrics, the device's busy time and a
breakdown; what the host does a frame is read from the untraced window).
Once the window has closed and
the program's state is freed, it compares what the timed path produced on
the checked frames with the plain reference (``perfbench/reference``),
prints each compared number beside its limit on standard error, and prints
one JSON line last on standard output.

``--control 1`` puts the reference computed in bfloat16 in the program's
place (the check's control; no window, no program): its line has to read
``"correct": false``.

It exits with 2 and prints no result without a CUDA card, and with 3 if a
module of JAX or of the JAX package is loaded when the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / ".cache"


def _environment() -> None:
    """Fixed cache directories inside the checkout, few host threads, and
    no JAX through a library that would load it by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from perfbench.core.guard import forbidden_modules
    from perfbench.core.harness import run_cell

    chips = {w["name"]: w["chips"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
    need = chips.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"perfbench: needs {need} CUDA card(s), found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"), T_START,
                      control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of JAX or of the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
