"""Timing and profiling utilities.

Port of the JAX package's ``utils/timing.py``: a host wall-clock stage
timer (the reference's observability is ad-hoc wall-clock prints, test.cpp:
125-130, Timer_lchf in forest.h:19-36), ``torch.profiler`` traces, and a
``block`` that waits for the tensors' devices.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class StageTimer:
    """Accumulating wall-clock stage timer (Timer_lchf analog).

    >>> timer = StageTimer()
    >>> with timer("match"):
    ...     run_match()
    >>> timer.report()
    """

    def __init__(self, sync=None):
        """``sync``: optional callable run before each stop (e.g. ``block``
        on the outputs) so device work is counted."""
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None and result is not None:
                self._sync(result)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self, name: str) -> float:
        return 1000.0 * self.totals[name] / max(self.counts.get(name, 0), 1)

    def report(self) -> str:
        lines = [
            f"{name:<24s} {self.mean_ms(name):9.3f} ms x {self.counts[name]}"
            for name in sorted(self.totals, key=lambda n: -self.totals[n])
        ]
        out = "\n".join(lines)
        print(out)
        return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the host and, when there is one, the card,
    written as a Chrome/Perfetto trace into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree):
    """Wait until the work producing every tensor in a (nested list, tuple or
    dict) tree is done on its device (for timing)."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree
