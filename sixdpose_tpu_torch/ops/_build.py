"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes``.  Libraries go to
``sixdpose_tpu_torch/_build/`` (git-ignored) under a name that carries a
hash of the source and the flags, so a changed source rebuilds and a fresh
checkout builds at first use, from the sources in the repository only.
Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> list:
    """Names of the kernels in ``csrc/`` (one shared library each)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built, keyed by a hash of
    the source and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = None) -> Dict[str, dict]:
    """Compile the named kernels (all of ``csrc/`` by default) that are not
    built yet, one ``nvcc`` per source, all started together.

    Returns per name ``{"path", "seconds", "log"}``; ``log`` holds what
    ``nvcc -Xptxas -v`` printed (registers, shared memory, spills).  Raises
    RuntimeError if a compile fails.
    """
    names = list(kernel_names() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    running = {}
    for name in names:
        lib = library_path(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            out[name] = {"path": str(lib), "seconds": 0.0,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, log, time.perf_counter())
    for name, (proc, tmp, lib, log, t0) in running.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{text}")
        os.replace(tmp, lib)
        log.write_text(text)
        out[name] = {"path": str(lib), "seconds": time.perf_counter() - t0, "log": text}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path = build([name])[name]["path"]
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]
