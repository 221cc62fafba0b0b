"""The check that nothing of JAX reaches the benchmark's process."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "sixdpose_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's, jaxlib's, flax's or the JAX package's:
    ``sixdpose_tpu_torch`` is not ``sixdpose_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
