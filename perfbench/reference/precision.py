"""The precision the reference computes in.

The program states float32 for its scores and its ICP.  The control of
the benchmark's check (``run.py --control 1``) is this reference computed
a step lower, in bfloat16: ``set_precision("bfloat16")`` makes
``rounded`` round each operand it is given to bfloat16 (the scores as
they are normalized, ICP's clouds, scene maps and seeds as it starts),
which the check has to see as not correct.
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
_state = {"dtype": None}


def set_precision(name: str) -> None:
    """Compute the reference's float32 steps in ``name``'s precision
    ("float32" or "bfloat16")."""
    _state["dtype"] = _DTYPES[name]


def rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the precision set, in its own dtype."""
    dt = _state["dtype"]
    return x if dt is None else x.to(dt).to(x.dtype)
