"""Self-describing benchmark/accuracy artifacts.

A copy of the JAX package's ``utils/artifacts.py``: every JSON record
carries the git revision, dirty flag, the exact flags it was produced
with, and where JAX records its backend, the torch and CUDA versions and
the card's name, so provenance is checkable instead of asserted.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
from typing import Optional


def git_rev(repo_dir: Optional[str] = None) -> dict:
    """Current commit hash + dirty flag (empty strings if not a repo)."""
    repo_dir = repo_dir or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=repo_dir, capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        dirty = bool(
            subprocess.run(
                ["git", "status", "--porcelain"],
                cwd=repo_dir, capture_output=True, text=True, timeout=10,
            ).stdout.strip()
        )
        return {"rev": rev, "dirty": dirty}
    except Exception:
        return {"rev": "", "dirty": False}


def provenance(config: Optional[dict] = None, device=None) -> dict:
    """Stamp dict: git rev, UTC time, argv, the backend the record ran on
    (``device``'s type: CUDA unless ``"cpu"``), torch / CUDA versions, the
    cards, config flags."""
    import torch

    backend = torch.device("cuda" if device is None else device).type
    cuda = torch.cuda.is_available()
    devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if cuda else []
    return {
        "git": git_rev(),
        "generated_utc": datetime.datetime.now(
            datetime.timezone.utc
        ).isoformat(timespec="seconds"),
        "argv": sys.argv,
        "backend": backend,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": devices,
        "config": config or {},
    }


def write_artifact(path: str, result: dict, config: Optional[dict] = None, device=None) -> dict:
    """Write ``result`` + a provenance stamp to ``path`` (JSON).  Returns
    the stamped payload."""
    payload = dict(result)
    payload["provenance"] = provenance(config, device)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return payload
