"""A benchmark root at a size that a CPU test run holds: the repository's
``BENCHMARK.json`` and data files, with the configurations cut to a few
classes of a few views and the mixes to a pool of four frames."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345  # larger than 32 signed bits hold, as the driver's are


def tiny_root(dst: Path) -> Path:
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "perfbench" / d, dst / "perfbench" / d)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name, classes in (("tless_30obj_720x540", 4), ("linemod_15obj_vga", 3)):
        edit(dst / "perfbench" / "configs" / f"{name}.json", classes=classes, views=12)
    for mix in ("served", "match"):
        edit(dst / "perfbench" / "traffic" / f"{mix}.json", pool=4, check_frames=2, warmup_frames=1, trace_frames=2,
             objects_per_frame=[2, 3])
    return dst


def edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))
