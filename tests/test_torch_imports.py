"""The port imports neither JAX nor the JAX package.

In a subprocess whose ``sys.meta_path`` refuses ``jax``, ``jaxlib``,
``orbax`` and ``sixdpose_tpu`` (exact top-level names: ``sixdpose_tpu_torch`` shares the
prefix and must still import), every module of the port and
``chip_smoke`` must import, and none of them may import ``yaml`` or ``PIL``
at module import.  The sources must not name JAX either.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sixdpose_tpu_torch")

BLOCKER = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "orbax", "sixdpose_tpu"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

import sixdpose_tpu_torch
names = ["sixdpose_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(sixdpose_tpu_torch.__path__, "sixdpose_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
try:
    import sixdpose_tpu.config
except ImportError:
    pass
else:
    raise SystemExit("the blocker let sixdpose_tpu through")
eager = sorted({n.split(".")[0] for n in sys.modules} & {"yaml", "PIL"})
if eager:
    raise SystemExit(f"imported at module import: {eager}")
print("imported", len(names), "modules and chip_smoke:", " ".join(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKER], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "chip_smoke" in out.stdout
    for name in ("models.multiclass", "models.multiscale", "models.pipeline", "ops.scale_proposal", "ops.similarity",
                 "convert", "synthetic", "geometry.transform", "geometry.view_sampler", "geometry.render", "eval.misc",
                 "eval.pose_error", "eval.score", "eval.loc", "models.train", "utils.timing", "serving", "benchmark",
                 "lchf", "lchf.feature", "lchf.forest", "lchf.meanshift", "lchf.device", "lchf.model", "lchf.voting",
                 "lchf.pose", "lchf.eval", "lchf.pipeline", "data", "data.inout", "data.datasets", "utils.artifacts",
                 "seg", "seg.dasp", "seg.registration", "seg.slic", "ops.segment_sum", "ops.floyd_steinberg",
                 "parallel", "parallel.mesh", "parallel.distributed", "parallel.sharded_match", "parallel.tiled_match",
                 "parallel.rank_jobs", "parallel.fused", "tools", "tools.train_templates", "tools.detect_sixd",
                 "tools.calc_gt_stats", "tools.eval_calc_errors", "tools.eval_loc", "tools.bench_multiscale_multiclass",
                 "tools.bench_scaling", "tools.vis_poses", "tools.bench_stage_breakdown", "tools.bench_local_refine",
                 "tools.check_poses_tless", "tools.tless_download", "bench", "entry"):
        assert f"sixdpose_tpu_torch.{name}" in out.stdout.split(), name


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|sixdpose_tpu)(\s|\.|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders, offenders
