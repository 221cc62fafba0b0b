"""The port imports neither JAX nor the JAX package.

In a subprocess whose ``sys.meta_path`` refuses ``jax``, ``jaxlib`` and
``sixdpose_tpu`` (exact top-level names: ``sixdpose_tpu_torch`` shares the
prefix and must still import), every module of the port and
``chip_smoke`` must import.  The sources must not name them either.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sixdpose_tpu_torch")

BLOCKER = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "sixdpose_tpu"}

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
print("imported", len(names), "modules and chip_smoke")
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKER], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "chip_smoke" in out.stdout


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|sixdpose_tpu)(\s|\.|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders, offenders
