"""The port's T-LESS tool twins against the JAX package's tools, on the CPU.

- ``check_poses_tless``: on the mini T-LESS tree of tests/test_tless_tools.py
  (one box object, two rendered primesense images with T-LESS's 0.1 mm
  depth units) and on a train split built the same way, both tools run with
  ``--im-step 1`` (the JAX tool's ``main`` under a patched argv, the twin's
  with ``--torch-device cpu``): the same files, byte for byte.
- ``tless_download``: the ``--manifest`` file and the printed list equal the
  JAX tool's for the arguments of tests/test_tless_tools.py; offline, the
  checksum check refuses a tampered archive, the safe extraction refuses an
  entry that climbs out of its directory, and a good archive unpacks.
"""

import contextlib
import hashlib
import io
import os
import runpy
import shutil
import sys
import zipfile

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from sixdpose_tpu_torch.data import inout
from sixdpose_tpu_torch.tools import check_poses_tless, tless_download
from tests.test_tless_tools import mini_tless  # noqa: F401  (the JAX tests' fixture)
from tests.test_tools import IMH, IMW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name: str, argv: list, monkeypatch) -> str:
    """Run the JAX package's ``tools/<name>.py`` ``main`` in this process;
    returns what it printed."""
    main = runpy.run_path(os.path.join(REPO, "tools", f"{name}.py"))["main"]
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main() == 0
    return out.getvalue()


def _twin(main, argv: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def tless_root(mini_tless):  # noqa: F811
    """The mini tree with a train split: its one scene copied as object 1
    of ``train_primesense`` (the same layout: rgb/, depth/, info.yml,
    gt.yml)."""
    shutil.copytree(os.path.join(mini_tless, "test_primesense", "01"),
                    os.path.join(mini_tless, "train_primesense", "01"), dirs_exist_ok=True)
    return mini_tless


@pytest.mark.parametrize("split", ["test", "train"])
def test_check_poses_tless_pngs_equal_jax(tless_root, tmp_path, monkeypatch, split):
    args = ["--base-path", tless_root, "--split", split, "--device", "primesense", "--scenes", "1",
            "--im-step", "1"]
    printed = _jax_tool("check_poses_tless", args + ["--out", str(tmp_path / "jax")], monkeypatch)
    assert _twin(check_poses_tless.main, args + ["--out", str(tmp_path / "port"), "--torch-device", "cpu"]) == printed
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        f"01_primesense_cad_{i:04d}_{kind}.png" for i in (0, 1) for kind in ("depth_diff", "rgb")]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    vis = inout.load_im(str(tmp_path / "port" / names[1]))
    assert vis.shape == (IMH, IMW, 3) and vis.any()
    diff = inout.load_im(str(tmp_path / "port" / names[0]))
    nz = diff.any(axis=-1)
    assert nz.any() and (diff[nz][:, 1] > 200).mean() > 0.9  # exact poses: the near-agreement color


def test_depth_diff_units_and_colors():
    """T-LESS depth is in 0.1 mm: 9000 units over a 880 mm render is +20
    mm (blue side), 8600 is -20 mm (red side), past 50 mm saturates, and
    missing depth on either side is black."""
    raw = np.array([[9000, 8600, 9900, 0, 9000]], np.uint16)
    ren = np.array([[880.0, 880.0, 880.0, 880.0, 0.0]])
    img = check_poses_tless.depth_diff(raw, ren)
    g = int(255 * (1 - 20 / 50))
    np.testing.assert_array_equal(img[0], [[g, g, 255], [255, g, g], [0, 0, 255], [0, 0, 0], [0, 0, 0]])


MANIFEST_ARGS = ["--sensors", "primesense", "--objects", "1", "2", "--scenes", "3", "--model-types", "cad"]


def test_tless_download_manifest_equals_jax(tmp_path, monkeypatch):
    jax_out = _jax_tool("tless_download", ["--manifest", str(tmp_path / "jax.txt")] + MANIFEST_ARGS, monkeypatch)
    port_out = _twin(tless_download.main, ["--manifest", str(tmp_path / "port.txt")] + MANIFEST_ARGS)
    jax_lines = (tmp_path / "jax.txt").read_text().splitlines()
    assert (tmp_path / "port.txt").read_text().splitlines() == jax_lines
    assert len(jax_lines) == 4 and port_out.replace("port.txt", "jax.txt") == jax_out
    assert _twin(tless_download.main, MANIFEST_ARGS) == _jax_tool("tless_download", MANIFEST_ARGS, monkeypatch)


def _zip(path, entries: dict) -> str:
    with zipfile.ZipFile(path, "w") as zf:
        for name, data in entries.items():
            zf.writestr(name, data)
    return str(path)


def test_safe_extract_refuses_an_escaping_entry(tmp_path):
    bad = _zip(tmp_path / "bad.zip", {"ok.txt": b"a", "../escaped.txt": b"b"})
    with zipfile.ZipFile(bad) as zf, pytest.raises(RuntimeError, match="escapes dest"):
        tless_download._safe_extract(zf, str(tmp_path / "out"))
    assert not (tmp_path / "escaped.txt").exists() and not (tmp_path / "out" / "ok.txt").exists()


def test_fetch_checks_the_checksum_before_unpacking(tmp_path):
    """``fetch`` over a stand-in for the download: the archive whose sha256
    matches unpacks; the one that does not fails, is removed and leaves
    nothing unpacked."""
    urls = tless_download.build_urls(["primesense"], [1, 2], [], [])
    names = [os.path.basename(u) for u, _ in urls]
    srcs = {n: _zip(tmp_path / n, {f"{i + 1:02d}/rgb/0000.png": b"x"}) for i, n in enumerate(names)}
    digest = hashlib.sha256(open(srcs[names[0]], "rb").read()).hexdigest()

    def retrieve(url, zip_path):
        shutil.copy(srcs[os.path.basename(url)], zip_path)
        return url

    dest = tmp_path / "dest"
    dest.mkdir()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()) as err:
        failures = tless_download.fetch(urls, str(dest), {names[0]: digest, names[1]: "0" * 64}, retrieve=retrieve)
    assert failures == 1 and "sha256 mismatch" in err.getvalue() and names[1] in err.getvalue()
    split = dest / "t-less_v2" / "train_primesense"
    assert (split / "01" / "rgb" / "0000.png").read_bytes() == b"x" and not (split / "02").exists()
    assert not any(p.suffix == ".zip" for p in dest.iterdir())
