"""Port parity of benchmark.py (the synthetic accuracy benchmark) against the
JAX package, on the CPU.

Against the golden of ``tools/torch_port_synth_golden.py`` (JAX's
``run_benchmark`` at a cut size: the box, the cup and the textured box, 60
views each, 240 x 180, three scenes).  Tolerance: exact.  The meshes are
equal arrays; the scenes the port composes from the same seed equal JAX's;
the bank it trains equals JAX's, file for file, and the cache knobs are the
same; and ``run_benchmark`` gives JAX's targets, hits, VSD hits and
per-object recall.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from sixdpose_tpu.benchmark import make_models as jax_make_models
from sixdpose_tpu_torch import benchmark as TB

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")
BANK = os.path.join(TESTDATA, "synth_bank.npz")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: these small tensors gain nothing from more, and
    the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    g = np.load(os.path.join(TESTDATA, "synth_golden.npz"))
    return g, json.loads(str(g["settings"])), json.loads(str(g["result"]))


@pytest.fixture
def cached_bank(tmp_path):
    path = str(tmp_path / "bank.npz")
    shutil.copy(BANK, path)
    shutil.copy(BANK + ".meta.json", path + ".meta.json")
    return path


def test_make_models_matches_jax():
    got, want = TB.make_models(), jax_make_models()
    assert list(got) == list(want)
    for cid in want:
        assert got[cid].keys() == want[cid].keys()
        for key in want[cid]:
            assert got[cid][key].dtype == want[cid][key].dtype
            np.testing.assert_array_equal(got[cid][key], want[cid][key], err_msg=f"{cid}.{key}")


def test_make_scene_matches_jax_golden(golden):
    g, settings, _ = golden
    models = {c: TB.make_models()[c] for c in settings["object_ids"]}
    im = tuple(settings["im_size"])
    rng = np.random.default_rng(settings["seed"])
    for si in range(settings["num_scenes"]):
        rgb, depth, gts = TB.make_scene(models, TB.benchmark_K(im), im, rng,
                                        max_objects=settings["max_objects_per_scene"], device="cpu")
        np.testing.assert_array_equal(rgb, g["rgb"][si])
        np.testing.assert_array_equal(depth, g["depth"][si])
        assert [gt["obj_id"] for gt in gts] == [str(c) for c in g["gt_obj"][si] if c]
        for gi, gt in enumerate(gts):
            np.testing.assert_array_equal(gt["R"], g["gt_R"][si, gi])
            np.testing.assert_array_equal(gt["t"].ravel(), g["gt_t"][si, gi])


def test_train_benchmark_bank_writes_the_jax_bank(golden, tmp_path):
    """Trained from scratch, the port's bank cache equals the one the JAX
    package wrote: the same npz arrays and infos, the same knobs."""
    _, settings, _ = golden
    models = {c: TB.make_models()[c] for c in settings["object_ids"]}
    im = tuple(settings["im_size"])
    path = str(tmp_path / "bank.npz")
    det, train_s = TB.train_benchmark_bank(models, TB.benchmark_K(im), im, settings["min_n_views"],
                                           TB.benchmark_config(settings["top_k"]), path, verbose=False, device="cpu")
    assert train_s > 0 and det.num_templates() == 180
    with open(path + ".meta.json") as f, open(BANK + ".meta.json") as g:
        assert json.load(f) == json.load(g)
    with np.load(path, allow_pickle=True) as a, np.load(BANK, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            if key.startswith("info|"):
                for ia, ib in zip(a[key], b[key]):
                    assert ia.keys() == ib.keys()
                    for f in ib:
                        va, vb = np.asarray(ia[f]), np.asarray(ib[f])
                        assert va.dtype == vb.dtype and np.array_equal(va, vb), (key, f)
            else:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_run_benchmark_matches_jax_golden(golden, cached_bank):
    _, settings, want = golden
    got = TB.run_benchmark(bank_cache=cached_bank, verbose=False, device="cpu", **settings)
    for key in ("targets", "hits", "hits_vsd", "recall", "recall_vsd", "per_object"):
        assert got[key] == want[key], key
    assert got["train_time_s"] == 0.0  # the JAX package's cache serves the port
    assert got["detect_refine_s_per_frame"] > 0 and "device_ms_per_frame" not in got  # no CUDA events on the CPU


def test_cli_prints_the_result_json(golden, cached_bank, capsys):
    _, settings, _ = golden
    rc = TB.main(["--scenes", "1", "--views", str(settings["min_n_views"]), "--objects", *settings["object_ids"],
                  "--bank-cache", cached_bank, "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["targets"] > 0 and set(out["per_object"]) == set(settings["object_ids"])
    assert out["provenance"]["config"]["device"] == "cpu" and "backend" not in out["provenance"]
