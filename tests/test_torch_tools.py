"""The port's SIXD tool twins over a mini-SIXD tree, on the CPU, against the
JAX package.

The tree is tests/test_tools.py's: one box object, one test scene of two
rendered images at known poses.  The twins run in this process,
``train_templates`` -> ``detect_sixd`` -> ``calc_gt_stats`` ->
``eval_calc_errors`` -> ``eval_loc``, through their ``main`` with the JAX
tools' flags (and ``--device cpu``); the recall must be 1.0, as the JAX
chain gives.  Then the files are checked both ways: the port's bank loads
in JAX's ``Detector.read_classes`` and back, JAX's ``eval.loc`` gives the
port's errors (ADI to 1e-5 relative, float32 sums in another order, as
tests/test_torch_eval.py holds them) and scores from the same files,
JAX's ``calc_gt_stats`` computation gives the port's ``visib_fract``, and
JAX's ``vis_poses`` writes the port's overlay PNGs byte for byte.
"""

import contextlib
import io
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")

from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.data import get_dataset_params as jget_dataset_params
from sixdpose_tpu.data import inout as jinout
from sixdpose_tpu.eval import loc as jloc
from sixdpose_tpu.models.detector import Detector as JDetector
from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.data import inout
from sixdpose_tpu_torch.eval.misc import model_diameter
from sixdpose_tpu_torch.geometry.render import render
from sixdpose_tpu_torch.geometry.view_sampler import sample_views
from sixdpose_tpu_torch.models.detector import Detector, detect_frame_core
from sixdpose_tpu_torch.tools import (
    bench_local_refine,
    bench_stage_breakdown,
    calc_gt_stats,
    detect_sixd,
    eval_calc_errors,
    eval_loc,
    train_templates,
    vis_poses,
)
from sixdpose_tpu_torch.tools.eval_loc import localization_scores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = np.array([[240.0, 0, 120.0], [0, 240.0, 90.0], [0, 0, 1.0]])
IMW, IMH = 240, 180
TWINS = ("train_templates", "detect_sixd", "calc_gt_stats", "eval_calc_errors", "eval_loc",
         "bench_multiscale_multiclass", "bench_scaling", "vis_poses", "bench_stage_breakdown", "bench_local_refine",
         "check_poses_tless", "tless_download")
JAX_TOOL = {"bench_local_refine": "bench_pallas_refine"}  # the port's twin by the JAX tool it answers


def _box_model():
    half = np.array([30.0, 20.0, 12.0])
    pts = np.array([[sx * half[0], sy * half[1], sz * half[2]] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    quads = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4), (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    colors = np.stack([100 + 155 * (pts[:, 0] > 0), 100 + 155 * (pts[:, 1] > 0), 100 + 155 * (pts[:, 2] > 0)],
                      1).astype(np.uint8)
    return {"pts": pts, "faces": np.array(faces), "colors": colors}


def _mini_sixd(root):
    """tests/test_tools.py's tree, rendered by the port."""
    model = _box_model()
    os.makedirs(os.path.join(root, "models"))
    inout.save_ply(os.path.join(root, "models", "obj_01.ply"), model)
    with open(os.path.join(root, "models", "models_info.yml"), "w") as f:
        yaml.dump({1: {"diameter": float(model_diameter(model["pts"]))}}, f)
    with open(os.path.join(root, "camera.yml"), "w") as f:
        yaml.dump({"fx": 240.0, "fy": 240.0, "cx": 120.0, "cy": 90.0, "width": IMW, "height": IMH,
                   "depth_scale": 1.0}, f)
    views, _ = sample_views(8, radius=430.0, elev_range=(0.3, 1.2), tilt_range=(0, 0.1), tilt_step=1.0)
    scene = os.path.join(root, "test", "01")
    os.makedirs(os.path.join(scene, "rgb"))
    os.makedirs(os.path.join(scene, "depth"))
    info, gt = {}, {}
    for im_id, view in enumerate(views[:2]):
        R = view["R"]
        t = view["t"] + np.array([[10.0], [-5.0], [15.0]])
        rgb, depth = render(model, (IMW, IMH), K, R, t, mode="rgb+depth", device="cpu")
        inout.save_im(os.path.join(scene, "rgb", f"{im_id:04d}.png"), rgb.numpy())
        inout.save_depth(os.path.join(scene, "depth", f"{im_id:04d}.png"), depth.numpy().astype(np.uint16))
        info[im_id] = {"cam_K": K}
        gt[im_id] = [{"obj_id": 1, "cam_R_m2c": R, "cam_t_m2c": t}]
    inout.save_info(os.path.join(scene, "info.yml"), info)
    inout.save_gt(os.path.join(scene, "gt.yml"), gt)


def _run(main, args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(args) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sixd"))
    root = os.path.join(work, "hinterstoisser")
    _mini_sixd(root)
    base = ["--dataset", "hinterstoisser", "--base-path", work]
    cpu = ["--device", "cpu"]
    p = {k: os.path.join(work, k) for k in ("banks", "results", "eval")}
    p["stats"] = os.path.join(root, "test_gt_stats")
    p["root"], p["base"] = root, base
    _run(train_templates.main, base + ["--objects", "1", "--radii", "430", "--min-views", "60", "--max-feats", "24",
                                       "--im-size", str(IMW), str(IMH), "--out", p["banks"]] + cpu)
    _run(detect_sixd.main, base + ["--scenes", "1", "--banks", p["banks"], "--threshold", "60", "--out", p["results"]] + cpu)
    _run(calc_gt_stats.main, base + ["--scenes", "1", "--delta", "15", "--out", p["stats"]] + cpu)
    _run(eval_calc_errors.main, base + ["--results", p["results"], "--error", "adi", "--out", p["eval"]] + cpu)
    p["errors"] = os.path.join(p["eval"], "error=adi_ntop=1")
    p["loc_out"] = _run(eval_loc.main, base + ["--errors", p["errors"]])
    return p


def test_chain_gives_recall_one(chain):
    assert os.path.exists(os.path.join(chain["banks"], "obj_01.npz"))
    assert sorted(os.listdir(os.path.join(chain["results"], "01"))) == ["0000_01.yml", "0001_01.yml"]
    assert os.path.exists(os.path.join(chain["errors"], "errors_01.yml"))
    out = chain["loc_out"]
    assert "== LINEMOD split (scene == obj) ==" in out
    assert float(out.split("total recall")[1].split()[0]) == 1.0, out


def test_port_bank_loads_in_jax_and_back(chain, tmp_path):
    path = os.path.join(chain["banks"], "obj_01.npz")
    port = Detector.read_classes(path, DetectorConfig(), device="cpu")
    jdet = JDetector.read_classes(path, JConfig())
    jpath = str(tmp_path / "jax_written.npz")
    jdet.write_classes(jpath)
    back = Detector.read_classes(jpath, DetectorConfig(), device="cpu")
    assert port.class_ids() == jdet.class_ids() == back.class_ids() == ["obj_01"]
    n = port.num_templates("obj_01")
    assert n > 0 and jdet.num_templates("obj_01") == back.num_templates("obj_01") == n
    for other in (jdet, back):
        for a, b in zip(port.bank.templates["obj_01"], other.bank.templates["obj_01"]):
            for la, lb in zip(a, b):
                np.testing.assert_array_equal(la.features, lb.features)
                assert (la.width, la.height, la.pyramid_level) == (lb.width, lb.height, lb.pyramid_level)
        for ia, ib in zip(port.bank.infos["obj_01"], other.bank.infos["obj_01"]):
            np.testing.assert_array_equal(ia["cam_R_w2c"], ib["cam_R_w2c"])


def test_jax_errors_equal_the_ports_from_the_same_results(chain):
    dp = jget_dataset_params("hinterstoisser", base_path=os.path.dirname(chain["root"]))
    gts = jinout.load_gt(dp["scene_gt_mpath"].format(1))
    info = jinout.load_info(dp["scene_info_mpath"].format(1))
    model = jinout.load_ply(dp["model_mpath"].format(1))
    port = inout.load_errors(os.path.join(chain["errors"], "errors_01.yml"))
    assert len(port) == 2
    for e in port:
        res = jinout.load_results_sixd17(os.path.join(chain["results"], "01", f"{e['im_id']:04d}_01.yml"))
        (want,) = jloc.calc_errors(res["ests"], gts[e["im_id"]], model, None, info[e["im_id"]]["cam_K"],
                                   error_type="adi")
        assert (e["est_id"], e["score"]) == (want["est_id"], float(want["score"]))
        np.testing.assert_allclose(e["errors"][0], want["errors"][0], rtol=1e-5)


def test_jax_scores_equal_the_ports_from_the_same_errors(chain):
    errors = jinout.load_errors(os.path.join(chain["errors"], "errors_01.yml"))
    gts = jinout.load_gt(os.path.join(chain["root"], "test", "01", "gt.yml"))
    with open(os.path.join(chain["root"], "models", "models_info.yml")) as f:
        diameter = float(yaml.safe_load(f)[1]["diameter"])
    with open(os.path.join(chain["stats"], "01_delta=15.yml")) as f:
        visib = {int(im): [g["visib_fract"] for g in lst] for im, lst in yaml.safe_load(f).items()}
    errs_by_im = {}
    for e in errors:
        errs_by_im.setdefault(e["im_id"], {}).setdefault(e["obj_id"], []).append(e)
    matches = jloc.match_scene(gts, visib, errs_by_im, 1, {1: 0.1 * diameter})
    want = jloc.calc_scores([1], [1], matches, 1)
    got = localization_scores([(1, errors, gts, visib)], "adi", {1: diameter}, hinterstoisser=True)
    assert got["all"] == want
    assert got["linemod"] == jloc.calc_scores([1], [1], jloc.split_hinterstoisser(matches)[0], 1)
    assert want["total_recall"] == 1.0 and "occlusion" not in got


def test_gt_stats_equal_jax(chain, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["calc_gt_stats.py", "--dataset", "hinterstoisser", "--base-path",
                                      os.path.dirname(chain["root"]), "--scenes", "1", "--out", str(tmp_path)])
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(REPO, "tools", "calc_gt_stats.py"), run_name="__main__")
    assert done.value.code == 0
    with open(tmp_path / "01_delta=15.yml") as f:
        want = yaml.safe_load(f)
    with open(os.path.join(chain["stats"], "01_delta=15.yml")) as f:
        got = yaml.safe_load(f)
    assert got == want
    assert all(0.9 < g["visib_fract"] <= 1.0 for lst in got.values() for g in lst)


@pytest.mark.parametrize("name", TWINS)
def test_twin_takes_the_jax_tools_flags(name):
    flag = re.compile(r"add_argument\(\s*\"(--[a-z-]+)\"")
    jax_flags = set(flag.findall(open(os.path.join(REPO, "tools", f"{JAX_TOOL.get(name, name)}.py")).read()))
    port_flags = set(flag.findall(open(os.path.join(REPO, "sixdpose_tpu_torch", "tools", f"{name}.py")).read()))
    # The JAX multi-scale sweep's table budget, the TPU timing modes and
    # chain lengths, and the Pallas variants have no counterpart: the port
    # builds its coarse weights per frame, times the card with CUDA events
    # and has one refine kernel.
    absent = {"bench_multiscale_multiclass": {"--budget-gb", "--fused-budget-gb"},
              "bench_scaling": {"--platform", "--chained"}, "bench_stage_breakdown": {"--k"},
              "bench_local_refine": {"--variants"}}.get(name, set())
    assert jax_flags - absent <= port_flags, sorted(jax_flags - absent - port_flags)


@pytest.mark.parametrize("mode", ["gt", "results"])
def test_vis_poses_pngs_equal_jax(chain, tmp_path, monkeypatch, mode):
    """The ground-truth or estimated poses' overlays: the port's PNGs equal
    the JAX tool's, byte for byte (its ``main`` under a patched argv)."""
    args = chain["base"] + ["--scene", "1"] + (["--results", chain["results"]] if mode == "results" else [])
    jax_main = runpy.run_path(os.path.join(REPO, "tools", "vis_poses.py"))["main"]
    monkeypatch.setattr(sys, "argv", ["vis_poses.py"] + args + ["--out", str(tmp_path / "jax")])
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_main() == 0
    _run(vis_poses.main, args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["01_0000.png", "01_0001.png"] == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
        vis = inout.load_im(str(tmp_path / "port" / name))
        rgb = inout.load_im(os.path.join(chain["root"], "test", "01", "rgb", name[3:]))
        assert (vis != rgb).any(axis=-1).sum() > 500  # the box's silhouette is drawn


def test_stage_breakdown_twin_prints_the_jax_keys(tmp_path):
    """At four templates of the bench bank on a 128 x 160 crop: one JSON
    line with the JAX tool's keys and stage names, and its ``--out``."""
    names = re.findall(r'\("(\w+)", s_\w+\)', open(os.path.join(REPO, "tools", "bench_stage_breakdown.py")).read())
    out = _run(bench_stage_breakdown.main, ["--device", "cpu", "--templates", "4", "--hw", "128", "160", "--reps", "1",
                                            "--repeats", "1", "--out", str(tmp_path / "stages.json")])
    line = json.loads(out.strip().splitlines()[-2])
    assert set(line) == {"prefix_ms", "stage_ms", "fps_full"}
    assert list(line["prefix_ms"]) == list(line["stage_ms"]) == names == list(bench_stage_breakdown.STAGES)
    assert json.loads((tmp_path / "stages.json").read_text())["provenance"]["backend"] == "cpu"


def test_stage_breakdown_prefixes_end_in_detect_frame_core():
    """The last prefix is ``detect_frame_core``'s frame, and the refine
    prefix's candidates, sorted as the core sorts them, are its candidates."""
    rgb, dep, bank = bench_stage_breakdown.workload("cpu", 4, (128, 160))
    stages = bench_stage_breakdown.prefixes(rgb, dep, bank, threshold=30.0)
    full = stages["full"]()
    want = detect_frame_core(rgb, dep, bank, bench_stage_breakdown.CFG, 30.0)
    assert all(torch.equal(a, b) for a, b in zip(full, want))
    tid, x, y, score = stages["refine"]()
    order = torch.argsort(-score, dim=-1, stable=True)
    assert all(torch.equal(torch.gather(a, -1, order), b) for a, b in zip((tid, x, y, score), want[:4]))
    assert (want[3] >= 0).any()


def test_local_refine_twin_prints_the_variant_line(tmp_path):
    """At K = 8, F = 16: the JAX tool's ``{"variant", "equivalent"}`` line
    (exact equality with the plain version), then the times and the bound."""
    out = _run(bench_local_refine.main, ["--device", "cpu", "--K", "8", "--F", "16", "--reps", "1",
                                         "--out", str(tmp_path / "refine.json")]).strip().splitlines()
    assert json.loads(out[0]) == {"variant": "local_refine", "equivalent": True}
    times = json.loads(out[1])
    assert {"kernel_ms", "plain_ms", "grouped_conv_ms", "bound_ms", "bound_by"} <= set(times)
    report = json.loads((tmp_path / "refine.json").read_text())
    assert report["grouped_conv_equal"] and report["bytes"] > 0
