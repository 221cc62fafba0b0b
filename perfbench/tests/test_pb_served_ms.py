"""The ``linemod.served`` cell on the CPU at a tiny size: the service's
multi-scale host route against its plain reference (``reference/served_ms.py``)
on seeded banks and frames, the bfloat16 control and broken routes as not
correct, and the cell, its traffic, driver and metrics found by name and run
end to end."""

import json
import time

import numpy as np
import pytest
import torch

import pb_tiny
from perfbench.core import generate
from perfbench.core.harness import load_cell, run_cell
from perfbench.drivers import served_ms
from perfbench.reference.precision import set_precision

CPU = torch.device("cpu")
CELL = "linemod.served"


def served_root(dst):
    root = pb_tiny.tiny_root(dst)
    pb_tiny.edit(root / "perfbench" / "configs" / "linemod_15obj_vga_served.json", classes=3, views=12)
    pb_tiny.edit(root / "perfbench" / "traffic" / "served_ms.json", pool=4, check_frames=2, warmup_frames=1,
                 trace_frames=2, objects_per_frame=[2, 3])
    return root


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Torch on four threads: the VGA frames gain little from more, and
    other work shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return served_root(tmp_path_factory.mktemp("pbms"))


@pytest.fixture(scope="module")
def routes(root):
    """Every pool frame of the tiny cell through the port's route and the
    reference's, at two seeds."""
    out = []
    for seed in (pb_tiny.SEED, 7):
        cell = load_cell(root, CELL)
        wl = generate.generate(cell.config, cell.mix, seed, CPU)
        prog = served_ms.Program(cell.config, cell.mix, wl, CPU)
        port = {f: [served_ms.host_outputs(prog.step(*wl.frames[f], keep=True))] for f in range(len(wl.frames))}
        refs = served_ms.reference_frames(cell.config, wl, range(len(wl.frames)), CPU)
        out.append((cell, wl, prog, port, refs))
    return out


def run(root, trace=False, control=False):
    return run_cell(root, CELL, pb_tiny.SEED, 0.5, trace, CPU, time.perf_counter(), control=control)


def test_port_route_equals_the_reference(routes):
    for cell, wl, _, port, refs in routes:
        hyps = pub = 0
        for f, (p,) in port.items():
            r = refs[f]
            assert p["slots"] == r["slots"] and p["published"] == r["published"]
            np.testing.assert_array_equal(p["scores"], r["scores"])
            for k in ("R", "t", "fitness", "verify"):
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
            hyps += len(p["slots"])
            pub += len(p["published"])
        assert hyps > 0 and pub > 0  # the frames reach ICP, verification and publishing
        values = served_ms.compare(port, refs)
        assert all(values[k] <= v for k, v in cell.limits.items()), values


def test_bfloat16_reference_is_far_from_the_port(routes):
    cell, wl, _, port, _ = routes[0]
    set_precision("bfloat16")
    try:
        low = served_ms.reference_frames(cell.config, wl, sorted(port), CPU)
    finally:
        set_precision("float32")
    values = served_ms.compare(port, low)
    assert any(values[k] > v for k, v in cell.limits.items()), values


def test_hypotheses_counter_is_reported_beside_the_stage_timers(routes, capsys):
    _, wl, prog, port, _ = routes[0]
    stages = prog.stages()
    hyps, frames = stages["hypotheses.count"]
    assert frames == len(wl.frames) and hyps == sum(len(p["slots"]) for (p,) in port.values())
    assert stages["hypotheses"][1] == frames and {"match", "icp", "verify"} <= set(stages)
    prog.step(*wl.frames[0], keep=False)
    prog.stages()
    assert f"served_ms: {float(len(port[0][0]['slots']))!r} hypotheses and " in capsys.readouterr().err


def test_cell_runs_end_to_end_and_prints_one_contract_line(root):
    res = run(root, trace=True)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True and line["failed"] == 0, line["check"]
    assert all(c["value"] == 0 for c in line["check"].values())  # the same bits on one device
    # On the CPU the device's metrics read nothing; the host's stage does.
    assert set(line["metrics"]) == {"serving.hypotheses_ms"} and line["metrics"]["serving.hypotheses_ms"]["value"] > 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    untraced = run(root)
    assert set(untraced["metrics"]) == {m["name"] for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert set(untraced["metrics"]) == {"frames_per_s", "device_mem_peak_gib", "setup_s"}


def test_control_is_not_correct(root):
    assert run(root, control=True)["correct"] is False


def _broken(monkeypatch, kind):
    from sixdpose_tpu_torch import serving
    from sixdpose_tpu_torch.models import multiscale as MS

    if kind == "icp_left_out":
        def icp(model_pts, model_valid, scene_pts, scene_nrm, scene_K, init_T, *a, **k):
            n = model_pts.shape[0]
            return init_T, torch.ones(n), torch.zeros(n)

        monkeypatch.setattr(serving, "icp_batch", icp)
    elif kind == "match_moved":
        orig = MS.pyramid_refine

        def refine(*a, **k):
            tid, x, y, score = orig(*a, **k)
            return tid, x + 1, y, score

        monkeypatch.setattr(MS, "pyramid_refine", refine)
    elif kind == "one_hypothesis_a_class":
        orig = serving.PoseEstimationService._hypotheses

        def fewer(self, matches, depth):
            seen, kept = set(), []
            for m in matches:
                if m.class_id not in seen:
                    seen.add(m.class_id)
                    kept.append(m)
            return orig(self, kept, depth)

        monkeypatch.setattr(serving.PoseEstimationService, "_hypotheses", fewer)
    elif kind == "verify_scaled":
        orig = serving.verify_poses
        monkeypatch.setattr(serving, "verify_poses", lambda *a, **k: orig(*a, **k) * 0.9)


@pytest.mark.parametrize("kind", ["icp_left_out", "match_moved", "one_hypothesis_a_class", "verify_scaled"])
def test_a_broken_route_is_not_correct(root, monkeypatch, kind):
    _broken(monkeypatch, kind)
    assert run(root)["correct"] is False
