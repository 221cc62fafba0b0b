"""The harness on the CPU: the JAX guard, the generator's determinism, the
window's arithmetic, tiny cells end to end, files found by name, and the
check's control and faults coming out as not correct."""

import json
import sys
import time

import numpy as np
import pytest
import torch

import pb_tiny
from perfbench.core import generate
from perfbench.core.guard import forbidden_modules
from perfbench.core.harness import closed_loop, latency_stats, load_cell, run_cell
from perfbench.reference.extract import select_scattered_features

CPU = torch.device("cpu")
CELLS = ("tless.served", "linemod.match", "tless.match")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.tiny_root(tmp_path_factory.mktemp("pb"))


def run(root, cell, trace=False, control=False, seconds=0.5):
    return run_cell(root, cell, pb_tiny.SEED, seconds, trace, CPU, time.perf_counter(), control=control)


def test_guard_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "sixdpose_tpu", "sixdpose_tpu.ops",
             "sixdpose_tpu_torch", "sixdpose_tpu_torch.ops", "jaxtyping", "flaxen", "numpy"]
    assert forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "sixdpose_tpu",
                                        "sixdpose_tpu.ops"]


def test_guard_passes_the_harness_and_the_port():
    import perfbench.drivers.match  # noqa: F401
    import perfbench.drivers.served  # noqa: F401
    import sixdpose_tpu_torch.serving  # noqa: F401

    assert forbidden_modules([n for n in sys.modules if not n.startswith(("jax", "flax"))]) == []


def test_run_refuses_jax_loaded_after_set_up(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    with pytest.raises(RuntimeError, match="JAX modules loaded"):
        run(root, "tless.match")


def test_run_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    sys.path.insert(0, str(pb_tiny.REPO / "perfbench"))
    import run as bench_run

    assert bench_run.main(["--workload", "tless.match", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", CELLS)
def test_generator_is_deterministic_in_the_seed(root, cell):
    c = load_cell(root, cell)
    a, b = (generate.generate(c.config, c.mix, pb_tiny.SEED, CPU) for _ in range(2))
    other = generate.generate(c.config, c.mix, pb_tiny.SEED + 1, CPU)
    for x, y in zip(a.frames, b.frames):
        assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
    assert a.placements == b.placements
    for ta, tb, to in zip(a.templates, b.templates, other.templates):
        assert [np.array_equal(l.features, m.features) for t, u in zip(ta, tb) for l, m in zip(t, u)] == [True] * (2 * len(ta))
        # Another seed: other draws, the same sizes.
        assert [len(l.features) for t in ta for l in t] == [len(l.features) for t in to for l in t]
    assert not np.array_equal(a.frames[0][0], other.frames[0][0])
    assert [len(p) for p in a.placements] == [len(p) for p in other.placements]
    assert generate.check_frames(c.mix, pb_tiny.SEED) == generate.check_frames(c.mix, pb_tiny.SEED)


def test_rate_and_p90_cover_every_frame_of_the_window():
    def frame(i):
        time.sleep(0.25 if i == 3 else 0.01)  # one stall

    lat, window = closed_loop(frame, 0.4)
    assert len(lat) >= 5 and max(lat) >= 0.25
    assert window >= sum(lat) * 0.999
    s = latency_stats(lat, window)
    assert s["frames_per_s"] == pytest.approx(len(lat) / window)
    assert s["frames_per_s"] < 1.0 / 0.01 * 0.7  # the stall is in the rate
    planted = [0.1] * 89 + [1.0] * 11
    assert latency_stats(planted, 20.0)["frame_ms_p90"] == pytest.approx(1000.0)
    assert latency_stats([0.1] * 91 + [1.0] * 9, 20.0)["frame_ms_p90"] < 1000.0


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_end_to_end_and_prints_one_contract_line(root, cell):
    res = run(root, cell)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    assert all(c["value"] <= c["limit"] for c in line["check"].values())


def test_a_window_too_short_for_the_checked_frames_still_checks_them(root):
    res = run(root, "linemod.match", seconds=1e-9)  # one frame in the window
    assert res["info"]["frames"] == 1 and res["correct"] is True
    c = load_cell(root, "linemod.match")
    assert res["info"]["checked_frames"] == generate.check_frames(c.mix, pb_tiny.SEED)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    assert run(root, cell, control=True)["correct"] is False


def test_traced_run_reads_per_layer_metrics(root):
    res = run(root, "tless.served", trace=True)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"serving.dispatch_ms"}  # the device's metrics read nothing on the CPU
    assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    # The untraced window ran first: its frames, and the traced frames after them.
    assert res["info"]["frames"] >= 1 and res["attempted"] == res["info"]["frames"] + 2


def test_dispatch_is_read_from_the_untraced_window(root, monkeypatch):
    from perfbench.core import harness

    seen = {}
    real = harness.Context

    def spy(*a, **k):
        ctx = real(*a, **k)
        seen["ctx"] = ctx
        return ctx

    monkeypatch.setattr(harness, "Context", spy)
    res = run(root, "tless.served", trace=True)
    total, count = seen["ctx"].stages["fused_dispatch"]
    assert count == res["info"]["frames"]  # the window's frames, not the warm-up's or the traced ones
    assert res["metrics"]["serving.dispatch_ms"]["value"] == pytest.approx(1000.0 * total / count)
    assert seen["ctx"].frames == 2 and seen["ctx"].frame_s == pytest.approx(res["info"]["window_s"] / count)


def _ctx(launches, calls):
    from perfbench.core import trace as T
    from perfbench.core.harness import Context
    from perfbench.core.peaks import H100

    spans = [T.Span("local_refine_kernel(int)", 10.0 * i, 10.0 * i + 5.0) for i in range(launches)]
    return Context(T.Trace(spans, [], 0.0, 100.0), 1, 0.1, {}, calls, H100)


def test_roofline_reads_nothing_without_launches_and_fails_loudly_on_unrecorded_ones():
    from perfbench.core.harness import _reader

    read = _reader(pb_tiny.REPO, "local_refine.roofline")
    assert read(_ctx(0, [])) is None
    assert read(_ctx(0, [{"any": 1}])) is None  # a CPU run: the plain path, no kernel
    with pytest.raises(RuntimeError, match="2 launches"):
        read(_ctx(2, []))  # the kernel reached by a path the recorder does not see
    with pytest.raises(RuntimeError, match="1 calls"):
        read(_ctx(2, [{"any": 1}]))


@pytest.mark.parametrize("name", ["tless_30obj_720x540", "linemod_15obj_vga"])
def test_frames_hold_the_largest_objects_of_the_full_configurations(name):
    cfg = json.loads((pb_tiny.REPO / "perfbench" / "configs" / f"{name}.json").read_text())
    sizes = generate.class_sizes(cfg)
    rng = np.random.default_rng(0)
    focal, z = float(cfg["K"][0][0]), float(cfg["train_depth_mm"])
    objects = [generate.class_object(c, int(s), rng, s * z / focal / 2) for c, s in enumerate(sizes)]
    h, w = cfg["image"]
    for seed in range(8):
        r = np.random.default_rng([pb_tiny.SEED, seed])
        for count in (3, 4, 5):
            _, _, placed = generate.make_frame(cfg, objects, count, r)
            assert len(placed) == count and len({p[0] for p in placed}) == count
            boxes = [(x, y, int(round(objects[c][2].shape[0] * sc))) for c, _, x, y, _, sc in placed]
            for i, (x, y, s) in enumerate(boxes):
                assert 0 <= x and x + s <= w and 0 <= y and y + s <= h
                for bx, by, bs in boxes[:i]:
                    assert not (x < bx + bs and bx < x + s and y < by + bs and by < y + s)


def test_new_config_traffic_and_metric_are_found_by_name(root, tmp_path):
    new = pb_tiny.tiny_root(tmp_path)
    cfg = json.loads((new / "perfbench/configs/tless_30obj_720x540.json").read_text())
    cfg.update(classes=2, threshold=60)
    (new / "perfbench/configs/toy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((new / "perfbench/traffic/match.json").read_text())
    mix.update(objects_per_frame=[1])
    (new / "perfbench/traffic/toy_mix.json").write_text(json.dumps(mix))
    (new / "perfbench/metrics/toy_frames.py").write_text("def read(ctx):\n    return float(ctx.frames)\n")
    (new / "perfbench/limits/toy.cell.json").write_text(json.dumps({"mismatches": 0, "score_gap": 0.001}))
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_cfg", "source": "a test", "file": "perfbench/configs/toy_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy_cfg", "traffic": "toy_mix", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "toy.frames", "unit": "frames", "better": "higher", "source": "program_counter",
                               "layer": "harness", "moves": "frames_per_s", "workloads": ["toy.cell"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(new, "toy.cell", pb_tiny.SEED, 0.5, True, CPU, time.perf_counter())
    assert res["correct"] is True
    assert res["metrics"]["toy.frames"]["value"] == 2.0


def _faulty(monkeypatch, kind):
    """Break the timed path underneath the harness, one fault at a time."""
    from sixdpose_tpu_torch.models import detector as D
    from sixdpose_tpu_torch.models import multiclass as MC
    from sixdpose_tpu_torch.models import multiscale as MS
    from sixdpose_tpu_torch.models import pipeline as P

    if kind == "answer_altered":
        orig = D.pyramid_refine

        def refine(*a, **k):
            tid, x, y, score = orig(*a, **k)
            return tid, x + 1, y, score

        for mod in (MC, MS):
            monkeypatch.setattr(mod, "pyramid_refine", refine)
    elif kind == "half_left_out":
        orig = D.pyramid_refine

        def refine(*a, **k):
            tid, x, y, score = orig(*a, **k)
            half = (torch.arange(score.shape[-1]) // 128) % 2 == 1  # every other class's top_k candidates
            return tid, x, y, torch.where(half, -1.0, score)

        for mod in (MC, MS):
            monkeypatch.setattr(mod, "pyramid_refine", refine)
    elif kind == "state_unchanged":
        def icp(model_pts, model_valid, scene_pts, scene_nrm, scene_K, init_T, *a, **k):
            n = model_pts.shape[0]
            return init_T, torch.ones(n), torch.zeros(n)

        monkeypatch.setattr(P, "icp_batch", icp)


@pytest.mark.parametrize("cell,kind", [
    ("tless.served", "answer_altered"), ("tless.served", "half_left_out"), ("tless.served", "state_unchanged"),
    ("linemod.match", "answer_altered"), ("linemod.match", "half_left_out"),
    ("tless.match", "answer_altered"), ("tless.match", "half_left_out"),
])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, kind):
    _faulty(monkeypatch, kind)
    assert run(root, cell)["correct"] is False


def test_fast_scattered_selection_equals_the_ports():
    from sixdpose_tpu_torch.models.templates import select_scattered_features as port

    rng = np.random.default_rng(0)
    for _ in range(200):
        w = int(rng.integers(3, 60))
        idx = rng.choice(w * w, min(int(rng.integers(5, 400)), w * w), replace=False)
        xs, ys = idx % w, idx // w
        k, d = int(rng.integers(1, len(xs) + 3)), float(rng.uniform(0.5, 12))
        a, b = port(xs, ys, None, k, d), select_scattered_features(xs, ys, None, k, d)
        assert (a is None and b is None) or np.array_equal(a, b)
