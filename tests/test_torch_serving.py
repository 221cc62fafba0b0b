"""Port parity of serving.py (``PoseEstimationService``, ``nms_norms``) against
the JAX package, on the CPU.

The service runs over the golden of ``tools/torch_port_synth_golden.py``:
the JAX package's synthetic benchmark at a cut size (the box, the cup and
the textured box, 60 render-trained views each, 240 x 180, three scenes),
its bank, its scenes and the JAX service's published estimates on the fused
path (every scene), on the host path (``prefer_fused=False``) and with
``enable_multiscale`` (train depth 450 mm, 3 scales; 4 in-plane seeds with
the flip: the seed-fan case of tests/test_serving.py).

Tolerances: class, template, x and y, similarity and the count of estimates
exactly, and the ``ServiceMetrics`` counters exactly; R within 1e-4 per
entry and t within 0.1 mm (``chip_smoke.FUSED_TOL``); fitness and verify
within 0.01 (two points of the smallest cloud; ICP's float sums differ from
XLA's in the last bits).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from sixdpose_tpu.config import ColorGradientConfig as JColor
from sixdpose_tpu.config import DepthNormalConfig as JDepth
from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.serving import PoseEstimate as JEstimate
from sixdpose_tpu.serving import nms_norms as jax_nms_norms
from sixdpose_tpu_torch.benchmark import benchmark_config, benchmark_K, make_models
from sixdpose_tpu_torch.config import IcpConfig
from sixdpose_tpu_torch.models.detector import Detector
from sixdpose_tpu_torch.serving import PoseEstimate, PoseEstimationService, _readback, nms_norms

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")


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
    return np.load(os.path.join(TESTDATA, "synth_golden.npz"))


def make_service(golden, **overrides):
    settings = json.loads(str(golden["settings"]))
    svc = json.loads(str(golden["service"]))
    det = Detector.read_classes(os.path.join(TESTDATA, "synth_bank.npz"), benchmark_config(settings["top_k"]),
                                device="cpu")
    models = {c: make_models()[c] for c in settings["object_ids"]}
    kw = dict(threshold=svc["threshold"], max_refine=svc["max_refine"], icp=IcpConfig(max_iters=svc["icp_max_iters"]),
              min_fitness=svc["min_fitness"], icp_seeds=svc["icp_seeds"], verify_tau=svc["verify_tau"],
              seed_flip=svc["seed_flip"], device="cpu")
    kw.update(overrides)
    return PoseEstimationService(det, models, benchmark_K(tuple(settings["im_size"])), **kw)


def assert_estimates(got, golden, prefix: str, i: int):
    n = int(golden[f"{prefix}_n"][i])
    assert len(got) == n, (len(got), n)
    for j, e in enumerate(got):
        assert e.class_id == str(golden[f"{prefix}_class"][i, j])
        for f in ("template_id", "x", "y", "similarity"):
            assert getattr(e, f) == golden[f"{prefix}_{f}"][i, j], (j, f)
        np.testing.assert_allclose(e.R, golden[f"{prefix}_R"][i, j], atol=1e-4)
        np.testing.assert_allclose(e.t.ravel(), golden[f"{prefix}_t"][i, j], atol=0.1)
        for f in ("fitness", "verify"):
            assert abs(getattr(e, f) - golden[f"{prefix}_{f}"][i, j]) <= 0.01, (j, f)


def _ests(mk, rows):
    return [mk("ab"[i % 2], s, t, fit, ver) for i, (s, t, fit, ver) in enumerate(rows)]


@pytest.mark.parametrize("key", ["fitness", "similarity", "verify"])
def test_nms_norms_matches_jax(key):
    """Exact: the same greedy order and the same survivors."""
    rng = np.random.default_rng(3)
    rows = [(float(rng.integers(50, 100)), rng.uniform(-60, 60, 3) + [0, 0, 500], float(rng.uniform()),
             float(rng.uniform())) for _ in range(40)]
    port = _ests(lambda c, s, t, f, v: PoseEstimate(c, 0, 0, 0, s, np.eye(3), t.reshape(3, 1), f, v), rows)
    ref = _ests(lambda c, s, t, f, v: JEstimate(c, 0, 0, 0, s, np.eye(3), t.reshape(3, 1), f, v), rows)
    got = nms_norms(port, radius_mm=40.0, key=key)
    want = jax_nms_norms(ref, radius_mm=40.0, key=key)
    assert len(got) == len(want) < len(rows)
    for a, b in zip(got, want):
        assert (a.class_id, a.similarity, a.fitness, a.verify) == (b.class_id, b.similarity, b.fitness, b.verify)
        np.testing.assert_array_equal(a.t, b.t)


def test_readback_is_one_copy_of_every_output():
    """The fused outputs come back in their own dtypes and values."""
    out = (torch.tensor([[3, 4]], dtype=torch.int32), torch.tensor([[5, 6]], dtype=torch.int32),
           torch.tensor([[7, 8]], dtype=torch.int32), torch.tensor([[55.5, -1.0]]),
           torch.arange(18, dtype=torch.float32).reshape(1, 2, 3, 3) / 7, torch.ones(1, 2, 3) * 0.1,
           torch.tensor([[0.9, -1.0]]), torch.tensor([[0.25, -1.0]]), torch.tensor([[True, False]]))
    back = _readback(out)
    for a, b in zip(out, back):
        assert b.dtype == a.numpy().dtype and np.array_equal(b, a.numpy())


@pytest.mark.parametrize("scene", [0, 1, 2])
def test_fused_path_matches_jax_golden(golden, scene):
    svc = make_service(golden)
    ests = svc.process_frame(golden["rgb"][scene], golden["depth"][scene])
    assert_estimates(ests, golden, "est", scene)
    snap = svc.metrics.snapshot()
    assert snap["counters"]["frames"] == 1 and snap["counters"]["published"] == len(ests)
    assert {"fused_dispatch", "fused_readback"} <= set(snap["stages"])


@pytest.mark.parametrize("case", ["host", "multiscale"])
def test_service_case_matches_jax_golden(golden, case):
    """The host-orchestrated path, and the multi-scale seed-fan path."""
    if case == "host":
        svc, scene = make_service(golden, prefer_fused=False), int(golden["host_scene"])
    else:
        svc, scene = make_service(golden), int(golden["ms_scene"])
        svc.enable_multiscale(train_depth=float(golden["ms_train_depth"]), num_scales=int(golden["ms_scales"]))
    ests = svc.process_frame(golden["rgb"][scene], golden["depth"][scene])
    i = 0 if case == "host" else 1
    assert_estimates(ests, golden, "case", i)
    counters = svc.metrics.snapshot()["counters"]
    hypotheses = counters.pop("hypotheses")  # the port's own counter; JAX's service has none
    assert counters == json.loads(str(golden["case_counters"]))[i]
    assert counters["estimates"] <= hypotheses <= counters["matches"]
    assert {"match", "hypotheses", "icp", "verify"} <= set(svc.metrics.snapshot()["stages"])
    if case == "multiscale":
        assert all(e.verify >= 0.0 for e in ests)


def _case_service(golden, case):
    if case == "host":
        return make_service(golden, prefer_fused=False), int(golden["host_scene"])
    svc = make_service(golden)
    if case == "multiscale":
        svc.enable_multiscale(train_depth=float(golden["ms_train_depth"]), num_scales=int(golden["ms_scales"]))
        return svc, int(golden["ms_scene"])
    return svc, 0


@pytest.mark.parametrize("case", ["fused", "host", "multiscale"])
def test_stage_timers_are_unchanged_and_traced_under_their_names(golden, case):
    """Profiling a frame changes neither its estimates nor the service's
    stage names and counts; every stage is a span of its own name, inside
    the frame's one ``sixdpose.frame`` span."""
    from torch.profiler import ProfilerActivity, profile

    plain, scene = _case_service(golden, case)
    traced, _ = _case_service(golden, case)
    want = plain.process_frame(golden["rgb"][scene], golden["depth"][scene])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = traced.process_frame(golden["rgb"][scene], golden["depth"][scene])
    assert [(e.class_id, e.template_id, e.x, e.y, e.fitness, e.verify) for e in got] == \
        [(e.class_id, e.template_id, e.x, e.y, e.fitness, e.verify) for e in want]
    snap_p, snap_t = plain.metrics.snapshot(), traced.metrics.snapshot()
    counts = {n: s["count"] for n, s in snap_t["stages"].items()}
    assert counts == {n: s["count"] for n, s in snap_p["stages"].items()}
    assert snap_t["counters"] == snap_p["counters"]
    stages = {"fused": {"fused_dispatch", "fused_readback"}, "host": {"match", "hypotheses", "icp", "verify"}}
    assert set(counts) == stages.get(case, stages["host"])
    spans = [e.name for e in prof.events() if e.name.startswith("sixdpose.")]
    assert spans.count("sixdpose.frame") == 1
    for name, n in counts.items():
        assert spans.count(f"sixdpose.{name}") == n, name


@pytest.mark.parametrize("case", ["host", "multiscale"])
def test_hypotheses_span_and_timer_open_once_a_host_route_frame(golden, case):
    from torch.profiler import ProfilerActivity, profile

    svc, scene = _case_service(golden, case)
    frame = (golden["rgb"][scene], golden["depth"][scene])
    svc.process_frame(*frame)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc.process_frame(*frame)
    assert [e.name for e in prof.events()].count("sixdpose.hypotheses") == 1
    assert svc.metrics.snapshot()["stages"]["hypotheses"]["count"] == 2


@pytest.mark.parametrize("case,seeds", [("host", 1), ("host", None), ("multiscale", 1), ("multiscale", None)])
def test_hypotheses_counter_is_the_clouds_sent_to_icp(golden, case, seeds, monkeypatch):
    """One count a hypothesis, each refined from ``icp_seeds`` clouds (the
    golden's service fans 4 seeds)."""
    from sixdpose_tpu_torch import serving

    svc, scene = _case_service(golden, case)
    if seeds is not None:
        svc.icp_seeds = seeds
    sent = []
    real = serving.icp_batch

    def spy(model_pts, *a, **k):
        sent.append(model_pts.shape[0])
        return real(model_pts, *a, **k)

    monkeypatch.setattr(serving, "icp_batch", spy)
    svc.process_frame(golden["rgb"][scene], golden["depth"][scene])
    assert len(sent) == 1 and sent[0] > 0
    assert sent[0] == svc.metrics.counters["hypotheses"] * svc.icp_seeds


def test_verify_samples_are_built_at_enable_multiscale_and_never_in_a_frame(golden, monkeypatch):
    svc, scene = _case_service(golden, "multiscale")
    assert set(svc._vpts_device) == set(svc.det.class_ids())
    before = {c: svc._verify_points(c) for c in svc.det.class_ids()}

    def build(class_id):
        raise AssertionError(f"the verify sample of {class_id} was built inside a frame")

    monkeypatch.setattr(svc, "_verify_points_np", build)
    ests = svc.process_frame(golden["rgb"][scene], golden["depth"][scene])
    assert_estimates(ests, golden, "case", 1)
    for c, (pts, colors) in before.items():  # the same device tensors: nothing uploaded again
        got = svc._verify_points(c)
        assert got[0] is pts and got[1] is colors


def test_fused_path_opens_no_hypotheses_span(golden):
    from torch.profiler import ProfilerActivity, profile

    svc = make_service(golden)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc.process_frame(golden["rgb"][0], golden["depth"][0])
    assert "sixdpose.hypotheses" not in {e.name for e in prof.events()}
    assert "hypotheses" not in svc.metrics.snapshot()["stages"]
    assert "hypotheses" not in svc.metrics.counters


def test_fused_fallback_is_decided_by_the_infos(golden):
    """A class whose templates lack a fused field takes the host path; a
    complete bank never does."""
    svc = make_service(golden)
    assert svc._fused_multiclass(svc.det.class_ids()) is not None
    del svc.det.bank.infos["cup"][3]["render_bbox"]
    assert svc._fused_multiclass(svc.det.class_ids()) is None
    assert svc.process_frame_fused(golden["rgb"][0], golden["depth"][0]) is None


def test_run_calls_back_per_frame(golden):
    svc = make_service(golden)
    seen = []
    svc.run([(golden["rgb"][0], golden["depth"][0])], seen.append)
    assert len(seen) == 1
    assert_estimates(seen[0], golden, "est", 0)


def test_enable_multiscale_has_no_table_budget(golden):
    """The port's multi-scale matchers build their coarse weights per frame:
    there is no table route to budget (a deliberate divergence)."""
    svc = make_service(golden)
    with pytest.raises(TypeError):
        svc.enable_multiscale(train_depth=450.0, table_budget_bytes=1 << 30)


def test_jax_bank_infos_feed_the_fused_pipelines(golden, tmp_path):
    """The JAX-trained bank round-trips through the shared npz with every
    field ``refine_bank_fields`` reads, equal to the JAX package's own read."""
    from sixdpose_tpu.models import pipeline as JP
    from sixdpose_tpu.models.detector import Detector as JDetector
    from sixdpose_tpu_torch.models.pipeline import refine_bank_fields

    path = str(tmp_path / "bank.npz")
    shutil.copy(os.path.join(TESTDATA, "synth_bank.npz"), path)
    settings = json.loads(str(golden["settings"]))
    jcfg = JConfig(t_at_level=(4, 8), top_k=settings["top_k"], color=JColor(num_features=40, strong_threshold=30.0),
                   depth=JDepth(num_features=24, extract_threshold=1, focal=280.0))
    assert repr(jcfg) == repr(benchmark_config(settings["top_k"]))
    jdet = JDetector.read_classes(path, jcfg)
    tdet = Detector.read_classes(path, benchmark_config(settings["top_k"]), device="cpu")
    for cid in settings["object_ids"]:
        for ji, ti in zip(jdet.bank.infos[cid], tdet.bank.infos[cid]):
            for key in ("icp_points", "icp_colors", "cam_R_w2c", "cam_t_w2c", "render_bbox", "cam_K"):
                assert ti[key].dtype == ji[key].dtype and np.array_equal(ti[key], ji[key]), key
        jrb = JP.build_refine_bank(jdet, cid, 512)
        fields, win = refine_bank_fields(tdet, cid, 512)
        assert tuple(win) == tuple(jrb.win)
        for got, name in zip(fields, ("clouds", "valids", "chroma", "src_c", "bbox_wh", "base_T")):
            np.testing.assert_array_equal(got, np.asarray(getattr(jrb, name)), err_msg=name)
