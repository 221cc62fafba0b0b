"""The port's bench twin (``sixdpose_tpu_torch/bench.py``) against the JAX
package's ``bench.py``, on the CPU.

- The workload: ``synthetic.bench_bank()`` equals ``bench._synthetic_bank()``
  to the bit (the repo-root ``bench`` imports JAX only inside ``main``).
- The chains, at a cut size: bench.py's recipe with 6 templates of 32 x 32
  (64 features) and 16 x 16 (32 features) and a 160 x 120 frame, in place of
  89 templates of 80 x 80 (254) and 40 x 40 (127) and a VGA frame.  A 3-frame
  match chain through JAX's ``detect_frame_core`` in a ``fori_loop``, as
  bench.py's ``match_chain``, against the twin's ``match_chain``: the final
  frame's bytes equal, and the last frame's (tid, x, y, score, keep) equal
  on live entries (score >= 0) and in score and keep everywhere (the port's
  kernel contract zeroes dead candidates, which JAX on the CPU scores, so a
  dead slot's x, y may differ; tests/test_torch_detector.py).  The same for a
  B = 2 batch chain.  At bench.py's threshold 75 the cut bank has no live
  match; 40 has live ones.
- A one-frame detect+refine chain.  bench.py's frame is noise, so its ICP
  has no pose to converge to: a first-step difference of about 1e-6 between
  XLA's and PyTorch's float32 steps roughly doubles each iteration (measured
  on this cut: R 2e-5 and t 0.002 mm apart after 2 iterations, 0.002 and
  0.09 mm after 4, 0.18 and 6.8 mm after 8).  So JAX is held at 2 ICP
  iterations, as the LCHF golden holds its refine stage: the perturbation
  byte equal, tid, x, y, score and active equal, R, t and fitness within
  ``FUSED_TOL`` (tests/test_torch_pipeline.py's ``assert_fused_close``).  At
  bench.py's 16 iterations the matched slots must still equal JAX's; the
  16-iteration frame is held against the port's own CPU run on the card
  (``chip_smoke.py``, to the bit).
- The stream: ``main(device="cpu")`` on a smaller cut with short chains
  prints JSON lines whose last holds every key with a positive value; with
  the budget spent only the headline is printed; the slope helper on a stub
  clock.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import bench as jbench
from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.config import IcpConfig as JIcp
from sixdpose_tpu.models import detector as JD
from sixdpose_tpu.models import pipeline as JP
from sixdpose_tpu.models.templates import TemplateLevel as JTemplateLevel
from sixdpose_tpu_torch import bench, synthetic
from sixdpose_tpu_torch.models.detector import Detector
from tests.test_torch_pipeline import assert_fused_close

CUT = dict(num_templates=6, sizes=(32, 16), features=64, hw=(120, 160))
TINY = dict(num_templates=2, sizes=(16, 8), features=32, hw=(48, 64))
THRESHOLDS = (bench.THRESHOLD, 40.0)
ICP_ITERS_VS_JAX = 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cut():
    """The cut workload in both packages: the JAX detector's device arrays,
    the port's CPU bank, and the frame."""
    cid, templates, rgb, dep = synthetic.bench_bank(**CUT)
    jdet = JD.Detector(JConfig(t_at_level=(5, 8)))
    det = Detector(bench.CFG, device="cpu")
    for tl in templates:
        jdet.bank.add_template_levels(cid, [JTemplateLevel(features=l.features, width=l.width, height=l.height,
                                                           pyramid_level=l.pyramid_level) for l in tl])
        det.bank.add_template_levels(cid, tl)
    kernels, nfeats, whs = jdet.device_bank(cid)
    feats, valids = jdet._device_feats[cid]
    return dict(cid=cid, rgb=rgb, dep=dep, jbank=(kernels, nfeats, whs, feats, valids), jcfg=jdet.cfg,
                bank=det.device_bank(cid))


def _jax_frame(c, r, depj, thr):
    kernels, nfeats, whs, feats, valids = c["jbank"]
    return JD.detect_frame_core(r, depj, kernels, nfeats, whs, c["jcfg"], thr, True, feats, valids)


def _jax_match_chain(c, k, thr):
    """bench.py's ``match_chain``: k frames in a ``fori_loop``, each the last
    XOR its top score's parity; the final frame and the last matches."""
    depj = jnp.asarray(c["dep"])

    def body(r, thr):
        tid, x, y, score, keep = _jax_frame(c, r, depj, thr)
        return r ^ (score[0] % 2.0).astype(jnp.uint8), (tid, x, y, score, keep)

    rgbj = jnp.asarray(c["rgb"])
    shapes = jax.eval_shape(lambda r: body(r, thr)[1], rgbj)

    @jax.jit
    def chain(k, r, thr):
        init = (r, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes))
        return jax.lax.fori_loop(0, k, lambda i, v: body(v[0], thr), init)

    r, out = chain(jnp.int32(k), rgbj, jnp.float32(thr))
    return np.asarray(r), [np.asarray(a) for a in out]


def _assert_matches_equal(got, want):
    """(tid, x, y, score, keep): score and keep everywhere, tid, x, y on live
    entries."""
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    live = want[3] >= 0
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a[live], b[live])
    return int(live.sum())


def test_workload_equals_bench_py():
    cid, templates, rgb, dep = synthetic.bench_bank()
    jcid, jtemplates, jrgb, jdep = jbench._synthetic_bank()
    assert cid == jcid == "synthetic" and len(templates) == len(jtemplates) == 89
    np.testing.assert_array_equal(rgb, jrgb)
    np.testing.assert_array_equal(dep, jdep)
    assert rgb.shape == (480, 640, 3) and dep.dtype == jdep.dtype == np.uint16
    for a, b in zip(templates, jtemplates):
        for la, lb in zip(a, b):
            np.testing.assert_array_equal(la.features, lb.features)
            assert (la.width, la.height, la.pyramid_level) == (lb.width, lb.height, lb.pyramid_level)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_match_chain_equals_jax(cut, thr):
    want_r, want = _jax_match_chain(cut, 3, thr)
    rgb, dep = torch.from_numpy(cut["rgb"]), torch.from_numpy(cut["dep"].astype(np.int32))
    r, got = bench.match_chain(3, rgb, dep, cut["bank"], threshold=thr)
    np.testing.assert_array_equal(r.numpy(), want_r)
    live = _assert_matches_equal(got, want)
    assert (live > 0) == (thr < bench.THRESHOLD)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_batch_chain_equals_jax(cut, thr):
    """B = 2 as bench.py's batch sweep: the frames ``stack([rgb] * B) ^
    arange(B)``, one depth, each frame perturbed by its own top score; the
    final frames and the last step's matches of each frame."""
    b_n = 2
    rgb_b = np.stack([cut["rgb"]] * b_n) ^ np.arange(b_n, dtype=np.uint8)[:, None, None, None]
    depj = jnp.asarray(cut["dep"])

    def frames(rb, thr):
        return jax.vmap(lambda r: _jax_frame(cut, r, depj, thr))(rb)

    @jax.jit
    def chain(k, rb, thr):
        def body(i, rb_):
            score = frames(rb_, thr)[3]
            return rb_ ^ (score[:, 0] % 2.0).astype(jnp.uint8)[:, None, None, None]

        return jax.lax.fori_loop(0, k, body, rb)

    before_last = chain(jnp.int32(2), jnp.asarray(rgb_b), jnp.float32(thr))
    want_m = [np.asarray(a) for a in jax.jit(frames)(before_last, jnp.float32(thr))]
    want = np.asarray(chain(jnp.int32(1), before_last, jnp.float32(thr)))
    dep_b = torch.from_numpy(cut["dep"].astype(np.int32)).expand(b_n, -1, -1).contiguous()
    got, got_m = bench.batch_chain(3, torch.from_numpy(rgb_b), dep_b, cut["bank"], threshold=thr)
    np.testing.assert_array_equal(got.numpy(), want)
    live = _assert_matches_equal(got_m, want_m)
    assert (live > 0) == (thr < bench.THRESHOLD)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_refine_frame_equals_jax(cut, thr):
    """One frame of bench.py's ``refine_chain`` over its refine stage
    (``synthetic.bench_refine_bank``, drawn as bench.py draws it: 8
    candidates, 512-point clouds, 512-point verification), at 2 ICP
    iterations against JAX and at bench.py's 16 in the matched slots."""
    stage = synthetic.bench_refine_bank(cut["bank"].whs[0].numpy())
    assert stage["icp"].max_iters == 16
    kernels, nfeats, whs, feats, valids = cut["jbank"]
    np.testing.assert_array_equal(np.asarray(whs[0]), cut["bank"].whs[0].numpy())
    clouds, vmask, chroma, src_c, bbox_wh, base_T = stage["fields"]
    rb = JP.RefineBank(clouds=jnp.asarray(clouds), valids=jnp.asarray(vmask), chroma=jnp.asarray(chroma),
                       src_c=jnp.asarray(src_c), bbox_wh=jnp.asarray(bbox_wh), base_T=jnp.asarray(base_T),
                       win=stage["win"])
    depj = jnp.asarray(cut["dep"])

    @jax.jit
    def frame(r):
        out = JP.detect_refine_core(r, depj, kernels, nfeats, whs, cut["jcfg"], thr, feats, valids, rb,
                                    JIcp(max_iters=ICP_ITERS_VS_JAX), jnp.asarray(stage["K"]), stage["max_refine"],
                                    jnp.asarray(stage["verify_pts"]), jnp.asarray(stage["verify_colors"]))
        return r ^ (jnp.abs(out[6][0]) * 255.0 % 2.0).astype(jnp.uint8), out

    want_r, want = frame(jnp.asarray(cut["rgb"]))
    rgb, dep = torch.from_numpy(cut["rgb"]), torch.from_numpy(cut["dep"].astype(np.int32))
    cut_stage = dict(stage, icp=dataclasses.replace(stage["icp"], max_iters=ICP_ITERS_VS_JAX))
    run = bench.refine_runner(dep, cut["bank"], cut_stage, threshold=thr)
    n_active, _ = assert_fused_close(want, run(rgb), 512, 512)
    assert (n_active > 0) == (thr < bench.THRESHOLD)
    np.testing.assert_array_equal(bench.refine_chain(1, rgb, run).numpy(), np.asarray(want_r))
    full = bench.refine_runner(dep, cut["bank"], stage, threshold=thr)(rgb)
    for i in (0, 1, 2, 3, 8):
        np.testing.assert_array_equal(full[i].numpy(), np.asarray(want[i]))


def _main_lines(**kw) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(device="cpu", workload=synthetic.bench_bank(**TINY), match_chains=(1, 3),
                          refine_chains=(1, 2), **kw) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_main_streams_the_cumulative_record(monkeypatch):
    monkeypatch.delenv("SIXDPOSE_BENCH_BUDGET_S", raising=False)
    lines = _main_lines()
    assert len(lines) == 5  # headline, detect+refine, B = 2, 4, 8
    last = lines[-1]
    assert {k: last[k] for k in ("metric", "unit")} == {"metric": "match_fps", "unit": "frames/s"}
    assert all(last[k] > 0 for k in bench.RECORD_KEYS), last
    assert last["vs_baseline"] == pytest.approx(last["value"] / bench.BASELINE_FPS, abs=0.01)  # both rounded
    assert last["nvidia_smi"] is None and last["local_refine_launches"] == 0  # the CPU: the plain version
    for a, b in zip(lines, lines[1:]):  # cumulative: each line keeps every earlier key
        assert {k: v for k, v in b.items() if k in a and k != "local_refine_launches"} == {
            k: v for k, v in a.items() if k != "local_refine_launches"}


def test_main_spent_budget_emits_only_the_headline(monkeypatch):
    monkeypatch.setenv("SIXDPOSE_BENCH_BUDGET_S", "0")
    lines = _main_lines()
    assert len(lines) == 1 and lines[0]["value"] > 0
    assert not any(k in lines[0] for k in bench.RECORD_KEYS[2:])


def test_main_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(workload=synthetic.bench_bank(**TINY))


def test_slope_on_a_stub_clock():
    """Frames of 1/256 s behind 1/16 s of set-up (binary fractions, so the
    stub clock's differences are exact): 256 fps.  A first reading whose
    slope is negative is retried; a slope that never turns positive reads
    as 1e9 fps, as bench.py's does."""
    now = [0.0]
    noise = iter([0.25, 0.25, 0.25])  # the first three k1 runs read slow: the first slope is negative
    calls = []

    def prog(k, x0):
        calls.append(k)
        now[0] += 0.0625 + k / 256 + next(noise, 0.0)
        return x0

    assert bench._slope_fps(prog, None, lambda r: None, 4, 36, clock=lambda: now[0]) == 256.0
    assert calls == ([4] * 3 + [36] * 3) * 2
    calls.clear()

    def flat(k, x0):
        calls.append(k)
        now[0] += 0.0625
        return x0

    assert bench._slope_fps(flat, None, lambda r: None, 4, 36, retries=2, clock=lambda: now[0]) == pytest.approx(1e9)
    assert calls == ([4] * 3 + [36] * 3) * 2
