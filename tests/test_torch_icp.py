"""The ICP kernel's wrapper and dispatch on the CPU (``ops/icp.py``,
``models/refine.py::icp_batch``).

The kernel itself runs only on a card (``tests/test_torch_cuda.py`` holds
it bit-equal to ``icp_batch_plain`` there).  Here: CPU tensors take the
plain version unchanged and launch nothing; the float32 schedule that the
wrapper hands the kernel is, bit for bit, what the plain step computes;
the wrapper's input checks raise before anything is built, so all of this
runs without nvcc.
"""

import inspect

import numpy as np
import pytest
import torch

from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.models import refine as TR
from sixdpose_tpu_torch.ops import _build
from sixdpose_tpu_torch.ops import icp as OI


# icp_batch's settings: its defaults, which the kernel's wrapper and the
# plain version take as required keywords.
DEFAULTS = {p.name: p.default for p in inspect.signature(TR.icp_batch).parameters.values()
            if p.default is not inspect.Parameter.empty}


def _call(k=5, n=300, color=True, deployment="linemod"):
    c = synthetic.icp_call(deployment, k=k, n=n, color=color)
    K = torch.from_numpy(c["K"])
    sp = TR.backproject(torch.from_numpy(c["depth"]), K)
    args = [torch.from_numpy(c[x]) for x in ("pts", "valid")] + [sp, TR.scene_normals(sp), K,
                                                                  torch.from_numpy(c["init_T"])]
    kw = dict(DEFAULTS)
    if color:
        kw.update(model_chroma=torch.from_numpy(c["chroma"]),
                  chroma_maps=TR.scene_chroma(torch.from_numpy(c["rgb"])))
    return args, kw


@pytest.mark.parametrize("color,n,extra", [
    (True, 300, {}),
    (False, 300, {}),
    (True, 337, dict(max_iters=10, bilinear_iters=4, coarse_points=64, color_weight=0.1)),
    (False, 100, dict(max_iters=6, bilinear_iters=0)),
])
def test_cpu_tensors_take_the_plain_version(color, n, extra):
    """``icp_batch`` on CPU tensors returns exactly ``icp_batch_plain``'s
    T, fitness and rmse, and launches no kernel."""
    args, kw = _call(k=11, n=n, color=color)
    before = OI.icp_cuda.launches
    got = TR.icp_batch(*args, **{**kw, **extra})
    want = TR.icp_batch_plain(*args, **{**kw, **extra})
    assert OI.icp_cuda.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    fit = want[1].numpy()
    off = np.isin(np.arange(len(fit)) % 10, (7, 9))  # a metre off; no valid points
    assert (fit[off] == 0.0).all() and (fit[~off] > 0.5).all(), fit


class _Rec(torch.Tensor):
    """Records the Python floats it is compared with (``<``) or multiplied
    by from the left, in order: the plain step's gate and its scalar
    weights."""

    log = []

    def __lt__(self, other):
        if isinstance(other, float):
            _Rec.log.append(("lt", other))
        return super().__lt__(other)

    def __rmul__(self, other):
        if isinstance(other, float):
            _Rec.log.append(("rmul", other))
        return super().__rmul__(other)


@pytest.mark.parametrize("max_iters,corr,mult,cw,cs", [
    (20, 0.01, 3.0, 0.1, 0.05),
    (16, 0.01, 3.0, 0.3, 0.05),
    (7, 0.013, 2.5, 0.17, 0.07),
    (1, 0.01, 3.0, 0.1, 0.05),
    (130, 0.01, 3.0, 0.1, 0.05),
])
def test_host_schedule_equals_the_plain_steps_scalars(monkeypatch, max_iters, corr, mult, cw, cs):
    """The gates, colour weights and colour divisors that the wrapper puts
    in the launch arguments are the float32 values that the plain step
    uses in each iteration, bit for bit: read back from the plain step by
    recording the floats its ``_norm(d) < gate`` compares with, the floats
    it scales the colour term by, and the divisor it makes a tensor of."""
    args, kw = _call(k=3, n=120, color=True)
    real_norm, real_scalar = TR._norm, TR._scalar
    divisors = []
    monkeypatch.setattr(TR, "_norm", lambda *a, **k: real_norm(*a, **k).as_subclass(_Rec))
    monkeypatch.setattr(TR, "_scalar", lambda v, like: divisors.append(v) or real_scalar(v, like))
    _Rec.log = []
    pw, lm = 0.25, 0.002  # neither equals a colour weight
    kw.update(corr_dist=corr, max_iters=max_iters, coarse_gate_mult=mult, color_weight=cw, chroma_scale=cs,
              point_weight=pw, lm_damping=lm, bilinear_iters=3, coarse_points=32)
    TR.icp_batch_plain(*args, **kw)
    gates, w_col = [], []
    for op, v in _Rec.log:
        if op == "lt":
            gates.append(v)
        elif v not in (pw, lm):
            w_col.append(v)
    assert gates[-1] == corr  # the final fitness gate
    sched = OI.icp_schedule(max_iters, corr, mult, cw, cs)
    assert sched.dtype == np.float32 and sched.shape == (3, max_iters) and sched.flags.c_contiguous
    as_bits = lambda a: np.asarray(a, np.float32).view(np.uint32)  # noqa: E731
    np.testing.assert_array_equal(as_bits(gates[:-1]), as_bits(sched[0]))
    # Each colour weight scales the step's H and its g (iteration 0's is 0).
    np.testing.assert_array_equal(as_bits(w_col), as_bits(np.repeat(sched[1], 2)))
    np.testing.assert_array_equal(as_bits(divisors), as_bits(sched[2]))
    # A schedule longer than the launch arguments hold is the same table, read on the device.
    on_dev = OI._schedule_on(torch.device("cpu"), max_iters, corr, mult, cw, cs)
    np.testing.assert_array_equal(as_bits(on_dev.numpy()), as_bits(sched))


def test_the_settings_live_in_icp_batch_alone():
    """The kernel's wrapper and the plain version take every setting as a
    required keyword, so ``icp_batch``'s defaults are the only ones."""
    for fn in (OI.icp_cuda, TR.icp_batch_plain):
        params = list(inspect.signature(fn).parameters.values())
        assert all(p.default is inspect.Parameter.empty for p in params), fn.__name__
        assert {p.name for p in params if p.kind is inspect.Parameter.KEYWORD_ONLY} == set(DEFAULTS), fn.__name__
    assert DEFAULTS["max_iters"] == 20 and DEFAULTS["color_weight"] == 0.3


@pytest.mark.parametrize("n,max_iters", [(2049, 20), (5000, 20), (300, 129), (3000, 400)])
def test_wrapper_takes_large_clouds_and_long_schedules(monkeypatch, n, max_iters):
    """Clouds above 2,048 points (a thread's registers) and schedules above
    128 iterations (the launch arguments) pass the wrapper's checks: CPU
    tensors stop only at the CUDA check, as any sound call does."""
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built a kernel"))
    args, kw = _call(k=2, n=n)
    kw["max_iters"] = max_iters
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        OI.icp_cuda(*args, **kw)
    assert n <= OI.MAX_POINTS


@pytest.mark.parametrize("bad", ["pts_float64", "valid_uint8", "init_T_float64", "chroma_float64", "K_float64"])
def test_wrapper_refuses_a_wrong_dtype(bad):
    args, kw = _call(k=2, n=40)
    i = {"pts_float64": 0, "valid_uint8": 1, "K_float64": 4, "init_T_float64": 5}.get(bad)
    if bad == "chroma_float64":
        kw["model_chroma"] = kw["model_chroma"].double()
    else:
        args[i] = args[i].to(torch.uint8 if bad == "valid_uint8" else torch.float64)
    with pytest.raises(TypeError):
        OI.icp_cuda(*args, **kw)


@pytest.mark.parametrize("bad", ["pts", "valid", "init_T", "chroma"])
def test_wrapper_refuses_a_non_contiguous_input(bad):
    args, kw = _call(k=2, n=40)
    strided = lambda a: torch.stack([a, a], dim=-1)[..., 0]  # noqa: E731 (same values, every other element)
    if bad == "chroma":
        kw["model_chroma"] = strided(kw["model_chroma"])
        assert not kw["model_chroma"].is_contiguous()
    else:
        i = {"pts": 0, "valid": 1, "init_T": 5}[bad]
        args[i] = strided(args[i])
        assert not args[i].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        OI.icp_cuda(*args, **kw)


@pytest.mark.parametrize("bad", ["valid", "scene_pts", "K", "init_T", "chroma_map"])
def test_wrapper_refuses_mixed_devices(bad):
    args, kw = _call(k=2, n=40)
    if bad == "chroma_map":
        kw["chroma_maps"] = (kw["chroma_maps"][0].to("meta"),) + tuple(kw["chroma_maps"][1:])
    else:
        i = {"valid": 1, "scene_pts": 2, "K": 4, "init_T": 5}[bad]
        args[i] = args[i].to("meta")
    with pytest.raises(ValueError, match="is on meta"):
        OI.icp_cuda(*args, **kw)


def test_wrapper_needs_cuda_and_builds_nothing_here(monkeypatch):
    """Sound CPU tensors raise in the wrapper before any build; the kernel
    is one of ``csrc/``'s sources and its library path needs no nvcc."""
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built a kernel"))
    args, kw = _call(k=2, n=40)
    with pytest.raises(ValueError, match="CUDA"):
        OI.icp_cuda(*args, **kw)
    assert "icp" in _build.kernel_names()
    assert _build.library_path("icp").name.startswith("libicp-")
