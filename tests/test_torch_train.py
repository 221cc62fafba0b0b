"""Port parity of models/train.py (render-based template training) against the
JAX package, on the CPU.

Tolerance: exact.  Given JAX's renders of the same views, the port's
quantization and extraction give the same templates (features, widths,
heights) and the same infos (every field, with its dtype) as JAX's
``render_train_templates``; trained end to end on its own renders the port
gives the same added and failed counts, and so far the same bank.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.benchmark import make_models
from sixdpose_tpu.config import ColorGradientConfig as JColor
from sixdpose_tpu.config import DepthNormalConfig as JDepth
from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.geometry import render as JR
from sixdpose_tpu.models.detector import Detector as JDetector
from sixdpose_tpu.models.train import render_train_templates as jax_train
from sixdpose_tpu_torch.config import ColorGradientConfig, DepthNormalConfig, DetectorConfig
from sixdpose_tpu_torch.models import train as TT
from sixdpose_tpu_torch.models.detector import Detector

K = np.array([[160.0, 0, 80], [0, 160.0, 60], [0, 0, 1]])
TRAIN = dict(radii=[400.0], min_n_views=12, im_size=(160, 120), tilt_range=(0.0, 0.1), tilt_step=1.0)
COLOR = dict(num_features=24, strong_threshold=30.0)
DEPTH = dict(num_features=16, extract_threshold=1, focal=160.0)
CLASSES = {"box": True, "texbox": False}  # class -> depth modality on (the textured box trains on colour)


def _detectors(use_depth: bool):
    kw = dict(t_at_level=(4, 8), top_k=16, use_depth=use_depth)
    jdet = JDetector(JConfig(color=JColor(**COLOR), depth=JDepth(**DEPTH), **kw))
    tdet = Detector(DetectorConfig(color=ColorGradientConfig(**COLOR), depth=DepthNormalConfig(**DEPTH), **kw),
                    device="cpu")
    return jdet, tdet


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: these small tensors gain nothing from more, and
    the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_banks():
    out = {}
    for cid, use_depth in CLASSES.items():
        jdet, _ = _detectors(use_depth)
        stats = jax_train(jdet, cid, make_models()[cid], K, **TRAIN)
        out[cid] = (jdet, stats)
    return out


def assert_same_bank(jdet, tdet, cid):
    assert tdet.num_templates(cid) == jdet.num_templates(cid) > 0
    for a, b in zip(jdet.bank.templates[cid], tdet.bank.templates[cid]):
        for la, lb in zip(a, b):
            assert (la.width, la.height, la.pyramid_level) == (lb.width, lb.height, lb.pyramid_level)
            np.testing.assert_array_equal(la.features, lb.features)
    for ia, ib in zip(jdet.bank.infos[cid], tdet.bank.infos[cid]):
        assert ia.keys() == ib.keys()
        for key in ia:
            va, vb = np.asarray(ia[key]), np.asarray(ib[key])
            assert va.dtype == vb.dtype and np.array_equal(va, vb), key


def _jax_renderer(fn):
    """A stand-in for the port's batched renderer that renders with JAX's
    (vmapped over the views, as JAX's training does) and hands the port
    its arrays."""
    def render(*args):
        *mesh, Rs, ts, im_size = args
        batch = jax.vmap(lambda R, t: fn(*[jnp.asarray(a.numpy()) for a in mesh], R, t, im_size))
        return tuple(torch.from_numpy(np.array(a)) for a in batch(jnp.asarray(Rs.numpy()), jnp.asarray(ts.numpy())))
    return render


@pytest.mark.parametrize("cid", list(CLASSES))
def test_given_jax_renders_templates_and_infos_equal_jax(cid, jax_banks, monkeypatch):
    monkeypatch.setattr(TT, "render_rgb_depth", _jax_renderer(JR.render_rgb_depth))
    monkeypatch.setattr(TT, "render_textured", _jax_renderer(JR.render_textured))
    jdet, jstats = jax_banks[cid]
    _, tdet = _detectors(CLASSES[cid])
    assert TT.render_train_templates(tdet, cid, make_models()[cid], K, device="cpu", **TRAIN) == jstats
    assert_same_bank(jdet, tdet, cid)


@pytest.mark.parametrize("cid", list(CLASSES))
def test_render_train_templates_end_to_end(cid, jax_banks):
    jdet, jstats = jax_banks[cid]
    _, tdet = _detectors(CLASSES[cid])
    stats = TT.render_train_templates(tdet, cid, make_models()[cid], K, device="cpu", **TRAIN)
    assert stats == jstats and stats["added"] >= 4
    assert_same_bank(jdet, tdet, cid)
    Ki, R0, t0 = TT.template_pose(tdet, cid, 0)
    assert Ki.shape == (3, 3) and R0.shape == (3, 3) and t0.shape == (3, 1)


def test_failed_views_are_counted(jax_banks):
    """A view whose render is empty (the object inside the near clip) adds
    no template and counts as failed."""
    _, tdet = _detectors(True)
    stats = TT.render_train_templates(tdet, "box", make_models()["box"], K, device="cpu",
                                      **dict(TRAIN, radii=[60.0]))
    views = sum(jax_banks["box"][1].values())
    assert stats == {"added": 0, "failed": views} and tdet.num_templates("box") == 0
