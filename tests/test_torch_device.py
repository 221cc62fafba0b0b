"""The port's entry points run on the card unless the caller asks for the CPU.

``Detector``, ``MultiClassMatcher``, the fused pipelines, the multi-scale
matchers, ``extract_template`` and ``TemplateBank.add_template`` resolve
their device the same way (``sixdpose_tpu_torch.device.resolve_device``):
without CUDA their defaults raise one and the same RuntimeError.  CUDA is
hidden with monkeypatch, so the test runs the same on every machine.
"""

import numpy as np
import pytest
import torch

from sixdpose_tpu_torch.config import ColorGradientConfig, DetectorConfig
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.models import templates as TT
from sixdpose_tpu_torch.models.detector import Detector

CFG = DetectorConfig(t_at_level=(4, 8), use_depth=False, top_k=16, color=ColorGradientConfig(num_features=24))


def _view(h=96, w=128):
    """A two-colour disc on a black canvas, and its mask."""
    yy, xx = np.mgrid[0:h, 0:w]
    m = (yy - 48) ** 2 + (xx - 64) ** 2 < 22**2
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[m] = (60, 170, 230)
    rgb[m & (xx > 64)] = (230, 90, 30)
    return rgb, (m * 255).astype(np.uint8)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rgb, mask = _view()
    calls = {
        "Detector": lambda: Detector(CFG),
        "extract_template": lambda: TT.extract_template(rgb, None, mask, CFG),
        "TemplateBank.add_template": lambda: TT.TemplateBank(CFG).add_template("obj", rgb, None, mask),
    }
    messages = {}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA") as err:
            call()
        messages[name] = str(err.value)
    assert len(set(messages.values())) == 1, messages
    # Asked for the CPU, each runs there.
    assert Detector(CFG, device="cpu").device.type == "cpu"
    assert TT.extract_template(rgb, None, mask, CFG, device="cpu") is not None
    assert TT.TemplateBank(CFG).add_template("obj", rgb, None, mask, device="cpu") == 0


def test_resolve_device_names():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda:0")


def test_refine_entry_points_default_to_the_card(monkeypatch):
    """FusedPipeline, build_refine_bank, PoseRefiner and refine_poses raise
    the same RuntimeError without CUDA unless the CPU is asked for."""
    from sixdpose_tpu_torch import synthetic
    from sixdpose_tpu_torch.models import pipeline as TP
    from sixdpose_tpu_torch.models import refine as TR

    rgb, mask = _view()
    depth = np.where(mask > 0, 800, 900).astype(np.uint16)
    det = Detector(CFG, device="cpu")
    info = {
        "icp_points": np.random.default_rng(0).uniform(-0.02, 0.02, (64, 3)).astype(np.float32),
        "cam_R_w2c": np.eye(3), "cam_t_w2c": np.zeros((3, 1)), "render_bbox": np.array([42, 26, 86, 70]),
    }
    assert det.bank.add_template("obj", rgb, None, mask, info, device="cpu") == 0
    K = synthetic.BENCH_K
    model = np.where(mask > 0, 800, 0).astype(np.uint16)
    init = np.eye(4, dtype=np.float32)[None]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "FusedPipeline": lambda **kw: TP.FusedPipeline(det, "obj", K, max_refine=2, **kw),
        "build_refine_bank": lambda **kw: TP.build_refine_bank(det, "obj", **kw),
        "PoseRefiner": lambda **kw: TR.PoseRefiner(**kw),
        "refine_poses": lambda **kw: TR.refine_poses(depth, K, model[None], K, init, **kw),
    }
    messages = {}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA") as err:
            call()
        messages[name] = str(err.value)
        call(device="cpu")
    assert len(set(messages.values())) == 1, messages
    out = TP.FusedPipeline(det, "obj", K, max_refine=2, device="cpu")(rgb, depth, 50.0)
    assert out[4].device.type == "cpu" and out[4].shape == (2, 3, 3)


def test_multiclass_entry_points_default_to_the_card(monkeypatch):
    """MultiClassMatcher and FusedMultiClassPipeline raise the same
    RuntimeError as the other entry points without CUDA unless the CPU is
    asked for, and then run there."""
    from sixdpose_tpu_torch import synthetic
    from sixdpose_tpu_torch.models import pipeline as TP
    from sixdpose_tpu_torch.models.multiclass import MultiClassMatcher

    rgb, mask = _view()
    depth = np.where(mask > 0, 800, 900).astype(np.uint16)
    det = Detector(CFG, device="cpu")
    info = {
        "icp_points": np.random.default_rng(0).uniform(-0.02, 0.02, (64, 3)).astype(np.float32),
        "cam_R_w2c": np.eye(3), "cam_t_w2c": np.zeros((3, 1)), "render_bbox": np.array([42, 26, 86, 70]),
    }
    for cid in ("a", "b"):
        assert det.bank.add_template(cid, rgb, None, mask, info, device="cpu") == 0
    K = synthetic.BENCH_K
    vpts = {c: info["icp_points"] * 1000.0 for c in ("a", "b")}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "Detector": lambda **kw: Detector(CFG, **kw),
        "MultiClassMatcher": lambda **kw: MultiClassMatcher(det, **kw),
        "FusedMultiClassPipeline": lambda **kw: TP.FusedMultiClassPipeline(det, K, max_refine=2, verify_pts=vpts, **kw),
    }
    messages = {}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA") as err:
            call()
        messages[name] = str(err.value)
        assert call(device="cpu").device.type == "cpu"
    assert len(set(messages.values())) == 1, messages
    out = MultiClassMatcher(det, device="cpu").match_arrays(rgb, None, 50.0)
    assert out[0].device.type == "cpu" and out[0].shape == (2, CFG.top_k)
    fused = TP.FusedMultiClassPipeline(det, K, max_refine=2, verify_pts=vpts, device="cpu")(rgb, depth, 50.0)
    assert fused[4].device.type == "cpu" and fused[4].shape == (2, 2, 3, 3)


def test_multiscale_entry_points_default_to_the_card(monkeypatch):
    """MultiScaleDetector and MultiScaleMultiClass raise the same
    RuntimeError as the other entry points without CUDA unless the CPU is
    asked for, and then run there."""
    from sixdpose_tpu_torch.models.multiscale import MultiScaleDetector, MultiScaleMultiClass

    rgb, mask = _view()
    depth = np.where(mask > 0, 800, 1000).astype(np.uint16)
    det = Detector(CFG, device="cpu")
    for cid in ("a", "b"):
        assert det.bank.add_template(cid, rgb, None, mask, device="cpu") == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "Detector": lambda **kw: Detector(CFG, **kw),
        "MultiScaleDetector": lambda **kw: MultiScaleDetector(det, 450.0, num_scales=2, **kw),
        "MultiScaleMultiClass": lambda **kw: MultiScaleMultiClass(det, 450.0, num_scales=2, **kw),
    }
    messages = {}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA") as err:
            call()
        messages[name] = str(err.value)
        assert call(device="cpu").device.type == "cpu"
    assert len(set(messages.values())) == 1, messages
    out = MultiScaleDetector(det, 450.0, num_scales=2, device="cpu").match_arrays(rgb, depth, 50.0, "a")
    assert out[0].device.type == "cpu" and out[0].shape == (CFG.top_k,)
    out = MultiScaleMultiClass(det, 450.0, num_scales=2, device="cpu").match_arrays(rgb, depth, 50.0)
    assert out[6].device.type == "cpu" and out[6].shape == (2, CFG.top_k)


def test_render_train_serve_eval_entry_points_default_to_the_card(monkeypatch):
    """render, render_train_templates, the pose-error metrics, calc_errors,
    PoseEstimationService, make_scene, train_benchmark_bank and
    run_benchmark raise the same RuntimeError as the other entry points
    without CUDA unless the CPU is asked for."""
    from sixdpose_tpu_torch import benchmark as TB
    from sixdpose_tpu_torch.eval import loc, pose_error
    from sixdpose_tpu_torch.geometry.render import render
    from sixdpose_tpu_torch.models.train import render_train_templates
    from sixdpose_tpu_torch.serving import PoseEstimationService

    model = TB.make_models()["box"]
    K = np.array([[84.0, 0, 48], [0, 84.0, 36], [0, 0, 1]])
    R, t = np.eye(3), np.array([0.0, 0.0, 400.0])
    depth = np.zeros((72, 96), np.uint16)
    det = Detector(CFG, device="cpu")
    gts = [{"obj_id": "box", "cam_R_m2c": R, "cam_t_m2c": t}]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "render": lambda **kw: render(model, (96, 72), K, R, t, **kw),
        "render_train_templates": lambda **kw: render_train_templates(
            Detector(CFG, device="cpu"), "box", model, K, [400.0], min_n_views=12, im_size=(96, 72),
            tilt_range=(0.0, 0.1), tilt_step=1.0, **kw),
        "add": lambda **kw: pose_error.add(R, t, R, t, model, **kw),
        "adi": lambda **kw: pose_error.adi(R, t, R, t, model, **kw),
        "vsd": lambda **kw: pose_error.vsd(R, t, R, t, model, depth, K, 15.0, 20.0, **kw),
        "cou": lambda **kw: pose_error.cou(R, t, R, t, model, (96, 72), K, **kw),
        "calc_errors": lambda **kw: loc.calc_errors([{"score": 1.0, "R": R, "t": t}], gts, model, depth, K, **kw),
        "PoseEstimationService": lambda **kw: PoseEstimationService(det, {"box": model}, K, **kw),
        "make_scene": lambda **kw: TB.make_scene({"box": model}, K, (96, 72), np.random.default_rng(0), **kw),
        "train_benchmark_bank": lambda **kw: TB.train_benchmark_bank(
            {"box": model}, K, (96, 72), 12, CFG, verbose=False, **kw),
        "run_benchmark": lambda **kw: TB.run_benchmark(num_scenes=0, min_n_views=12, im_size=(96, 72),
                                                       object_ids=["box"], verbose=False, **kw),
    }
    messages = {}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA") as err:
            call()
        messages[name] = str(err.value)
    assert len(set(messages.values())) == 1, messages
    assert render(model, (96, 72), K, R, t, device="cpu").device.type == "cpu"
    assert PoseEstimationService(det, {"box": model}, K, device="cpu").device.type == "cpu"
    assert pose_error.vsd(R, t, R, t, model, depth, K, 15.0, 20.0, device="cpu") == 1.0
