"""Port parity: data/ (numpy copies) against the JAX package's data/.

Files written by either package are read by the other, byte for byte where
the format is text: PLY meshes (ascii and binary), per-image info and
ground truth, SIXD-2017 results, error lists, colour tables, images and
16-bit depth, and reference template banks (OpenCV FileStorage YAML); and
``get_dataset_params`` gives the same dict for every dataset.
"""

import gzip
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from conftest import REFERENCE_DIR, requires_reference  # noqa: E402
from sixdpose_tpu.data import datasets as JDS  # noqa: E402
from sixdpose_tpu.data import inout as JIO  # noqa: E402
from sixdpose_tpu_torch.data import datasets as TDS  # noqa: E402
from sixdpose_tpu_torch.data import inout as TIO  # noqa: E402
from sixdpose_tpu_torch.models.templates import TemplateLevel  # noqa: E402

REFERENCE_BANK = os.path.join(REFERENCE_DIR, "linemodLevelup", "test", "case1", "127", "06_template.yaml")


def _same(a, b):
    """Equal nested structures of dicts, lists, arrays and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    else:
        assert a == b and type(a) is type(b)


def _model(rng, colors=True, normals=True):
    pts = rng.normal(0, 30, (40, 3))
    m = {"pts": pts, "faces": rng.integers(0, 40, (60, 3))}
    if normals:
        m["normals"] = rng.normal(0, 1, (40, 3))
    if colors:
        m["colors"] = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    return m


@pytest.mark.parametrize("colors,normals", [(True, True), (False, False)])
def test_ply_round_trip(rng, tmp_path, colors, normals):
    m = _model(rng, colors, normals)
    jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    JIO.save_ply(jp, m)
    TIO.save_ply(tp, m)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    _same(JIO.load_ply(jp), TIO.load_ply(jp))


def test_binary_ply(tmp_path):
    """A little-endian binary PLY with a quad (fanned) and texture UVs."""
    vtx = np.zeros(4, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
                             ("blue", "u1"), ("texture_u", "<f4"), ("texture_v", "<f4")])
    vtx["x"], vtx["y"], vtx["z"] = [0, 1, 1, 0], [0, 0, 1, 1], [0.5, 0.25, 0, 1]
    vtx["red"], vtx["texture_u"], vtx["texture_v"] = [10, 20, 30, 40], [0, 1, 1, 0], [0, 0, 1, 1]
    header = (
        "ply\nformat binary_little_endian 1.0\nelement vertex 4\nproperty float x\nproperty float y\n"
        "property float z\nproperty uchar red\nproperty uchar green\nproperty uchar blue\n"
        "property float texture_u\nproperty float texture_v\nelement face 2\n"
        "property list uchar int vertex_indices\nend_header\n"
    ).encode()
    faces = np.array([3], "u1").tobytes() + np.array([0, 1, 2], "<i4").tobytes()
    faces += np.array([4], "u1").tobytes() + np.array([0, 1, 2, 3], "<i4").tobytes()
    path = str(tmp_path / "b.ply")
    with open(path, "wb") as f:
        f.write(header + vtx.tobytes() + faces)
    ref = JIO.load_ply(path)
    assert ref["faces"].shape == (3, 3)
    _same(ref, TIO.load_ply(path))


def test_info_and_gt_round_trip(rng, tmp_path):
    info = {i: {"cam_K": rng.normal(size=(3, 3)), "cam_R_w2c": rng.normal(size=(3, 3)),
                "cam_t_w2c": rng.normal(size=(3, 1)), "depth_scale": 1.0, "elev": 45, "mode": 0} for i in (0, 3, 7)}
    gts = {i: [{"obj_id": 2, "cam_R_m2c": rng.normal(size=(3, 3)), "cam_t_m2c": rng.normal(size=(3, 1)),
                "obj_bb": [1, 2, 30, 40]} for _ in range(2)] for i in (0, 5)}
    for kind, data in (("info", info), ("gt", gts)):
        jp, tp = str(tmp_path / f"j_{kind}.yml"), str(tmp_path / f"t_{kind}.yml")
        getattr(JIO, f"save_{kind}")(jp, data)
        getattr(TIO, f"save_{kind}")(tp, data)
        assert open(jp).read() == open(tp).read()
        _same(getattr(JIO, f"load_{kind}")(jp), getattr(TIO, f"load_{kind}")(tp))


def test_results_sixd17_and_errors(rng, tmp_path):
    res = {"ests": [{"score": float(s), "R": rng.normal(size=(3, 3)), "t": rng.normal(size=(3, 1))}
                    for s in rng.random(3)]}
    jp, tp = str(tmp_path / "j.yml"), str(tmp_path / "t.yml")
    JIO.save_results_sixd17(jp, res, run_time=0.25)
    TIO.save_results_sixd17(tp, res, run_time=0.25)
    assert open(jp).read() == open(tp).read()
    _same(JIO.load_results_sixd17(jp), TIO.load_results_sixd17(jp))
    errs = [{"im_id": 1, "obj_id": 2, "est_id": 0, "score": 0.5, "errors": {0: [1.5]}}]
    JIO.save_errors(jp, errs)
    TIO.save_errors(tp, errs)
    assert open(jp).read() == open(tp).read()
    _same(JIO.load_errors(jp), TIO.load_errors(tp))


def test_colors_images_depth(rng, tmp_path):
    path = str(tmp_path / "obj_rgb.txt")
    with open(path, "w") as f:
        f.write("0.1 0.2 0.3\n\n1 0.5 0\n")
    _same(JIO.load_colors(path), TIO.load_colors(path))
    im = rng.integers(0, 256, (12, 17, 3)).astype(np.uint8)
    depth = rng.integers(0, 65535, (12, 17)).astype(np.uint16)
    TIO.save_im(str(tmp_path / "im.png"), im)
    TIO.save_depth(str(tmp_path / "d.png"), depth)
    _same(JIO.load_im(str(tmp_path / "im.png")), TIO.load_im(str(tmp_path / "im.png")))
    _same(JIO.load_depth(str(tmp_path / "d.png")), TIO.load_depth(str(tmp_path / "d.png")))
    np.testing.assert_array_equal(TIO.load_depth(str(tmp_path / "d.png")), depth)


@pytest.mark.parametrize("name", sorted(JDS._SPECS))
def test_get_dataset_params(name, tmp_path):
    _same(JDS.get_dataset_params(name, str(tmp_path)), TDS.get_dataset_params(name, str(tmp_path)))
    if name == "tless":
        for cam in ("kinect", "canon_3"):
            _same(JDS.get_dataset_params(name, str(tmp_path), cam_type=cam),
                  TDS.get_dataset_params(name, str(tmp_path), cam_type=cam))


def test_camera_file(tmp_path):
    base = tmp_path / "hinterstoisser"
    base.mkdir()
    (base / "camera.yml").write_text("fx: 500.0\nfy: 501.0\ncx: 320.0\ncy: 240.0\nwidth: 640\nheight: 480\n"
                                     "depth_scale: 0.5\n")
    _same(JDS.get_dataset_params("hinterstoisser", str(tmp_path)),
          TDS.get_dataset_params("hinterstoisser", str(tmp_path)))
    with pytest.raises(ValueError):
        TDS.get_dataset_params("nope")


def _filestorage_bank(path: str) -> None:
    """A two-template, two-level, two-modality bank in the reference's
    writeClasses layout (gzipped OpenCV FileStorage YAML)."""
    lines = ["%YAML:1.0", "---", "class_id: obj06", "modalities:", "  - ColorGradient", "  - DepthNormal",
             "pyramid_levels: 2", "template_pyramids:"]
    rng = np.random.default_rng(4)
    for tid in range(2):
        lines += [f"  - template_id: {tid}", "    templates:"]
        for level in range(2):
            for _ in range(2):
                lines += [f"      - width: {int(rng.integers(20, 60))}", f"        height: {int(rng.integers(20, 60))}",
                          f"        pyramid_level: {level}", "        features:"]
                for x, y, label in rng.integers(0, 8, (int(rng.integers(3, 6)), 3)):
                    lines.append(f"          - [ {int(x) * 3}, {int(y) * 2}, {int(label)} ]")
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")


def test_load_reference_template_bank(tmp_path):
    path = str(tmp_path / "templates_obj06.yml.gz")
    _filestorage_bank(path)
    jcid, jt = JIO.load_reference_template_bank(path)
    tcid, tt = TIO.load_reference_template_bank(path)
    assert tcid == jcid == "obj06" and len(tt) == len(jt) == 2
    for jl, tl in zip(jt, tt):
        for a, b in zip(jl, tl):
            assert isinstance(b, TemplateLevel)
            assert (a.width, a.height, a.pyramid_level) == (b.width, b.height, b.pyramid_level)
            _same(a.features, b.features)


@requires_reference
def test_reference_bank_case1():
    """The reference's case1 bank loads into the port as into JAX, and the
    port's TemplateBank takes it."""
    from sixdpose_tpu_torch.config import DetectorConfig
    from sixdpose_tpu_torch.models.detector import Detector

    jcid, jt = JIO.load_reference_template_bank(REFERENCE_BANK)
    tcid, tt = TIO.load_reference_template_bank(REFERENCE_BANK)
    assert tcid == jcid
    for jl, tl in zip(jt, tt):
        for a, b in zip(jl, tl):
            _same(a.features, b.features)
    det = Detector(DetectorConfig(t_at_level=(5, 8)), device="cpu")
    for levels in tt:
        det.bank.add_template_levels(tcid, levels)
    assert det.num_templates(tcid) == len(tt)
    assert os.path.isfile(REFERENCE_BANK)
