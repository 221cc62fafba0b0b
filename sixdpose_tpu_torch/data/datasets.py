"""SIXD dataset registry.

A numpy copy of the JAX package's ``data/datasets.py``.  Re-implements the behavior of the reference registry
(params/dataset_params.py:12-188): per-dataset object/scene counts, image
sizes, depth ranges, and path templates for the SIXD directory layout.
Declarative dataclass spec instead of an if/elif chain; path templates are
generated from one layout function.
"""

from __future__ import annotations

import dataclasses
import math
import os
from os.path import join as pjoin
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    obj_count: int
    scene_count: int
    train_im_size: Tuple[int, int]
    test_im_size: Tuple[int, int]
    im_id_pad: int
    test_obj_depth_range: Optional[Tuple[float, float]] = None  # mm
    test_obj_azimuth_range: Optional[Tuple[float, float]] = (0.0, 2 * math.pi)
    test_obj_elev_range: Optional[Tuple[float, float]] = None
    model_type: str = ""
    train_type: str = ""
    test_type: str = ""
    cam_type: str = ""
    has_texture: bool = False


# Reference values: params/dataset_params.py:24-155.
_SPECS = {
    "hinterstoisser": DatasetSpec(
        "hinterstoisser", 15, 15, (640, 480), (640, 480), 4,
        test_obj_depth_range=(346.31, 1499.84),
        test_obj_elev_range=(0.0, 0.5 * math.pi),
    ),
    "tless": DatasetSpec(
        "tless", 30, 20, (400, 400), (720, 540), 4,
        test_obj_depth_range=(649.89, 940.04),
        test_obj_elev_range=(-0.5 * math.pi, 0.5 * math.pi),
        model_type="cad", train_type="primesense",
        test_type="primesense", cam_type="primesense",
    ),
    "tudlight": DatasetSpec(
        "tudlight", 3, 3, (640, 480), (640, 480), 5,
        test_obj_depth_range=(851.29, 2016.14),
        test_obj_elev_range=(-0.4363, 0.5 * math.pi),
    ),
    "toyotalight": DatasetSpec(
        "toyotalight", 21, 21, (640, 480), (640, 480), 4,
    ),
    "rutgers": DatasetSpec(
        "rutgers", 14, 14, (640, 480), (640, 480), 4,
        test_obj_depth_range=(594.41, 739.12),
        test_obj_elev_range=(-0.5 * math.pi, 0.5 * math.pi),
        has_texture=True,
    ),
    "tejani": DatasetSpec(
        "tejani", 6, 6, (640, 480), (640, 480), 4,
        test_obj_depth_range=(509.12, 1120.41),
        test_obj_elev_range=(0.0, 0.5 * math.pi),
    ),
    "doumanoglou": DatasetSpec(
        "doumanoglou", 2, 3, (640, 480), (640, 480), 4,
        test_obj_depth_range=(454.56, 1076.29),
        test_obj_elev_range=(-1.0297, 0.5 * math.pi),
    ),
}


def get_dataset_params(
    name: str,
    base_path: Optional[str] = None,
    model_type: str = "",
    train_type: str = "",
    test_type: str = "",
    cam_type: str = "",
) -> dict:
    """Dataset parameter dict (same keys as the reference's
    get_dataset_params, params/dataset_params.py:12)."""
    if name not in _SPECS:
        raise ValueError(f"unknown SIXD dataset {name!r}")
    spec = _SPECS[name]
    model_type = model_type or spec.model_type
    train_type = train_type or spec.train_type
    test_type = test_type or spec.test_type
    cam_type = cam_type or spec.cam_type

    base = base_path or os.environ.get(
        "SIXD_DATASETS", pjoin(os.getcwd(), "datasets")
    )
    base = pjoin(base, "t-less/t-less_v2" if name == "tless" else name)

    p = dict(
        name=name,
        model_type=model_type,
        train_type=train_type,
        test_type=test_type,
        cam_type=cam_type,
        obj_count=spec.obj_count,
        scene_count=spec.scene_count,
        train_im_size=spec.train_im_size,
        test_im_size=spec.test_im_size,
        im_id_pad=spec.im_id_pad,
        test_obj_depth_range=spec.test_obj_depth_range,
        test_obj_azimuth_range=spec.test_obj_azimuth_range,
        test_obj_elev_range=spec.test_obj_elev_range,
        base_path=base,
    )

    models_dir = "models" if model_type == "" else "models_" + model_type
    train_dir = "train" if train_type == "" else "train_" + train_type
    test_dir = "test" if test_type == "" else "test_" + test_type
    im_f = "{:" + str(spec.im_id_pad).zfill(2) + "d}"

    p["cam_params_path"] = pjoin(base, "camera.yml")
    p["model_mpath"] = pjoin(base, models_dir, "obj_{:02d}.ply")
    p["models_info_path"] = pjoin(base, models_dir, "models_info.yml")
    p["model_texture_mpath"] = (
        pjoin(base, models_dir, "obj_{:02d}.png") if spec.has_texture else None
    )
    p["obj_info_mpath"] = pjoin(base, train_dir, "{:02d}", "info.yml")
    p["obj_gt_mpath"] = pjoin(base, train_dir, "{:02d}", "gt.yml")
    p["train_rgb_mpath"] = pjoin(base, train_dir, "{:02d}", "rgb", im_f + ".png")
    p["train_depth_mpath"] = pjoin(base, train_dir, "{:02d}", "depth", im_f + ".png")
    p["scene_info_mpath"] = pjoin(base, test_dir, "{:02d}", "info.yml")
    p["scene_gt_mpath"] = pjoin(base, test_dir, "{:02d}", "gt.yml")
    p["scene_gt_stats_mpath"] = pjoin(
        base, test_dir + "_gt_stats", "{:02d}_delta={}.yml"
    )
    p["test_rgb_mpath"] = pjoin(base, test_dir, "{:02d}", "rgb", im_f + ".png")
    p["test_depth_mpath"] = pjoin(base, test_dir, "{:02d}", "depth", im_f + ".png")
    p["test_set_fpath"] = pjoin(base, "test_set_v1.yml")

    cam_path = p["cam_params_path"]
    if os.path.exists(cam_path):
        p["cam"] = load_cam_params(cam_path)
    elif (name, cam_type or "") in _BUILTIN_CAMS:
        p["cam"] = _cam_from_dict(_BUILTIN_CAMS[(name, cam_type or "")])
    elif name in _BUILTIN_DEFAULT_CAM:
        p["cam"] = _cam_from_dict(_BUILTIN_DEFAULT_CAM[name])
    else:
        p["cam"] = None
    return p


# Built-in sensor intrinsics for when the dataset's camera.yml is absent
# (values from the dataset toolkits; t_less_toolkit/cam/*.yml for T-LESS,
# the standard Kinect-style calibration used by the SIXD hinterstoisser
# set otherwise).
_BUILTIN_CAMS = {
    # t_less_toolkit/cam/camera_primesense.yml (CARMINE 1.09)
    ("tless", "primesense"): dict(
        fx=1075.65091572, fy=1073.90347929, cx=641.068883438, cy=507.72159802,
        width=1280, height=1024, depth_scale=0.1,
    ),
    # t_less_toolkit/cam/camera_kinect.yml (Kinect v2)
    ("tless", "kinect"): dict(
        fx=1076.74064739, fy=1075.17825536, cx=971.982649675, cy=541.591818362,
        width=1920, height=1080, depth_scale=0.1,
    ),
    # t_less_toolkit/cam/camera_canon_1.yml (IXUS 950 IS, zoom 1; RGB only)
    ("tless", "canon_1"): dict(
        fx=3630.26229559, fy=3627.6973661, cx=1663.14577835, cy=1187.22160257,
        width=3264, height=2448, depth_scale=1.0,
    ),
    # t_less_toolkit/cam/camera_canon_3.yml (IXUS 950 IS, zoom 3; RGB only)
    ("tless", "canon_3"): dict(
        fx=4781.91740099, fy=4778.72123643, cx=1663.66974847, cy=1149.86220751,
        width=3264, height=2448, depth_scale=1.0,
    ),
}
_BUILTIN_DEFAULT_CAM = {
    "hinterstoisser": dict(
        fx=572.4114, fy=573.57043, cx=325.2611, cy=242.04899,
        width=640, height=480, depth_scale=1.0,
    ),
    "tless": _BUILTIN_CAMS[("tless", "primesense")],
}


def _cam_from_dict(c: dict) -> dict:
    return {
        "im_size": (c["width"], c["height"]),
        "K": np.array(
            [[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]]
        ),
        "depth_scale": float(c.get("depth_scale", 1.0)),
    }


def load_cam_params(path: str) -> dict:
    """Camera params YAML (pysixd/inout.py load_cam_params)."""
    import yaml

    with open(path, "r") as f:
        c = yaml.safe_load(f)
    cam = {
        "im_size": (c["width"], c["height"]),
        "K": np.array(
            [[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]]
        ),
    }
    if "depth_scale" in c:
        cam["depth_scale"] = float(c["depth_scale"])
    return cam
