"""Dataset and artifact I/O.

A numpy copy of the JAX package's ``data/inout.py`` (the same files in and
out), except that ``yaml`` and ``PIL`` are imported inside the functions
that use them, so importing the module needs neither.  Covers the reference's pysixd/inout.py surface (YAML info/gt/results, 16-bit
PNG depth, PLY meshes) plus importers for the reference's own artifact
formats (OpenCV FileStorage template banks) so users can migrate banks
trained with the reference implementation.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np


def _yaml():
    """(yaml, its fastest loader): CLoader when libyaml is present
    (inout.py:10-14 does the same)."""
    import yaml

    return yaml, getattr(yaml, "CLoader", yaml.Loader)


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------


def load_im(path: str) -> np.ndarray:
    """Load an RGB(A) or grayscale image as a numpy array."""
    from PIL import Image

    return np.asarray(Image.open(path))


def save_im(path: str, im: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(im).save(path)


def load_depth(path: str) -> np.ndarray:
    """Load a 16-bit PNG depth image in mm (pysixd/inout.py load_depth)."""
    from PIL import Image

    d = np.asarray(Image.open(path))
    return d.astype(np.uint16)


def save_depth(path: str, depth: np.ndarray) -> None:
    """Save uint16 depth as 16-bit PNG (pysixd/inout.py save_depth)."""
    from PIL import Image

    Image.fromarray(depth.astype(np.uint16)).save(path)


# ---------------------------------------------------------------------------
# YAML info / gt / results (pysixd/inout.py:76-178)
# ---------------------------------------------------------------------------


def _listify(d):
    return {k: (np.array(v) if isinstance(v, list) else v) for k, v in d.items()}


def load_info(path: str) -> Dict[int, dict]:
    """Per-image camera info: cam_K (3,3), optional cam_R_w2c, cam_t_w2c,
    depth_scale (pysixd/inout.py:76-87)."""
    yaml, loader = _yaml()
    with open(path, "r") as f:
        info = yaml.load(f, Loader=loader)
    out = {}
    for im_id, v in info.items():
        v = dict(v)
        if "cam_K" in v:
            v["cam_K"] = np.array(v["cam_K"], np.float64).reshape(3, 3)
        if "cam_R_w2c" in v:
            v["cam_R_w2c"] = np.array(v["cam_R_w2c"], np.float64).reshape(3, 3)
        if "cam_t_w2c" in v:
            v["cam_t_w2c"] = np.array(v["cam_t_w2c"], np.float64).reshape(3, 1)
        out[int(im_id)] = v
    return out


def save_info(path: str, info: Dict[int, dict]) -> None:
    """Save per-image info YAML (pysixd/inout.py:88-98)."""
    out = {}
    for im_id in sorted(info.keys()):
        v = dict(info[im_id])
        for key in ("cam_K", "cam_R_w2c", "cam_t_w2c"):
            if key in v:
                v[key] = np.asarray(v[key]).flatten().tolist()
        out[int(im_id)] = v
    yaml, _ = _yaml()
    with open(path, "w") as f:
        yaml.dump(out, f, default_flow_style=None, sort_keys=True)


def load_gt(path: str) -> Dict[int, List[dict]]:
    """Ground-truth poses per image (pysixd/inout.py:100-117)."""
    yaml, loader = _yaml()
    with open(path, "r") as f:
        gts = yaml.load(f, Loader=loader)
    out = {}
    for im_id, entries in gts.items():
        lst = []
        for g in entries:
            g = dict(g)
            if "cam_R_m2c" in g:
                g["cam_R_m2c"] = np.array(g["cam_R_m2c"], np.float64).reshape(3, 3)
            if "cam_t_m2c" in g:
                g["cam_t_m2c"] = np.array(g["cam_t_m2c"], np.float64).reshape(3, 1)
            if "obj_bb" in g:
                g["obj_bb"] = np.array(g["obj_bb"], np.int64)
            lst.append(g)
        out[int(im_id)] = lst
    return out


def save_gt(path: str, gts: Dict[int, List[dict]]) -> None:
    out = {}
    for im_id in sorted(gts.keys()):
        lst = []
        for g in gts[im_id]:
            g = dict(g)
            for key in ("cam_R_m2c", "cam_t_m2c", "obj_bb"):
                if key in g:
                    g[key] = np.asarray(g[key]).flatten().tolist()
            lst.append(g)
        out[int(im_id)] = lst
    yaml, _ = _yaml()
    with open(path, "w") as f:
        yaml.dump(out, f, default_flow_style=None, sort_keys=True)


def save_results_sixd17(path: str, res: dict, run_time: float = -1.0) -> None:
    """SIXD-2017 result file (pysixd/inout.py:147-177)."""
    lines = ["run_time: " + str(run_time), "ests:"]
    for e in res.get("ests", []):
        lines.append(
            "- {{score: {:.8f}, R: {}, t: {}}}".format(
                e["score"],
                np.asarray(e["R"]).flatten().tolist(),
                np.asarray(e["t"]).flatten().tolist(),
            )
        )
    with open(path, "w") as f:
        f.write("\n".join(lines))


def load_results_sixd17(path: str) -> dict:
    yaml, loader = _yaml()
    with open(path, "r") as f:
        d = yaml.load(f, Loader=loader)
    out = {"run_time": d.get("run_time", -1), "ests": []}
    for e in d.get("ests", []) or []:
        out["ests"].append(
            {
                "score": float(e["score"]),
                "R": np.array(e["R"], np.float64).reshape(3, 3),
                "t": np.array(e["t"], np.float64).reshape(3, 1),
            }
        )
    return out


def load_colors(path: str) -> np.ndarray:
    """Per-object color table: one space-separated 'R G B' line per object,
    values in [0, 1] (t_less_toolkit/pytless/inout.py load_colors; the
    toolkit ships data/obj_rgb.txt with one row per T-LESS object)."""
    with open(path, "r") as f:
        lines = [l for l in f.read().splitlines() if l.strip()]
    return np.array([[float(v) for v in l.split()] for l in lines], np.float64)


def load_errors(path: str) -> List[dict]:
    yaml, loader = _yaml()
    with open(path, "r") as f:
        return yaml.load(f, Loader=loader) or []


def save_errors(path: str, errors: List[dict]) -> None:
    yaml, _ = _yaml()
    with open(path, "w") as f:
        yaml.dump(errors, f, default_flow_style=None)


# ---------------------------------------------------------------------------
# PLY meshes (pysixd/inout.py:179-393)
# ---------------------------------------------------------------------------


def load_ply(path: str) -> dict:
    """Load an ascii or binary PLY mesh.

    Returns dict with 'pts' (n,3) float, optional 'normals', 'colors',
    'faces' (m,3) int (triangles; quads are fanned), 'texture_uv'.
    """
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        elems = []  # (name, count, [(prop_type, prop_name) or ('list', idx_t, cnt_t, name)])
        for line in header:
            t = line.split()
            if not t:
                continue
            if t[0] == "element":
                elems.append((t[1], int(t[2]), []))
            elif t[0] == "property" and elems:
                if t[1] == "list":
                    elems[-1][2].append(("list", t[2], t[3], t[4]))
                else:
                    elems[-1][2].append((t[1], t[2]))

        np_types = {
            "char": np.int8, "int8": np.int8,
            "uchar": np.uint8, "uint8": np.uint8,
            "short": np.int16, "int16": np.int16,
            "ushort": np.uint16, "uint16": np.uint16,
            "int": np.int32, "int32": np.int32,
            "uint": np.uint32, "uint32": np.uint32,
            "float": np.float32, "float32": np.float32,
            "double": np.float64, "float64": np.float64,
        }

        model: dict = {}
        for name, count, props in elems:
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().decode("ascii").split())
            if name == "vertex":
                pnames = [p[1] for p in props if p[0] != "list"]
                if fmt == "ascii":
                    arr = np.array(rows, np.float64)
                    data = {pn: arr[:, i] for i, pn in enumerate(pnames)}
                else:
                    dt = np.dtype(
                        [(p[1], np_types[p[0]]) for p in props]
                    ).newbyteorder("<" if "little" in fmt else ">")
                    raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    data = {pn: raw[pn].astype(np.float64) for pn in pnames}
                model["pts"] = np.stack([data["x"], data["y"], data["z"]], 1)
                if "nx" in data:
                    model["normals"] = np.stack([data["nx"], data["ny"], data["nz"]], 1)
                if "red" in data:
                    model["colors"] = np.stack(
                        [data["red"], data["green"], data["blue"]], 1
                    ).astype(np.uint8)
                if "texture_u" in data:
                    model["texture_uv"] = np.stack(
                        [data["texture_u"], data["texture_v"]], 1
                    )
            elif name == "face":
                faces = []
                if fmt == "ascii":
                    for r in rows:
                        n = int(r[0])
                        idx = [int(v) for v in r[1 : 1 + n]]
                        for k in range(1, n - 1):  # fan quads+
                            faces.append([idx[0], idx[k], idx[k + 1]])
                else:
                    lp = next(p for p in props if p[0] == "list")
                    cnt_t = np_types[lp[1]]
                    idx_t = np_types[lp[2]]
                    cnt_size = np.dtype(cnt_t).itemsize
                    idx_size = np.dtype(idx_t).itemsize
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(cnt_size), cnt_t)[0])
                        idx = np.frombuffer(f.read(idx_size * n), idx_t)
                        for k in range(1, n - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
                if faces:
                    model["faces"] = np.array(faces, np.int64)
        return model


def save_ply(path: str, model: dict) -> None:
    """Save an ascii PLY mesh (pts, optional normals/colors/faces)."""
    pts = np.asarray(model["pts"])
    normals = model.get("normals")
    colors = model.get("colors")
    faces = model.get("faces")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            row = f"{p[0]} {p[1]} {p[2]}"
            if normals is not None:
                n = normals[i]
                row += f" {n[0]} {n[1]} {n[2]}"
            if colors is not None:
                c = colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(row + "\n")
        if faces is not None:
            for face in faces:
                f.write("3 " + " ".join(str(int(v)) for v in face) + "\n")


# ---------------------------------------------------------------------------
# Reference template-bank importer (OpenCV FileStorage YAML)
# ---------------------------------------------------------------------------


def load_reference_template_bank(path: str):
    """Import a template bank written by the reference's writeClasses
    (linemodLevelup.cpp:2124-2146, ``templates_%s.yml.gz`` FileStorage YAML).

    Returns (class_id, templates) where templates[i] is a list of
    TemplateLevel (one per pyramid level, the port's
    ``models.templates.TemplateLevel``, what ``TemplateBank`` takes) with
    features (x, y, channel), channel = modality * 8 + orientation label.
    Enables migration of banks trained with the reference implementation.
    """
    import gzip

    from sixdpose_tpu_torch.models.templates import TemplateLevel

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    # Strip the OpenCV FileStorage preamble that standard YAML rejects.
    text = re.sub(r"^%YAML[:\s][^\n]*\n", "", text)
    yaml, loader = _yaml()
    doc = yaml.load(text, Loader=loader)

    class_id = doc["class_id"]
    num_levels = int(doc["pyramid_levels"])
    num_mods = len(doc["modalities"])
    templates = []
    for tp in doc["template_pyramids"]:
        raw_templates = tp["templates"]
        # Reference layout: index l * num_modalities + m (cpp:1951-1967).
        levels = []
        for l in range(num_levels):
            feats = []
            width = height = 0
            for m in range(num_mods):
                t = raw_templates[l * num_mods + m]
                assert int(t["pyramid_level"]) == l
                width = max(width, int(t["width"]))
                height = max(height, int(t["height"]))
                for (x, y, label) in t["features"]:
                    feats.append((int(x), int(y), m * 8 + int(label)))
            levels.append(
                TemplateLevel(
                    features=np.array(feats, np.int64).reshape(-1, 3),
                    width=width,
                    height=height,
                    pyramid_level=l,
                )
            )
        templates.append(levels)
    return class_id, templates
