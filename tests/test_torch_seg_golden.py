"""The port's segmentation path against the JAX golden of
``tools/torch_port_seg_golden.py`` (the bin-picking frame at 320 x 240,
f = 272.5), on the CPU.

From the golden's frame the port computes the pixel stage, the seeds, the
ALIC superpixels and the segments.  The seeds, the ALIC indices, the
superpixel means and the segments equal JAX's to the bit; the pixel normals
(XLA's CPU ``rsqrt``, ``tests/test_torch_seg.py``) stay within 2 ulps, and
the superpixel normal means equal JAX's when ALIC starts from JAX's
normals.  Each object's segment is registered against its mesh's surface
points: the same lcp and accept decision as JAX's, R within 1e-5 per entry
and t within 1e-3 mm.  JAX-free: it reads only the golden.
"""

import os

import numpy as np
import pytest
import torch

from sixdpose_tpu_torch import benchmark as TB
from sixdpose_tpu_torch.seg import DaspConfig, alic_iterate, convex_grouping, pose_estimation, superpixel_stage
from sixdpose_tpu_torch.synthetic import mesh_surface_points

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")
SP_FIELDS = ("position", "world", "normal", "color", "density", "num")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # Torch's CPU threads would oversubscribe the cores of parallel workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    g = dict(np.load(os.path.join(TESTDATA, "seg_golden.npz")))
    K = g["K"]
    cfg = DaspConfig(focal_px=float(K[0, 0]), cx=float(K[0, 2]), cy=float(K[1, 2]))
    px, seeds, indices, sp = superpixel_stage(g["rgb"], g["depth"], cfg, int(g["seed_pad"]), device="cpu")
    sp = {k: v.numpy() for k, v in sp.items()}
    segments = convex_grouping(indices.numpy(), sp["world"], sp["normal"], sp["num"], cfg)
    return g, cfg, {"px": px, "seeds": seeds.numpy(), "indices": indices.numpy(), "sp": sp, "segments": segments}


def test_pixel_normals_within_two_ulps(golden):
    g, _, port = golden
    got, want = port["px"]["normal"].numpy(), g["px_normal"]
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 2 and (np.sign(got) == np.sign(want)).all()
    assert (ulps.max(-1) > 0).sum() <= got.shape[0] * got.shape[1] // 4


def test_seeds_superpixels_and_segments_equal_golden(golden):
    g, _, port = golden
    assert np.array_equal(port["seeds"], g["seeds"])
    assert np.array_equal(port["indices"], g["indices"].astype(np.int32))
    for k in SP_FIELDS:
        if k == "normal":  # means of the pixel normals above
            assert np.abs(port["sp"][k] - g["sp_normal"]).max() <= 1e-6
        else:
            assert np.array_equal(port["sp"][k], g[f"sp_{k}"]), k
    assert np.array_equal(port["segments"], g["segments"].astype(np.int64))


def test_alic_from_jax_pixels_equals_golden(golden):
    g, cfg, port = golden
    px = dict(port["px"], normal=torch.from_numpy(g["px_normal"]))
    n, s_pad = len(g["seeds"]), -(-len(g["seeds"]) // int(g["seed_pad"])) * int(g["seed_pad"])
    seed_xy = torch.zeros((s_pad, 2))
    seed_xy[:n] = torch.from_numpy(g["seeds"])
    indices, sp = alic_iterate(px, seed_xy, torch.arange(s_pad) < n, cfg, s_pad)
    assert np.array_equal(indices.numpy(), g["indices"].astype(np.int32))
    for k in SP_FIELDS:
        assert np.array_equal(sp[k].numpy(), g[f"sp_{k}"]), k


@pytest.mark.parametrize("obj", range(9))
def test_registration_equals_golden(golden, obj):
    g, _, port = golden
    s = int(g["reg_segment"][obj])
    cloud = port["px"]["world"].numpy()[port["segments"] == s] * 1000.0
    assert len(cloud) == int(g["reg_points"][obj])
    mesh = TB.make_models()[str(g["obj_ids"][obj])]
    T, lcp = pose_estimation(cloud, mesh_surface_points(mesh, seed=obj), device="cpu")
    want_T, want_lcp = g["reg_T"][obj], float(g["reg_lcp"][obj])
    assert lcp == want_lcp and (lcp > 0.5) == (want_lcp > 0.5)
    assert np.abs(T[:3, :3] - want_T[:3, :3]).max() <= 1e-5
    assert np.abs(T[:3, 3] - want_T[:3, 3]).max() <= 1e-3
