"""Port parity of the geometry package (transform, view_sampler, render)
against the JAX package, on the CPU.

Tolerances:
- transform, view_sampler and ``subdivide_mesh`` are numpy copies: arrays
  equal;
- the rasterizer runs the JAX arithmetic, with XLA's contracted
  multiply-adds reproduced: depth within 1e-3 mm where both renders hit (so
  far equal to the bit), and hit masks and RGB equal apart from a counted
  number of differing pixels, which must be 0.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from sixdpose_tpu.benchmark import make_models
from sixdpose_tpu.geometry import render as JR
from sixdpose_tpu.geometry import transform as JT
from sixdpose_tpu.geometry import view_sampler as JV
from sixdpose_tpu_torch.geometry import render as TR
from sixdpose_tpu_torch.geometry import transform as TT
from sixdpose_tpu_torch.geometry import view_sampler as TV

MODELS = make_models()
K = np.array([[84.0, 0, 48], [0, 84.0, 36], [0, 0, 1]])
IM = (96, 72)
DEPTH_TOL_MM = 1e-3


def _poses(seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        R = JT.random_rotation(rng)
        out.append((R, np.array([rng.uniform(-15, 15), rng.uniform(-10, 10), rng.uniform(380, 520)])))
    return out


def _compare(jax_out, port_out):
    """(hit-mask pixels that differ, RGB pixels that differ, depth max
    abs error where both hit)."""
    if isinstance(jax_out, tuple):
        jr, jd = (np.asarray(a) for a in jax_out)
        pr, pd = (a.numpy() for a in port_out)
        rgb_diff = int((jr != pr).any(-1).sum())
    else:
        jd, pd, rgb_diff = np.asarray(jax_out), port_out.numpy(), 0
    both = (jd > 0) & (pd > 0)
    err = float(np.abs(jd - pd)[both].max()) if both.any() else 0.0
    return int(((jd > 0) != (pd > 0)).sum()), rgb_diff, err


def test_transform_matches_jax():
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(8):
        np.testing.assert_array_equal(TT.random_rotation(rng_a), JT.random_rotation(rng_b))
    assert rng_a.random() == rng_b.random()  # the same draws, in the same order
    np.testing.assert_array_equal(TT.rotation_matrix(0.7, [1, 2, 3]), JT.rotation_matrix(0.7, [1, 2, 3]))
    for axes in ("sxyz", "szyx"):
        np.testing.assert_array_equal(TT.euler_matrix(0.3, -1.1, 2.0, axes), JT.euler_matrix(0.3, -1.1, 2.0, axes))
    M = JT.euler_matrix(0.3, -1.1, 2.0)
    assert TT.euler_from_matrix(M) == JT.euler_from_matrix(M)
    q = TT.quaternion_from_matrix(M)
    np.testing.assert_array_equal(q, JT.quaternion_from_matrix(M))
    np.testing.assert_array_equal(TT.quaternion_matrix(q), JT.quaternion_matrix(q))
    C = TT.compose_rt(M[:3, :3], np.array([1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(C, JT.compose_rt(M[:3, :3], np.array([1.0, 2.0, 3.0])))
    np.testing.assert_array_equal(TT.invert_rt(C), JT.invert_rt(C))
    pts = np.random.default_rng(0).normal(size=(10, 3))
    np.testing.assert_array_equal(TT.transform_pts_Rt(pts, M[:3, :3], C[:3, 3]),
                                  JT.transform_pts_Rt(pts, M[:3, :3], C[:3, 3]))


@pytest.mark.parametrize("n", [12, 40, 80, 300])
def test_view_sampler_matches_jax(n):
    for a, b in zip(TV.hinter_sampling(n, radius=450.0), JV.hinter_sampling(n, radius=450.0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TV.fibonacci_sampling(2 * n + 1), JV.fibonacci_sampling(2 * n + 1))
    kw = dict(radius=450.0, elev_range=(-0.5 * math.pi, 0.5 * math.pi), tilt_step=0.2 * math.pi)
    (tv, tl), (jv, jl) = TV.sample_views(n, **kw), JV.sample_views(n, **kw)
    assert tl == jl and len(tv) == len(jv) > 0
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a["R"], b["R"])
        np.testing.assert_array_equal(a["t"], b["t"])


@pytest.mark.parametrize("cid", ["box", "cup", "texbox"])
def test_subdivide_mesh_matches_jax(cid):
    m = MODELS[cid]
    attrs = np.asarray(m["colors"], np.float64)
    for a, b in zip(TR.subdivide_mesh(m["pts"], m["faces"], 6.0, attrs), JR.subdivide_mesh(m["pts"], m["faces"], 6.0, attrs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cid", list(MODELS))
def test_render_matches_jax(cid):
    """Depth, RGB + depth and, for the textured box, the texture-mapped
    render of each mesh at two poses."""
    m = MODELS[cid]
    for R, t in _poses(sum(map(ord, cid))):
        modes = [("depth", {}), ("rgb+depth", {})]
        if "texture" in m:
            modes.append(("rgb+depth", {"texture": m["texture"]}))
        for mode, kw in modes:
            got = TR.render(dict(m), IM, K, R, t, mode=mode, device="cpu", **kw)
            hit_diff, rgb_diff, err = _compare(JR.render(dict(m), IM, K, R, t, mode=mode, **kw), got)
            assert hit_diff == 0 and rgb_diff == 0 and err <= DEPTH_TOL_MM, (mode, kw.keys(), hit_diff, rgb_diff, err)


@pytest.mark.parametrize("opts", [{"ssaa": 2}, {"surf_color": (0.2, 0.5, 0.9)}])
def test_render_options_match_jax(opts):
    for cid in ("wedge", "texbox"):
        m = MODELS[cid]
        for R, t in _poses(11, 1):
            got = TR.render(dict(m), IM, K, R, t, mode="rgb+depth", texture=m.get("texture"), device="cpu", **opts)
            want = JR.render(dict(m), IM, K, R, t, mode="rgb+depth", texture=m.get("texture"), **opts)
            hit_diff, rgb_diff, err = _compare(tuple(want), got)
            assert hit_diff == 0 and rgb_diff == 0 and err <= DEPTH_TOL_MM, (cid, hit_diff, rgb_diff, err)


def test_render_keeps_the_subdivision_cache():
    """Close poses subdivide (quantized to powers of two), cached on the
    model dict; a flat surf_color reuses the same tessellation."""
    m = dict(MODELS["box"])
    R = np.eye(3)
    TR.render(m, IM, K * 4, R, np.array([0, 0, 300.0]), device="cpu")
    assert len(m["_subdiv_cache"]) == 1
    TR.render(m, IM, K * 4, R, np.array([0, 0, 300.0]), mode="rgb", surf_color=(1, 0, 0), device="cpu")
    assert len(m["_subdiv_cache"]) == 1


def _mesh_tensors(cid):
    m = MODELS[cid]
    pts, faces, cols = TR.subdivide_mesh(m["pts"], m["faces"], 10.0, np.asarray(m["colors"], np.float64))
    return pts.astype(np.float32), faces, (cols / 255.0).astype(np.float32)


def test_depth_batch_matches_jax_and_single_renders():
    pts, faces, _ = _mesh_tensors("lbracket")
    poses = _poses(3, 5)
    Rs = np.stack([R for R, _ in poses]).astype(np.float32)
    ts = np.stack([t for _, t in poses]).astype(np.float32)
    args = (torch.from_numpy(pts), torch.from_numpy(faces), torch.from_numpy(K.astype(np.float32)))
    batch = TR.render_depth_batch(*args, torch.from_numpy(Rs), torch.from_numpy(ts), IM)
    single = torch.stack([TR.render_depth(*args, torch.from_numpy(R), torch.from_numpy(t), IM) for R, t in zip(Rs, ts)])
    assert torch.equal(batch, single)
    want = np.asarray(JR.render_depth_batch(jnp.asarray(pts), jnp.asarray(faces.astype(np.int32)),
                                            jnp.asarray(K.astype(np.float32)), jnp.asarray(Rs), jnp.asarray(ts), IM))
    assert ((want > 0) == (batch.numpy() > 0)).all()
    assert np.abs(want - batch.numpy()).max() <= DEPTH_TOL_MM


def test_batched_colour_renders_match_single_renders():
    pts, faces, cols = _mesh_tensors("cup")
    poses = _poses(4, 3)
    Rs = torch.from_numpy(np.stack([R for R, _ in poses]).astype(np.float32))
    ts = torch.from_numpy(np.stack([t for _, t in poses]).astype(np.float32))
    args = (torch.from_numpy(pts), torch.from_numpy(faces), torch.from_numpy(cols), torch.from_numpy(K.astype(np.float32)))
    rgb_b, dep_b = TR.render_rgb_depth(*args, Rs, ts, IM)
    for i in range(len(poses)):
        rgb, dep = TR.render_rgb_depth(*args, Rs[i], ts[i], IM)
        assert torch.equal(rgb, rgb_b[i]) and torch.equal(dep, dep_b[i])


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_shared_edge_takes_the_last_triangle(order):
    """Two coplanar triangles sharing the diagonal of a square, in two
    colours: both win the diagonal's pixels within half a millimetre, and
    the later triangle colours them, as JAX's in-order scatter does."""
    pts = np.array([[-20, -20, 0], [20, -20, 0], [20, 20, 0], [-20, 20, 0]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]])[list(order)]
    colors = np.array([[1, 0, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32)  # per vertex
    R, t = np.eye(3, dtype=np.float32), np.array([0.0, 0.0, 400.0], np.float32)
    Kf = K.astype(np.float32)
    rgb, dep = TR.render_rgb_depth(torch.from_numpy(pts), torch.from_numpy(tris), torch.from_numpy(colors),
                                   torch.from_numpy(Kf), torch.from_numpy(R), torch.from_numpy(t), IM)
    want_rgb, want_dep = JR.render_rgb_depth(jnp.asarray(pts), jnp.asarray(tris.astype(np.int32)), jnp.asarray(colors),
                                             jnp.asarray(Kf), jnp.asarray(R), jnp.asarray(t), IM)
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(want_rgb))
    np.testing.assert_array_equal(dep.numpy(), np.asarray(want_dep))
    # The diagonal u = v + 12 runs through pixel centres; each triangle's
    # flat colour shows inside it.
    first, second = rgb[33, 51], rgb[39, 45]  # inside [0, 1, 2] and [0, 2, 3]
    assert not torch.equal(first, second)
    later = first if order == (1, 0) else second
    for v in range(33, 40):
        assert torch.equal(rgb[v, v + 12], later), v
