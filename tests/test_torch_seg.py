"""The port's segmentation path (``sixdpose_tpu_torch/seg``) against the
JAX package's ``seg`` on the CPU, on the same numpy inputs.

Bitwise: the pixel stage's world, color, density and valid maps, the
seeds, the segment-sum plain version, the ALIC indices and superpixel
means, the segments, SLIC and ASP.  The pixel normals are the one
exception: XLA's CPU ``rsqrt`` is the host's ``rsqrtps`` estimate refined
by two Newton steps, which the port does not reproduce; they stay within 2
float32 ulps per component (no sign differs) on under a quarter of the
pixels, and the later stages are held exact from JAX's own pixel maps.
Registration: R within 1e-5 per entry, t within 1e-3 model units, the same
lcp and accept decision.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from sixdpose_tpu.seg import dasp as JD  # noqa: E402
from sixdpose_tpu.seg import registration as JR  # noqa: E402
from sixdpose_tpu.seg import slic as JS  # noqa: E402
from sixdpose_tpu_torch.ops import floyd_steinberg as FS  # noqa: E402
from sixdpose_tpu_torch.ops import segment_sum as SS  # noqa: E402
from sixdpose_tpu_torch.seg import dasp as TD  # noqa: E402
from sixdpose_tpu_torch.seg import registration as TR  # noqa: E402
from sixdpose_tpu_torch.seg import slic as TS  # noqa: E402
import sixdpose_tpu.seg as J  # noqa: E402
import sixdpose_tpu_torch.seg as T  # noqa: E402

K_SCENE = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
CFG = dict(focal_px=200.0, cx=80, cy=60)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # Torch's CPU threads would oversubscribe the cores of parallel workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(noisy: bool = False):
    """tests/test_seg.py's frame: two flat boxes on a tilted ground plane,
    160x120, f=200; ``noisy`` adds depth and color noise from a seed."""
    h, w = 120, 160
    yy = np.mgrid[0:h, 0:w][0]
    depth = (900 + (h - yy) * 3).astype(np.uint16)
    depth[40:80, 20:60] = 700
    depth[30:70, 95:135] = 800
    rgb = np.full((h, w, 3), 120, np.uint8)
    rgb[40:80, 20:60] = (200, 60, 60)
    rgb[30:70, 95:135] = (60, 200, 60)
    if noisy:
        rng = np.random.default_rng(5)
        depth = (depth.astype(np.int32) + rng.integers(-4, 5, depth.shape)).astype(np.uint16)
        depth[rng.random(depth.shape) < 0.02] = 0
        rgb = np.clip(rgb.astype(np.int32) + rng.integers(-10, 11, rgb.shape), 0, 255).astype(np.uint8)
    return rgb, depth


CASES = {"scene": (False, {}), "noisy_r30": (True, {"radius": 0.03})}


@pytest.fixture(scope="module", params=list(CASES))
def jax_run(request):
    """JAX's pixel stage, seeds and ALIC on a case, as numpy."""
    noisy, extra = CASES[request.param]
    rgb, depth = _scene(noisy)
    cfg = dict(CFG, **extra)
    px = JD.pixel_stage(jnp.asarray(rgb), jnp.asarray(depth), JD.DaspConfig(**cfg))
    px = {k: np.array(v) for k, v in px.items()}
    seeds = JD.floyd_steinberg_seeds(px["density"])
    s_pad = -(-len(seeds) // 128) * 128
    seed_xy = np.zeros((s_pad, 2), np.float32)
    seed_xy[: len(seeds)] = seeds
    valid = np.arange(s_pad) < len(seeds)
    idx, sp = JD.alic_iterate({k: jnp.asarray(v) for k, v in px.items()}, jnp.asarray(seed_xy), jnp.asarray(valid),
                              JD.DaspConfig(**cfg), s_pad)
    return dict(rgb=rgb, depth=depth, cfg=cfg, px=px, seeds=seeds, seed_xy=seed_xy, valid=valid, s_pad=s_pad,
                indices=np.asarray(idx), sp={k: np.asarray(v) for k, v in sp.items()})


def test_pixel_stage_matches_jax(jax_run):
    r = jax_run
    px = TD.pixel_stage(torch.from_numpy(r["rgb"]), torch.from_numpy(r["depth"].astype(np.int32)),
                        TD.DaspConfig(**r["cfg"]))
    for k in ("world", "color", "density", "valid"):
        assert np.array_equal(px[k].numpy(), r["px"][k]), k
    got, want = px["normal"].numpy(), r["px"]["normal"]
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    differing = int((ulps.max(-1) > 0).sum())
    assert ulps.max() <= 2 and (np.sign(got) == np.sign(want)).all()
    assert 0 < differing <= got.shape[0] * got.shape[1] // 4, differing


def test_seeds_match_jax(jax_run):
    got = T.floyd_steinberg_seeds(torch.from_numpy(jax_run["px"]["density"]))
    assert np.array_equal(got.numpy(), jax_run["seeds"].astype(np.float32))


@pytest.mark.parametrize("shape,scale", [((1, 1), 0.7), ((7, 1), 0.9), ((37, 51), 0.05), ((40, 50), 0.1),
                                         ((121, 163), 0.3)])
def test_seeds_match_jax_random(shape, scale):
    density = (np.random.default_rng(shape[1]).random(shape) * scale).astype(np.float32)
    want = JD.floyd_steinberg_seeds(density)
    assert np.array_equal(FS.floyd_steinberg_plain(density), want)
    assert np.array_equal(T.floyd_steinberg_seeds(torch.from_numpy(density)).numpy(), want.astype(np.float32))


@pytest.mark.parametrize("n,c,s", [(3000, 13, 57), (500, 3, 1), (800, 7, 300), (64, 2, 9)])
def test_segment_sum_plain_matches_jax(n, c, s):
    """The ordered sums equal XLA's ``segment_sum`` on the CPU to the bit
    (the last segment is the sentinel the JAX update drops)."""
    rng = np.random.default_rng(n + c)
    vals = (rng.normal(0, 1, (n, c)) * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)
    seg = rng.integers(0, s + 1, n).astype(np.int32)
    if s > 3:
        seg[seg == 2] = 3  # an empty segment
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=s + 1))
    got = SS.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), s + 1)
    assert np.array_equal(got.numpy(), want)



@pytest.mark.parametrize("shape,scale", [((64, 80), 0.95), ((1, 700), 0.95), ((33, 47), 1.0), ((5, 301), 0.02),
                                         ((9, 1), 0.6), ((3, FS.MAX_WIDTH), 0.05)])
def test_seeds_match_jax_edge_cases(shape, scale):
    """The kernel's card edge cases for the plain scan: dense seeds, H = 1
    and W = 1, odd heights, the widest width the kernel takes."""
    density = (np.random.default_rng(sum(shape)).random(shape) * scale).astype(np.float32)
    want = JD.floyd_steinberg_seeds(density)
    assert np.array_equal(FS.floyd_steinberg_plain(density), want)
    assert np.array_equal(T.floyd_steinberg_seeds(torch.from_numpy(density)).numpy(), want.astype(np.float32))


@pytest.mark.parametrize("shape", [(4, 32), (5, 33), (6, 64), (3, 1)])
def test_seeds_match_jax_values_exactly_one_half(shape):
    density = np.full(shape, 0.5, np.float32)
    density[1::2, ::3] = 0.25
    want = JD.floyd_steinberg_seeds(density)
    assert len(want) > 0
    assert np.array_equal(T.floyd_steinberg_seeds(torch.from_numpy(density)).numpy(), want.astype(np.float32))


def _segment_edge_case(name):
    """(vals, ids, S) of the segment-sum kernel's card edge cases, cut to
    CPU size."""
    rng = np.random.default_rng(len(name))
    n, c, s = {"one_segment_every_row": (6000, 13, 1), "c1": (5000, 1, 64), "rows_not_a_tile_multiple": (8193, 13, 77),
               "every_id_out_of_range": (3000, 13, 40), "s_above_1024": (20_000, 13, 3000)}[name]
    vals = (rng.normal(0, 1, (n, c)) * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)
    if name == "one_segment_every_row":
        ids = np.zeros(n, np.int64)
    elif name == "every_id_out_of_range":
        ids = np.where(rng.random(n) < 0.5, -1 - rng.integers(0, 5, n), s + rng.integers(0, 5, n))
    else:
        ids = rng.integers(-1, s + 1, n)
    return vals, ids.astype(np.int32), s


SEGMENT_EDGE_CASES = ["one_segment_every_row", "c1", "rows_not_a_tile_multiple", "every_id_out_of_range",
                      "s_above_1024"]


@pytest.mark.parametrize("name", SEGMENT_EDGE_CASES)
def test_segment_sum_plain_matches_jax_edge_cases(name):
    """The kernel's card edge cases for the plain version, against XLA's
    ``segment_sum`` (which drops out-of-range ids too)."""
    vals, ids, s = _segment_edge_case(name)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), num_segments=s))
    got = SS.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), s)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", SEGMENT_EDGE_CASES)
def test_csr_layout_matches_numpy_stable_argsort(name):
    """The plain layout (the card layout's counterpart): the kept rows in
    numpy's stable order by id, and each segment's start and length."""
    _, ids, s = _segment_edge_case(name)
    order, starts, counts = SS.csr_layout(torch.from_numpy(ids), s)
    kept = (ids >= 0) & (ids < s)
    key = np.where(kept, ids, s)
    want = np.argsort(key, kind="stable")[: kept.sum()]
    assert np.array_equal(order.numpy()[: kept.sum()], want)
    n = np.bincount(ids[kept], minlength=s)
    assert np.array_equal(counts.numpy(), n) and np.array_equal(starts.numpy(), np.cumsum(n) - n)

def test_alic_matches_jax(jax_run):
    """ALIC from JAX's own pixel maps: indices and means to the bit."""
    r = jax_run
    px = {k: torch.from_numpy(v) for k, v in r["px"].items()}
    idx, sp = TD.alic_iterate(px, torch.from_numpy(r["seed_xy"]), torch.from_numpy(r["valid"]),
                              TD.DaspConfig(**r["cfg"]), r["s_pad"])
    assert np.array_equal(idx.numpy(), r["indices"])
    for k in r["sp"]:
        assert np.array_equal(sp[k].numpy(), r["sp"][k]), k


def test_convex_grouping_matches_jax(jax_run):
    r = jax_run
    sp = r["sp"]
    want = JD.convex_grouping(r["indices"], sp["world"], sp["normal"], sp["num"], JD.DaspConfig(**r["cfg"]))
    got = TD.convex_grouping(r["indices"], sp["world"], sp["normal"], sp["num"], TD.DaspConfig(**r["cfg"]))
    assert want.max() >= 1 and np.array_equal(got, want)


def test_convex_cloud_seg_matches_jax(jax_run):
    """End to end from the port's own pixel maps: the segments equal JAX's."""
    r = jax_run
    want = J.convex_cloud_seg(r["rgb"], r["depth"], K_SCENE, JD.DaspConfig(**r["cfg"]))
    got = T.convex_cloud_seg(r["rgb"], r["depth"], K_SCENE, TD.DaspConfig(**r["cfg"]), device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_convex_cloud_seg_without_seeds():
    depth = np.zeros((24, 32), np.uint16)
    rgb = np.zeros((24, 32, 3), np.uint8)
    seg, world, normal = T.convex_cloud_seg(rgb, depth, K_SCENE, device="cpu")
    want = J.convex_cloud_seg(rgb, depth, K_SCENE)
    assert (seg == -1).all() and np.array_equal(seg, want[0]) and np.array_equal(normal, want[2])


def test_slic_matches_jax():
    rng = np.random.default_rng(3)
    rgb = np.zeros((64, 96, 3), np.uint8)
    rgb[:, :48] = (220, 40, 40)
    rgb[:, 48:] = (40, 40, 220)
    rgb = np.clip(rgb.astype(np.int16) + rng.integers(-8, 8, rgb.shape), 0, 255).astype(np.uint8)
    for num, comp in ((24, 0.15), (150, 0.4)):
        want = JS.superpixels_slic(rgb, num_superpixels=num, compactness=comp)
        got = TS.superpixels_slic(rgb, num_superpixels=num, compactness=comp, device="cpu")
        assert np.array_equal(got[0], want[0])
        for k in want[1]:
            assert np.array_equal(got[1][k], want[1][k]), k


def test_asp_matches_jax():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    density = np.full((64, 64), 4.0 / (64 * 64), np.float32)
    density[:, 32:] *= 8
    want = JS.superpixels_asp(rgb, density)
    got = TS.superpixels_asp(rgb, density, device="cpu")
    assert np.array_equal(got[0], want[0])
    for k in want[1]:
        assert np.array_equal(got[1][k], want[1][k]), k


def _box_cloud():
    xs, ys, zs = np.linspace(-30, 30, 12), np.linspace(-20, 20, 9), np.linspace(-10, 10, 5)
    faces = [[x, y, z] for x in xs for y in ys for z in (-10, 10)]
    faces += [[x, y, z] for x in xs for z in zs for y in (-20, 20)]
    faces += [[x, y, z] for y in ys for z in zs for x in (-30, 30)]
    return np.unique(np.array(faces, np.float64), axis=0)


def _registration_case(name):
    """The clouds and arguments of tests/test_seg.py's registration tests."""
    from sixdpose_tpu_torch.geometry.transform import rotation_matrix

    if name in ("tri", "auto"):
        rng = np.random.default_rng(0)
        base = rng.uniform(0, 40, (400, 3))
        base[:200, 2] = 0
        base[200:, 0] = 0
        scene = base @ rotation_matrix(0.6, [0.2, 1, 0.3])[:3, :3].T + np.array([30.0, -20.0, 55.0])
        kw = dict(delta=2.0, num_hyp=2048, seed=1)
        return scene, base, dict(kw, method="tri") if name == "tri" else dict(kw, num_hyp=256)
    if name == "garbage":
        rng = np.random.default_rng(3)
        model = rng.uniform(0, 40, (300, 3))
        scene = rng.uniform(200, 400, (300, 3)) * np.array([1, 3, 0.2])
        return scene, model, dict(delta=1.0, num_hyp=512, seed=2)
    rng = np.random.default_rng(5)
    model = _box_cloud()
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    top = model[model[:, 2] > 9.9]
    seg = top @ R.T + np.array([120.0, -40.0, 500.0]) + rng.normal(0, 0.3, top.shape)
    return seg, model, dict(delta=4.0, min_lcp=0.2, method="4pcs", seed=3)


@pytest.mark.parametrize("name", ["tri", "auto", "garbage", "4pcs"])
def test_pose_estimation_matches_jax(name):
    scene, model, kw = _registration_case(name)
    T_j, lcp_j = JR.pose_estimation(scene, model, **kw)
    T_t, lcp_t = TR.pose_estimation(scene, model, device="cpu", **kw)
    min_lcp = kw.get("min_lcp", 0.5)
    assert lcp_t == lcp_j and (lcp_t > min_lcp) == (lcp_j > min_lcp)
    assert np.abs(T_t[:3, :3] - T_j[:3, :3]).max() <= 1e-5
    assert np.abs(T_t[:3, 3] - T_j[:3, 3]).max() <= 1e-3
    if name in ("tri", "4pcs"):
        assert lcp_t > min_lcp


def test_lcp_scores_match_jax():
    """From the same transforms, the LCP scores equal JAX's to the bit,
    points at the gate's edge included."""
    rng = np.random.default_rng(7)
    scene = rng.uniform(0, 40, (300, 3)).astype(np.float32)
    model_eval = scene[rng.choice(300, 64, replace=False)] + rng.normal(0, 1.2, (64, 3)).astype(np.float32)
    Ts = np.tile(np.eye(4, dtype=np.float32), (48, 1, 1))
    Ts[:, :3, 3] = rng.normal(0, 0.5, (48, 3))
    want = np.asarray(JR._lcp_scores(jnp.asarray(Ts), jnp.asarray(model_eval), jnp.asarray(scene), 2.0))
    got = TR._lcp_scores(torch.from_numpy(Ts), torch.from_numpy(model_eval), torch.from_numpy(scene), 2.0)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("points", [3, 4])
def test_kabsch_matches_jax_svd(points):
    """Horn's quaternion by Jacobi sweeps gives JAX's SVD rotation on
    well-spread bases (R within 1e-5, t within 1e-3)."""
    from sixdpose_tpu_torch.geometry.transform import random_rotation

    rng = np.random.default_rng(points)
    src = rng.uniform(-40, 40, (64, points, 3)).astype(np.float32)
    if points == 4:  # a planar base, as 4PCS draws them
        src[..., 2] = 0.0
    dst = np.stack([s @ random_rotation(rng).T + rng.uniform(-100, 100, 3) for s in src]).astype(np.float32)
    want = np.asarray(jax.vmap(JR._kabsch)(jnp.asarray(src), jnp.asarray(dst)))
    got = TR.kabsch(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    assert np.abs(got[:, :3, :3] - want[:, :3, :3]).max() <= 1e-5
    assert np.abs(got[:, :3, 3] - want[:, :3, 3]).max() <= 1e-3
