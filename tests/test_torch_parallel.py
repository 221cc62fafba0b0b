"""Port parity of the ``parallel`` package against the JAX package, on the
CPU.

The port's ranks are processes (``parallel.distributed.run_ranks``: spawned,
one torch thread each, meeting through a file in a fresh temporary
directory, every join under its own timeout) over gloo; JAX runs its
``shard_map`` programs on the 8 virtual CPU devices of the conftest.  One
spawn of 8 ranks runs every port job of the file:

- ``sharded_detect`` at data 2 x template 4 against JAX's, live, on the
  four-scene bank of tests/test_sharding.py (the feature-sparse path: the
  port has no grouped-conv refinement);
- ``tiled_detect`` at tile 4 on scenes 0 and 2, and
  ``sharded_multiscale_detect`` at template 4, against the JAX golden of
  ``tools/torch_port_parallel_golden.py`` (whose banks the port loads).

- the data-parallel fused frames of ``__graft_entry__.dryrun_multichip``
  at its n = 8 shapes (data 2 x template 4, four 96 x 128 frames):
  ``sharded_detect_refine``, ``fused_multiclass_over_data`` and
  ``multiscale_multiclass_over_data`` against JAX's cores run per frame
  under ``jax.jit`` (the data axis carries no collective, so this is what
  ``shard_map`` over ``P("data")`` computes) and JAX's ``sharded_detect``.

Live candidates are compared in every field; dead slots (score -1) in tid,
score and keep, not in x and y: the port's refinement zeroes dead
candidates as the TPU kernels do, while JAX on the CPU scores them (as in
tests/test_torch_detector.py).  Poses, fitness and verification are held
within ``FUSED_TOL`` (R 1e-4 per entry, t 0.1 mm, 2 points of each count),
with one exception that ROADMAP.md's Queue 3 records: a hypothesis at
whose gates a point flipped (its fitness or verify differs) may end on
another path, so its R and t are held only where it is its class's
best-verified hypothesis, as the LCHF golden holds ICP at 20 iterations.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
jnp = jax.numpy

from __graft_entry__ import _toy_bank
from sixdpose_tpu.config import ColorGradientConfig as JColor
from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.config import IcpConfig as JIcp
from sixdpose_tpu.models.detector import Detector as JDetector
from sixdpose_tpu.models.multiclass import MultiClassMatcher as JMultiClassMatcher
from sixdpose_tpu.models.multiscale import MultiScaleMultiClass as JMultiScaleMultiClass
from sixdpose_tpu.models.multiscale import multiscale_multiclass_core as jmultiscale_multiclass_core
from sixdpose_tpu.models.pipeline import RefineBank as JRefineBank
from sixdpose_tpu.models.pipeline import detect_refine_multiclass_core as jdetect_refine_multiclass_core
from sixdpose_tpu.models.refine import backproject as jbackproject
from sixdpose_tpu.models.refine import icp_point_to_plane as jicp_point_to_plane
from sixdpose_tpu.models.refine import scene_normals as jscene_normals
from sixdpose_tpu.parallel import make_mesh as jmake_mesh
from sixdpose_tpu.parallel import pad_templates as jpad_templates
from sixdpose_tpu.parallel import sharded_detect as jsharded_detect
from sixdpose_tpu.parallel.sharded_match import _merge_topk as j_merge_topk
from sixdpose_tpu.parallel.tiled_match import required_halo as jrequired_halo
from sixdpose_tpu_torch.config import ColorGradientConfig, DetectorConfig, IcpConfig
from sixdpose_tpu_torch.convert import refine_bank_from_numpy
from sixdpose_tpu_torch.models.detector import Detector
from sixdpose_tpu_torch.models.pipeline import FusedMultiClassPipeline
from sixdpose_tpu_torch.models.templates import TemplateLevel
from sixdpose_tpu_torch.parallel import distributed as D
from sixdpose_tpu_torch.parallel import make_mesh, pad_templates
from sixdpose_tpu_torch.parallel.rank_jobs import run_jobs
from sixdpose_tpu_torch.parallel.sharded_match import (
    merge_topk,
    multiscale_class_arrays,
    shard_bank,
    shard_multiscale_bank,
)
from sixdpose_tpu_torch.parallel.tiled_match import required_halo
from sixdpose_tpu_torch.tools import bench_scaling

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")
RANKS = 8
TIMEOUT = 240.0
SHARDED = ("tid", "x", "y", "score", "keep")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(os.path.join(TESTDATA, "parallel_golden.npz")))


def _cfg(features):
    return DetectorConfig(t_at_level=(4, 8), use_depth=False, top_k=16, color=ColorGradientConfig(num_features=features))


@pytest.fixture(scope="module")
def banks():
    det = Detector.read_classes(os.path.join(TESTDATA, "parallel_bank.npz"), _cfg(16), device="cpu")
    ms_det = Detector.read_classes(os.path.join(TESTDATA, "parallel_ms_bank.npz"), _cfg(24), device="cpu")
    return det, ms_det


def _ms_arrays(ms_det, train_depth):
    return multiscale_class_arrays(ms_det.bank.templates["objs"], train_depth, ms_det.cfg.t_at_level[-1])


def _jobs(golden, banks):
    det, ms_det = banks
    levels = det.bank.finalized("objs")
    thr = float(golden["threshold"])
    jobs = [dict(kind="sharded", mesh=(2, 4, 1), levels=levels, rgb=golden["scenes"], depth=None, cfg=det.cfg,
                 threshold=thr)]
    for b in golden["tiled_scenes"]:
        jobs.append(dict(kind="tiled", mesh=(1, 1, 4), levels=levels, rgb=golden["scenes"][b], depth=None,
                         cfg=det.cfg, threshold=thr))
    td = float(golden["ms_train_depth"])
    jobs.append(dict(kind="multiscale", mesh=(1, 4, 1), arrays=_ms_arrays(ms_det, td), rgb=golden["ms_scene"],
                     depth=golden["ms_depth"], cfg=ms_det.cfg, threshold=float(golden["ms_threshold"]),
                     train_depth=td, num_scales=int(golden["ms_scales"])))
    jobs.append(dict(kind="sharded", mesh=(2, 2, 2), levels=levels, rgb=golden["scenes"], depth=None, cfg=det.cfg,
                     threshold=thr))
    return jobs


# -- the dry run's inputs at n = 8 (__graft_entry__.dryrun_multichip) ------------

DRY_MESH = (2, 4, 1)
DRY_CLASSES = ("obj_a", "obj_b")
DRY_THRESHOLDS = (10.0, 50.0)  # the dry run's, and one at which some hypotheses stay inactive
DRY_POINTS = 64
MAX_REFINE, ICP_SEEDS, VERIFY_TAU, MS_TOPK = 2, 2, 8.0, 4
FUSED_TOL = {"R": 1e-4, "t_mm": 0.1, "points": 2}
FUSED = ("tid", "x", "y", "score", "R", "t_mm", "fitness", "verify", "active")
MULTISCALE = ("tid", "x", "y", "score", "keep", "depth_mm", "scale")


def _port_levels(levels):
    return [TemplateLevel(np.asarray(l.features), l.width, l.height, l.pyramid_level) for l in levels]


@pytest.fixture(scope="module")
def dry():
    """The dry run's banks and inputs, drawn from ``default_rng(0)`` in its
    order: the frames, the ICP model points, then the refine bank's clouds
    and chroma."""
    rng = np.random.default_rng(0)
    b, h, w = 4, 96, 128
    out = {"rgb": rng.integers(0, 255, (b, h, w, 3), np.uint8)}
    out["depth"] = (800 + 30 * rng.standard_normal((b, h, w))).astype(np.uint16)
    out["K"] = np.array([[120.0, 0, w / 2], [0, 120.0, h / 2], [0, 0, 1]], np.float32)
    out["model_pts"] = rng.uniform(-0.02, 0.02, (DRY_POINTS, 3)).astype(np.float32)
    out["init_T"] = np.eye(4, dtype=np.float32)
    out["init_T"][2, 3] = 0.8
    out["detect_bank"] = _toy_bank(2 * DRY_MESH[1], size0=24)
    out["class_banks"] = [_toy_bank(3, seed=ci, size0=24) for ci in range(len(DRY_CLASSES))]
    n_total = sum(len(t) for t in out["class_banks"])
    cl = rng.uniform(-0.02, 0.02, (n_total, DRY_POINTS, 3)).astype(np.float32)
    chroma = rng.uniform(0.2, 0.4, (n_total, DRY_POINTS, 2)).astype(np.float32)
    whs = np.array([[l[0].width, l[0].height] for t in out["class_banks"] for l in t], np.int32)
    win = int(-(-(int(whs.max()) + 1) // 16) * 16)
    out["refine"] = ((cl, np.ones((n_total, DRY_POINTS), bool), chroma, cl.mean(1), whs,
                      np.tile(np.eye(4, dtype=np.float32), (n_total, 1, 1))), (win, win))
    out["verify_pts"] = np.stack([cl[0] * 1000.0, cl[-1] * 1000.0]).astype(np.float32)
    return out


def _dry_cfg():
    return DetectorConfig(t_at_level=(4, 8), use_depth=True, top_k=8)


def _dry_jobs(dry):
    cfg = _dry_cfg()
    common = dict(mesh=DRY_MESH, rgb=dry["rgb"], depth=dry["depth"], cfg=cfg)
    det = Detector(cfg, device="cpu")
    for tl in dry["detect_bank"]:
        det.bank.add_template_levels("obj", _port_levels(tl))
    classes = dict(class_ids=list(DRY_CLASSES), templates=[[_port_levels(tl) for tl in t] for t in dry["class_banks"]])
    pipeline = dict(icp=IcpConfig(max_iters=3), max_refine=MAX_REFINE, verify_tau=VERIFY_TAU, icp_seeds=ICP_SEEDS,
                    verify_pts=dict(zip(DRY_CLASSES, dry["verify_pts"])))
    jobs = [dict(kind="detect_icp", levels=det.bank.finalized("obj"), model_pts=dry["model_pts"], K=dry["K"],
                 init_T=np.tile(dry["init_T"], (cfg.top_k, 1, 1)), icp=IcpConfig(max_iters=3), threshold=10.0,
                 **common)]
    jobs += [dict(kind="fused_mc", K=dry["K"], refine=dry["refine"], pipeline=pipeline, threshold=thr, **classes,
                  **common) for thr in DRY_THRESHOLDS]
    jobs.append(dict(kind="fused_ms", train_depth=800.0, num_scales=3, top_k=MS_TOPK, threshold=10.0, **classes,
                     **common))
    return jobs


@pytest.fixture(scope="module")
def all_runs(golden, banks, dry):
    """Per rank, per job of ``_jobs`` then ``_dry_jobs``: the port's results
    on 8 CPU ranks, one spawn."""
    return D.run_ranks(run_jobs, RANKS, ("cpu", _jobs(golden, banks) + _dry_jobs(dry)), device_type="cpu",
                       timeout=TIMEOUT)


@pytest.fixture(scope="module")
def port_runs(all_runs, golden, banks):
    """Per rank, per job of ``_jobs``: the port's results on 8 CPU ranks."""
    n = len(_jobs(golden, banks))
    return [r[:n] for r in all_runs]


@pytest.fixture(scope="module")
def dry_runs(all_runs, golden, banks):
    """Per rank, per job of ``_dry_jobs``."""
    n = len(_jobs(golden, banks))
    return [r[n:] for r in all_runs]


@pytest.fixture(scope="module")
def jax_sharded(golden, banks):
    """JAX's ``sharded_detect`` at data 2 x template 4 on the sparse path,
    over the same bank."""
    det = banks[0]
    jdet = JDetector.read_classes(os.path.join(TESTDATA, "parallel_bank.npz"),
                                  JConfig(t_at_level=(4, 8), use_depth=False, top_k=16, color=JColor(num_features=16)))
    kernels, nfeats, whs = jdet.device_bank("objs")
    feats, valids = jdet._device_feats["objs"]
    pad = lambda arrs: tuple(jnp.asarray(a) for a in jpad_templates(tuple(np.asarray(x) for x in arrs), 4))  # noqa
    nf = tuple(jnp.asarray(np.concatenate([np.asarray(n), np.ones((-len(n)) % 4, np.int32)])) for n in nfeats)
    out = jsharded_detect(jmake_mesh(data=2, template=4), jnp.asarray(golden["scenes"]), None, pad(kernels), nf,
                          pad(whs), jdet.cfg, float(golden["threshold"]), feats=pad(feats), valids=pad(valids))
    assert det.num_templates("objs") == jdet.num_templates("objs")
    return [np.asarray(a) for a in out]


def _assert_same(got, want, names):
    """Every field of the live slots; tid, score and keep of dead ones."""
    score = names.index("score")
    live = want[score] >= 0
    np.testing.assert_array_equal(got[score] >= 0, live)
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype, name
        if name in ("x", "y"):
            np.testing.assert_array_equal(a[live], b[live], err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_sharded_detect_matches_jax(port_runs, jax_sharded):
    got = port_runs[0][0]["outputs"]
    assert got[0].shape == (4, 16)
    _assert_same(got, jax_sharded, SHARDED)
    assert (jax_sharded[3][:, 0] == 100.0).all()  # every scene's object found


def test_sharded_detect_ranks_agree_and_run_the_plain_refine(port_runs):
    """Every rank gathers the same full batch; CPU ranks never launch the
    card's kernel; the tile axis replicates (data 2 x template 2 x tile 2)."""
    for job in (0, len(port_runs[0]) - 1):
        first = port_runs[0][job]["outputs"]
        for r in range(RANKS):
            res = port_runs[r][job]
            assert res["launches"] == 0
            for a, b in zip(res["outputs"], first):
                np.testing.assert_array_equal(a, b)
    assert port_runs[0][-1]["outputs"][0].shape == (4, 16)
    np.testing.assert_array_equal(port_runs[0][-1]["outputs"][3][:, 0], port_runs[0][0]["outputs"][3][:, 0])


@pytest.mark.parametrize("scene", [0, 1])
def test_tiled_detect_matches_jax(port_runs, golden, scene):
    b = int(golden["tiled_scenes"][scene])
    job = 1 + scene
    want = [golden[f"tiled{b}_{k}"] for k in ("tid", "x", "y", "score")]
    for r in range(4):
        _assert_same(port_runs[r][job]["outputs"], want, SHARDED[:4])
    for r in range(4, RANKS):
        assert port_runs[r][job] is None  # beyond the tile mesh


def test_sharded_multiscale_matches_jax(port_runs, golden):
    names = ("tid", "x", "y", "score", "keep", "depth_mm", "scale")
    want = [golden[f"ms_{k}"] for k in names]
    for r in range(4):
        _assert_same(port_runs[r][-2]["outputs"], want, names)
    # The golden holds ties across shards: the merge keeps JAX's order.
    assert len(set(golden["ms_tid"][golden["ms_score"] == golden["ms_score"][0]])) > 1


@pytest.mark.parametrize("shards", [3, 4])
def test_shard_bank_matches_jax_padding(banks, shards):
    """``shard_bank`` gives JAX's ``pad_templates`` shards, ``nfeat`` padded
    with ones as the JAX callers pad it."""
    levels = banks[0].bank.finalized("objs")
    fields = ("kernels", "nfeat", "wh", "feats", "valid")
    for l, b in enumerate(levels):
        padded = jpad_templates(tuple(np.asarray(getattr(b, f)) for f in fields), shards)
        nf = np.concatenate([b.nfeat, np.ones((-len(b.nfeat)) % shards, b.nfeat.dtype)])
        for a, p in zip(pad_templates(tuple(getattr(b, f) for f in fields), shards), padded):
            np.testing.assert_array_equal(a, p)
        n_local = padded[0].shape[0] // shards
        for s in range(shards):
            got = shard_bank(levels, shards, s, "cpu")
            rows = slice(s * n_local, (s + 1) * n_local)
            for t, w in zip((got.kernels, got.nfeats, got.whs, got.feats, got.valids),
                            (padded[0], nf, padded[2], padded[3], padded[4])):
                np.testing.assert_array_equal(t[l].numpy(), w[rows])


def test_shard_multiscale_bank_keeps_the_class_extent(banks, golden):
    arrays = _ms_arrays(banks[1], float(golden["ms_train_depth"]))
    np.testing.assert_array_equal(np.array(arrays["kdims"]), golden["ms_kdims"])
    shards = [shard_multiscale_bank(arrays, 3, s, "cpu") for s in range(3)]
    for l in range(2):
        np.testing.assert_array_equal(torch.cat([b.feats[l] for b in shards]).numpy(),
                                      jpad_templates((arrays["feats"][l],), 3)[0])
    for b in shards:
        assert b.kdims == tuple(arrays["kdims"]) and b.pad_kb == (0, 0)
        np.testing.assert_array_equal(b.cls_kb.numpy(), arrays["cls_kb"])
        np.testing.assert_array_equal(b.pad_map.numpy(), [[0, 1]])
    assert not shards[-1].valids[0][-1].any()  # the padded template has no feature


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_breaks_ties_like_jax_top_k(seed):
    rng = np.random.default_rng(seed)
    s, k = 4, 16
    score = rng.choice(np.array([-1.0, 50.0, 75.0, 100.0], np.float32), (s, k))
    tid = rng.integers(0, 50, (s, k)).astype(np.int32)
    x = np.arange(s * k, dtype=np.int32).reshape(s, k)
    y = x[::-1].copy()
    want = [np.asarray(a) for a in j_merge_topk(*(jnp.asarray(a) for a in (tid, x, y, score)), k)]
    fields = torch.from_numpy(np.stack([tid, x, y, score], 1).astype(np.float64))  # (S, 4, K)
    got = merge_topk(fields, k).numpy()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.astype(np.float64))


@pytest.mark.parametrize("t_at_level,kh", [((4, 8), 40), ((5, 8), 80), ((4, 8, 16), 33)])
def test_required_halo_matches_jax(t_at_level, kh):
    cfg = DetectorConfig(t_at_level=t_at_level)
    assert required_halo(cfg, kh) == jrequired_halo(JConfig(t_at_level=t_at_level), kh)


def test_level0_kernel_height_is_jax_layout(banks):
    """``tiled_detect`` reads kh0 from the kernels as JAX does."""
    jdet = JDetector.read_classes(os.path.join(TESTDATA, "parallel_bank.npz"),
                                  JConfig(t_at_level=(4, 8), use_depth=False, top_k=16, color=JColor(num_features=16)))
    assert banks[0].device_bank("objs").kernels[0].shape[2] == jdet.device_bank("objs")[0][0].shape[2]


@contextlib.contextmanager
def _single_process_group():
    assert not dist.is_initialized()
    try:
        yield D.initialize(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_initialize_makes_a_group_of_one():
    with _single_process_group() as backend:
        assert backend == "gloo" and dist.get_world_size() == 1 and dist.get_rank() == 0
        mesh = make_mesh(device_type="cpu")
        assert tuple(mesh.get_coordinate()) == (0, 0, 0) and mesh.mesh_dim_names == ("data", "template", "tile")
        assert D.global_mesh(device_type="cpu").mesh.shape == (1, 1, 1)


def test_make_mesh_raises_when_too_few_ranks():
    with _single_process_group():
        with pytest.raises(ValueError, match="need 2 ranks, have 1"):
            make_mesh(data=2, device_type="cpu")
        with pytest.raises(ValueError, match="need 8 ranks"):
            make_mesh(template=2, tile=4, device_type="cpu")


def test_backend_rule_is_fixed():
    assert D.backend_for("cpu", 1) == "gloo"
    assert D.backend_for("cuda", torch.cuda.device_count() + 1) == "gloo"  # ranks share a card


@pytest.mark.parametrize("local,backend", [(4, "nccl"), (8, "gloo")])
def test_initialize_picks_the_backend_by_this_hosts_ranks(monkeypatch, local, backend):
    """torchrun over two hosts of four cards (WORLD_SIZE 8, LOCAL_WORLD_SIZE
    4): every rank has a card of its own, so NCCL; eight ranks on one
    four-card host share cards, so gloo."""
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: seen.update(set_device=device))
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: seen.update(backend=backend, **kw))
    for k, v in (("WORLD_SIZE", 8), ("RANK", 5), ("LOCAL_RANK", 1), ("LOCAL_WORLD_SIZE", local)):
        monkeypatch.setenv(k, str(v))
    assert D.initialize(device_type="cuda") == backend
    assert (seen["backend"], seen["world_size"], seen["rank"]) == (backend, 8, 5)
    assert seen["set_device"] == torch.device("cuda", 1)
    assert seen.get("device_id") == (torch.device("cuda", 1) if backend == "nccl" else None)


def test_bench_scaling_bench_workload_is_the_bench_batch():
    cfg, levels, rgb, depth, threshold = bench_scaling.bench_workload(frames_per_dev=4)
    assert (cfg.t_at_level, cfg.top_k, cfg.use_depth, threshold) == ((5, 8), 128, True, 30.0)
    assert rgb.shape == (4, 480, 640, 3) and depth.shape == (4, 480, 640)
    assert [len(b.nfeat) for b in levels] == [89, 89]
    np.testing.assert_array_equal(rgb[3], rgb[0] ^ np.uint8(3))


def test_measure_scaling_returns_sane_rows():
    workload = bench_scaling.random_workload(templates=4, frames_per_dev=1, hw=(64, 96))
    res = D.run_ranks(bench_scaling.scaling_rank, 2, ("cpu",) + workload + ([1, 2], 2), device_type="cpu",
                      timeout=TIMEOUT)
    assert set(res[0]) == {1, 2} and set(res[1]) == {2}  # rank 1 waits out size 1
    assert res[0][1]["efficiency"] == 1.0
    for r in res[0].values():
        assert r["s_per_step"] > 0 and r["efficiency"] > 0
    rows = bench_scaling.scaling_rows(res[0], "cpu", 2)
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["correctness_only"] and "efficiency" not in r for r in rows)


def test_a_failing_rank_fails_the_run():
    """``pow(rank, world, 0)`` raises in every rank: the run raises with the
    rank's traceback instead of returning."""
    with pytest.raises(RuntimeError, match="ValueError"):
        D.run_ranks(pow, 2, (0,), device_type="cpu", timeout=60)


def test_run_ranks_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """Without ``device_type`` the ranks run on CUDA; on a host without a
    card ``run_ranks`` raises before it spawns any rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(D.mp, "get_context", lambda *a: pytest.fail("a rank was spawned"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.run_ranks(pow, 2, (0,), timeout=60)


# -- the data-parallel fused frames against the dry run's JAX programs ------------


def _jax_dry_detector(bank, class_ids):
    jdet = JDetector(JConfig(t_at_level=(4, 8), use_depth=True, top_k=8))
    for cid, templates in zip(class_ids, bank):
        for tl in templates:
            jdet.bank.add_template_levels(cid, tl)
    return jdet


@pytest.fixture(scope="module")
def jax_detect_icp(dry):
    """JAX's ``sharded_detect`` at data 2 x template 4 on the dry run's
    padded sparse bank, then its ICP of every candidate of each frame."""
    jdet = _jax_dry_detector([dry["detect_bank"]], ["obj"])
    kernels, nfeats, whs = jdet.device_bank("obj")
    feats, valids = jdet._device_feats["obj"]
    n_t = DRY_MESH[1]
    pad = lambda arrs: tuple(jnp.asarray(a) for a in jpad_templates(tuple(np.asarray(x) for x in arrs), n_t))  # noqa
    nf = tuple(jnp.asarray(np.concatenate([np.asarray(n), np.ones((-len(n)) % n_t, np.int32)])) for n in nfeats)
    det = jsharded_detect(jmake_mesh(data=DRY_MESH[0], template=n_t), jnp.asarray(dry["rgb"]),
                          jnp.asarray(dry["depth"]), pad(kernels), nf, pad(whs), jdet.cfg, 10.0, feats=pad(feats),
                          valids=pad(valids))
    K, pts, T0 = (jnp.asarray(dry[k]) for k in ("K", "model_pts", "init_T"))
    icp = JIcp(max_iters=3)

    @jax.jit
    def refine(dep):
        scene = jbackproject(dep, K)
        nrm = jscene_normals(scene)

        def per_cand(_):
            T, fit, _rmse = jicp_point_to_plane(pts, jnp.ones((DRY_POINTS,), bool), scene, nrm, K, T0,
                                                icp.corr_dist, icp.max_iters)
            return T, fit

        return jax.vmap(per_cand)(jnp.arange(jdet.cfg.top_k))

    icp_out = [refine(jnp.asarray(d)) for d in dry["depth"]]
    return [np.asarray(a) for a in det] + [np.stack([np.asarray(o[i]) for o in icp_out]) for i in range(2)]


@pytest.fixture(scope="module")
def jax_fused_mc(dry):
    """``detect_refine_multiclass_core`` per frame, as ``fused_mc_step``
    calls it, at each of ``DRY_THRESHOLDS``: {threshold: nine (B, C, R, ...)
    arrays}."""
    jdet = _jax_dry_detector(dry["class_banks"], DRY_CLASSES)
    mc = JMultiClassMatcher(jdet, list(DRY_CLASSES))
    fields, win = dry["refine"]
    rb = JRefineBank(*(jnp.asarray(a) for a in fields), win=win)
    vp = jnp.asarray(dry["verify_pts"])
    vv = jnp.ones(vp.shape[:2], bool)
    K = jnp.asarray(dry["K"])

    @jax.jit
    def frame(rgb, dep, threshold):
        return jdetect_refine_multiclass_core(
            rgb, dep, mc.kernels, mc.nfeats, mc.whs, mc.feats, mc.valids, mc.pad_map, jdet.cfg, threshold, mc.nmax, rb,
            JIcp(max_iters=3), K, MAX_REFINE, vp, vv, None, verify_tau=VERIFY_TAU, icp_seeds=ICP_SEEDS,
        )

    out = {}
    for thr in DRY_THRESHOLDS:
        frames = [frame(jnp.asarray(r), jnp.asarray(d), thr) for r, d in zip(dry["rgb"], dry["depth"])]
        out[thr] = [np.stack([np.asarray(f[i]) for f in frames]) for i in range(len(FUSED))]
    return out


@pytest.fixture(scope="module")
def jax_fused_ms(dry):
    """``multiscale_multiclass_core`` per frame, as ``fused_ms_step`` calls
    it: seven (B, C, K) arrays."""
    jdet = _jax_dry_detector(dry["class_banks"], DRY_CLASSES)
    ms = JMultiScaleMultiClass(jdet, train_depth=800.0, class_ids=list(DRY_CLASSES), num_scales=3)

    @jax.jit
    def frame(rgb, dep):
        return jmultiscale_multiclass_core(
            rgb, dep, ms.feats, ms.valids, ms.whs, ms.pad_map, ms.cls_kb, ms.bin_scales, jdet.cfg, 10.0, ms.num_scales,
            ms.kdims, MS_TOPK, w_bins=ms.w_bins, nf_bins=ms.nf_bins, pad_kb=ms.pad_kb,
        )

    frames = [frame(jnp.asarray(r), jnp.asarray(d)) for r, d in zip(dry["rgb"], dry["depth"])]
    return [np.stack([np.asarray(f[i]) for f in frames]) for i in range(len(MULTISCALE))]


def _ranks_agree(dry_runs, job):
    """Every rank of the mesh gathers the same full batch, and CPU ranks
    never launch the card's kernel; returns rank 0's outputs."""
    first = dry_runs[0][job]["outputs"]
    for r in range(RANKS):
        res = dry_runs[r][job]
        assert res["launches"] == 0
        for a, b in zip(res["outputs"], first):
            np.testing.assert_array_equal(a, b)
    return first


def test_sharded_detect_refine_matches_jax(dry_runs, jax_detect_icp):
    got = _ranks_agree(dry_runs, 0)
    assert got[0].shape == (4, 8) and got[5].shape == (4, 8, 4, 4) and got[6].shape == (4, 8)
    _assert_same(got[:5], jax_detect_icp[:5], SHARDED)
    T, want_T = got[5], jax_detect_icp[5]
    assert np.abs(T[..., :3, :3] - want_T[..., :3, :3]).max() <= FUSED_TOL["R"]
    assert 1000.0 * np.abs(T[..., :3, 3] - want_T[..., :3, 3]).max() <= FUSED_TOL["t_mm"]
    np.testing.assert_array_equal(T[..., 3, :], want_T[..., 3, :])
    assert np.abs(got[6] - jax_detect_icp[6]).max() <= FUSED_TOL["points"] / DRY_POINTS + 1e-6
    assert (got[6] > 0).all()  # every candidate found inliers near the plane


def _fused_errors(got, want, act):
    """Per active hypothesis: the largest R entry and t (mm) error, and
    whether its fitness and verify are equal on both sides."""
    err_R = np.abs(got[4] - want[4]).max(axis=(-1, -2))[act]
    err_t = np.abs(got[5] - want[5]).max(axis=-1)[act]
    same_gates = (got[6] == want[6])[act] & (got[7] == want[7])[act]
    return err_R, err_t, same_gates


@pytest.mark.parametrize("threshold", DRY_THRESHOLDS)
def test_fused_multiclass_over_data_matches_jax(dry_runs, jax_fused_mc, threshold):
    got = _ranks_agree(dry_runs, 1 + DRY_THRESHOLDS.index(threshold))
    want = jax_fused_mc[threshold]
    assert got[0].shape == (4, len(DRY_CLASSES), MAX_REFINE) and got[4].shape == (4, 2, MAX_REFINE, 3, 3)
    act = want[8]
    np.testing.assert_array_equal(got[8], act)
    for i in range(4):
        np.testing.assert_array_equal(got[i][act], want[i][act], err_msg=FUSED[i])
        assert got[i].dtype == want[i].dtype, FUSED[i]
    # Inactive hypotheses read -1 in both rankable outputs, on both sides.
    for side in (got, want):
        assert (side[6][~act] == -1.0).all() and (side[7][~act] == -1.0).all()
    tol = FUSED_TOL["points"] / DRY_POINTS + 1e-6
    assert np.abs(got[6] - want[6])[act].max() <= tol and np.abs(got[7] - want[7])[act].max() <= tol
    err_R, err_t, same_gates = _fused_errors(got, want, act)
    within = (err_R <= FUSED_TOL["R"]) & (err_t <= FUSED_TOL["t_mm"])
    assert within[same_gates].all(), (err_R, err_t)
    assert (~within).sum() <= 1, (err_R, err_t)  # ROADMAP.md Queue 3: frame 3, obj_b, slot 1
    # Each (frame, class)'s best-verified hypothesis is the same and within
    # the tolerance on both sides (the LCHF golden's rule).
    for f, c in zip(*np.nonzero(act.any(-1))):
        best = int(np.argmax(np.where(act[f, c], want[7][f, c], -2.0)))
        assert best == int(np.argmax(np.where(act[f, c], got[7][f, c], -2.0)))
        assert np.abs(got[4][f, c, best] - want[4][f, c, best]).max() <= FUSED_TOL["R"]
        assert np.abs(got[5][f, c, best] - want[5][f, c, best]).max() <= FUSED_TOL["t_mm"]
    assert act.sum() == (16 if threshold == 10.0 else 11)  # every hypothesis live at 10; some inactive at 50


def test_fused_multiclass_over_data_equals_the_pipeline(dry_runs, dry):
    """Each rank's frames are ``FusedMultiClassPipeline``'s, to the bit."""
    det = Detector(_dry_cfg(), device="cpu")
    for cid, templates in zip(DRY_CLASSES, dry["class_banks"]):
        for tl in templates:
            det.bank.add_template_levels(cid, _port_levels(tl))
    fields, win = dry["refine"]
    pipe = FusedMultiClassPipeline(det, dry["K"], list(DRY_CLASSES), icp=IcpConfig(max_iters=3), max_refine=MAX_REFINE,
                                   verify_pts=dict(zip(DRY_CLASSES, dry["verify_pts"])), verify_tau=VERIFY_TAU,
                                   icp_seeds=ICP_SEEDS, refine_bank=refine_bank_from_numpy(fields, win, "cpu"),
                                   device="cpu")
    got = dry_runs[0][1]["outputs"]
    for f in range(len(dry["rgb"])):
        for a, b in zip(got, pipe(dry["rgb"][f], dry["depth"][f], DRY_THRESHOLDS[0])):
            np.testing.assert_array_equal(a[f], b.numpy())


def test_multiscale_multiclass_over_data_matches_jax(dry_runs, jax_fused_ms):
    got = _ranks_agree(dry_runs, 1 + len(DRY_THRESHOLDS))
    assert got[0].shape == (4, len(DRY_CLASSES), MS_TOPK)
    live = jax_fused_ms[3] >= 0
    np.testing.assert_array_equal(got[3] >= 0, live)
    for name, a, b in zip(MULTISCALE, got, jax_fused_ms):
        assert a.dtype == b.dtype, name
        if name in ("tid", "score", "keep"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(a[live], b[live], err_msg=name)
    assert live.sum() >= 4 * len(DRY_CLASSES)
