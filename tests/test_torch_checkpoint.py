"""The bank checkpoint of the port (``TemplateBank.save_checkpoint`` /
``load_checkpoint`` on ``torch.distributed.checkpoint``) against the JAX
package's orbax checkpoint, and its restore onto a template mesh, on the
CPU.

- JAX's ``save_orbax`` / ``load_orbax`` and the port's round trip of the
  same seeded bank give the same classes, templates and infos, and
  ``meta.json``s with the same keys (one module fixture runs JAX once).
- The port's round trip of a two-class bank: 89 templates at two levels
  with uneven feature counts, and a class of one template.
- Four gloo ranks at data 2 x template 2, one spawn: ``load_checkpoint``
  onto the mesh equals the unsharded load, its arrays DTensors sharded over
  ``template``; ``restore_local_bank`` equals ``local_bank`` of the saved
  bank to the bit for the uneven split (89 over 2) and for the class with
  fewer templates than shards; ``sharded_detect`` from the restored shard
  equals the ``levels`` route (which tests/test_torch_parallel.py holds
  against JAX), through ``run_jobs``' checkpoint jobs too.

JAX is imported in its fixture only: the ranks import this module.
"""

import json
import os

import numpy as np
import pytest
import torch

from sixdpose_tpu_torch.config import ColorGradientConfig, DetectorConfig
from sixdpose_tpu_torch.models import checkpoint as CK
from sixdpose_tpu_torch.models.templates import TemplateBank, TemplateLevel
from sixdpose_tpu_torch.parallel import distributed as D
from sixdpose_tpu_torch.parallel import make_mesh
from sixdpose_tpu_torch.parallel.rank_jobs import run_jobs
from sixdpose_tpu_torch.parallel.sharded_match import local_bank, restore_local_bank, sharded_detect, shard_bank

TIMEOUT = 240.0
MESH = (2, 2, 1)
CLASSES = {"many": 89, "one": 1}  # 89 over template 2 splits 45 / 44; one template leaves a rank none
FIELDS = ("kernels", "nfeats", "whs", "feats", "valids")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    return DetectorConfig(t_at_level=(4, 8), use_depth=False, top_k=16, color=ColorGradientConfig(num_features=24))


def _templates(n: int, seed: int) -> list:
    """``n`` templates at two levels, sizes and feature counts drawn per
    template and level (level 1 at half the size)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = int(rng.integers(16, 41))
        levels = []
        for l in range(2):
            s = size >> l
            f = int(rng.integers(2, 25 >> l))
            feats = np.stack([rng.integers(0, s, f), rng.integers(0, s, f), rng.integers(0, 8, f)], 1)
            levels.append(TemplateLevel(features=feats.astype(np.int64), width=s, height=s, pyramid_level=l))
        out.append(levels)
    return out


def _bank(cls, cfg, classes: dict, seed: int = 0):
    """A bank of either package: per class its seeded templates, each with
    the infos of tests/test_checkpoint.py."""
    bank = cls(cfg)
    for c, (cid, n) in enumerate(classes.items()):
        for i, levels in enumerate(_templates(n, seed + c)):
            bank.add_template_levels(cid, levels, {"cam_R_m2c": np.eye(3).ravel(), "view": i})
    return bank


def _templates_of(bank) -> dict:
    return {cid: [[(lv.features.tolist(), lv.width, lv.height, lv.pyramid_level) for lv in t] for t in tl]
            for cid, tl in bank.templates.items()}


def _frames(seed: int = 5):
    return np.random.default_rng(seed).integers(0, 256, (2, 96, 128, 3), np.uint8)


# -- parity with the JAX package's orbax checkpoint --------------------------------


@pytest.fixture(scope="module")
def jax_roundtrip(tmp_path_factory):
    """JAX's ``save_orbax`` then ``load_orbax`` of the seeded bank, and
    JAX's ``meta.json``."""
    pytest.importorskip("jax")
    from sixdpose_tpu.config import ColorGradientConfig as JColor
    from sixdpose_tpu.config import DetectorConfig as JConfig
    from sixdpose_tpu.models.templates import TemplateBank as JBank
    from sixdpose_tpu.models.templates import TemplateLevel as JLevel

    cfg = JConfig(t_at_level=(4, 8), use_depth=False, top_k=16, color=JColor(num_features=24))
    bank = JBank(cfg)
    for c, (cid, n) in enumerate({"obj": 6, "obj_b": 3}.items()):
        for i, levels in enumerate(_templates(n, c)):
            bank.add_template_levels(cid, [JLevel(lv.features, lv.width, lv.height, lv.pyramid_level) for lv in levels],
                                     {"cam_R_m2c": np.eye(3).ravel(), "view": i})
    path = str(tmp_path_factory.mktemp("orbax") / "ckpt")
    bank.save_orbax(path)
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    return JBank.load_orbax(path, cfg), meta


def test_roundtrip_equals_jax_orbax(jax_roundtrip, tmp_path):
    jback, jmeta = jax_roundtrip
    bank = _bank(TemplateBank, _cfg(), {"obj": 6, "obj_b": 3})
    bank.save_checkpoint(str(tmp_path / "ckpt"))
    back = TemplateBank.load_checkpoint(str(tmp_path / "ckpt"), _cfg())
    assert back.class_ids() == jback.class_ids() == ["obj", "obj_b"]
    assert _templates_of(back) == _templates_of(jback)
    assert back.infos == jback.infos
    assert back.infos["obj"][3] == {"cam_R_m2c": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0], "view": 3}
    with open(tmp_path / "ckpt" / "meta.json") as fh:
        meta = json.load(fh)
    assert meta.keys() == jmeta.keys() == {"classes", "infos", "config"}
    assert meta["classes"] == jmeta["classes"] and meta["infos"] == jmeta["infos"]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["arrays", "meta.json"]


# -- the port's round trip ---------------------------------------------------------


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The two-class bank and its checkpoint directory."""
    bank = _bank(TemplateBank, _cfg(), CLASSES)
    path = str(tmp_path_factory.mktemp("bank") / "ckpt")
    bank.save_checkpoint(path)
    return bank, path


def test_roundtrip_keeps_templates_arrays_and_infos(saved):
    bank, path = saved
    back = TemplateBank.load_checkpoint(path, _cfg())
    assert back.class_ids() == list(CLASSES)
    assert _templates_of(back) == _templates_of(bank)
    for cid, want in bank.to_padded_arrays().items():
        got = back.to_padded_arrays()[cid]
        for name in CK.ARRAYS:
            assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]), (cid, name)
    assert back.infos == {cid: [{"cam_R_m2c": np.eye(3).ravel().tolist(), "view": i} for i in range(n)]
                          for cid, n in CLASSES.items()}
    feats = bank.to_padded_arrays()["many"]["feats"]
    assert len({len(lv.features) for t in bank.templates["many"] for lv in t}) > 1  # uneven F
    assert CK.stored_shapes(os.path.join(path, "arrays"))["many/feats"] == (feats.shape, torch.int32)


# -- four gloo ranks at data 2 x template 2 -----------------------------------------


def _numpy_bank(bank) -> dict:
    return {f: [t.numpy() for t in getattr(bank, f)] for f in FIELDS}


def _restore_rank(rank, world, path, bank, mesh_shape):
    """What a rank of the spawn checks: the mesh load, the local restore
    against ``local_bank`` and ``sharded_detect`` from both."""
    cfg = _cfg()
    mesh = make_mesh(*mesh_shape, device_type="cpu")
    full = TemplateBank.load_checkpoint(path, cfg, mesh)
    out = {"coordinate": tuple(mesh.get_coordinate()), "templates": _templates_of(full), "infos": full.infos,
           "shards": {cid: {n: (type(t).__name__, [(type(p).__name__, getattr(p, "dim", None)) for p in t.placements], tuple(t.to_local().shape))
                            for n, t in named.items()} for cid, named in full.shards.items()},
           "restored": {}, "local": {}, "detect": {}}
    frames = _frames()
    for cid in CLASSES:
        restored = restore_local_bank(mesh, path, cid, cfg, "cpu")
        local = local_bank(mesh, bank.finalized(cid), "cpu")
        out["restored"][cid], out["local"][cid] = _numpy_bank(restored), _numpy_bank(local)
        out["detect"][cid] = [[a.numpy() for a in sharded_detect(mesh, frames, None, b, cfg, 30.0)]
                              for b in (restored, local)]
    if mesh_shape != MESH:
        return out
    common = dict(rgb=frames, depth=None, cfg=cfg, threshold=30.0)
    jobs = []
    for cid in CLASSES:
        jobs += [dict(kind="sharded", mesh=MESH, levels=bank.finalized(cid), **common),
                 dict(kind="sharded", mesh=MESH, checkpoint=path, class_id=cid, **common)]
    jobs += [dict(kind="tiled", mesh=(1, 1, 2), levels=bank.finalized("many"), **dict(common, rgb=frames[0])),
             dict(kind="tiled", mesh=(1, 1, 2), checkpoint=path, class_id="many", **dict(common, rgb=frames[0]))]
    out["jobs"] = run_jobs(rank, world, "cpu", jobs)
    return out


@pytest.fixture(scope="module")
def ranks(saved):
    bank, path = saved
    return D.run_ranks(_restore_rank, 4, (path, bank, MESH), device_type="cpu", timeout=TIMEOUT)


def test_mesh_load_equals_the_unsharded_load(saved, ranks):
    bank, path = saved
    back = TemplateBank.load_checkpoint(path, _cfg())
    for r in ranks:
        assert r["templates"] == _templates_of(back) and r["infos"] == back.infos
        t_idx = r["coordinate"][1]
        for cid, n in CLASSES.items():
            block = -(-n // 2)
            rows = max(0, min(block, n - t_idx * block))
            for name, (kind, placements, local) in r["shards"][cid].items():
                assert kind == "DTensor" and placements == [("Replicate", None), ("Shard", 0), ("Replicate", None)], name
                assert local[0] == rows, (cid, name, local)


@pytest.mark.parametrize("cid", list(CLASSES))
def test_restore_local_bank_equals_local_bank(ranks, cid):
    for r in ranks:
        for f in FIELDS:
            for a, b in zip(r["restored"][cid][f], r["local"][cid][f]):
                assert a.dtype == b.dtype and np.array_equal(a, b), (r["coordinate"], cid, f)


@pytest.mark.parametrize("cid", list(CLASSES))
def test_sharded_detect_from_the_restored_shard_equals_the_levels_route(ranks, cid):
    for r in ranks:
        got, want = r["detect"][cid]
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), r["coordinate"]
    assert (ranks[0]["detect"][cid][1][3] >= 0).any()  # candidates live


def test_run_jobs_checkpoint_jobs_equal_the_levels_jobs(saved, ranks):
    bank, path = saved
    total = sum(os.path.getsize(os.path.join(path, "arrays", f)) for f in os.listdir(os.path.join(path, "arrays")))
    for r in ranks:
        jobs = r["jobs"]
        for i in range(0, len(jobs), 2):
            levels, ckpt = jobs[i], jobs[i + 1]
            if levels is None:
                assert ckpt is None
                continue
            assert all(np.array_equal(a, b) for a, b in zip(ckpt["outputs"], levels["outputs"]))
            assert ckpt["launches"] == levels["launches"]
            restore = ckpt["restore"]
            assert restore["seconds"] > 0 and 0 < restore["bytes_read"] < total
        t_idx = r["coordinate"][1]
        for j, cid in enumerate(CLASSES):
            want = shard_bank(bank.finalized(cid), 2, t_idx, "cpu")
            for lv, wk, wn, ww, wf, wv in zip(jobs[2 * j + 1]["restore"]["levels"], *(getattr(want, f) for f in FIELDS)):
                for a, b in zip((lv.kernels, lv.nfeat, lv.wh, lv.feats, lv.valid), (wk, wn, ww, wf, wv)):
                    assert np.array_equal(a, b.numpy())
    # a template-1 rank of the 89-template class reads fewer blocks than the whole class
    many = [r["jobs"][1]["restore"]["bytes_read"] for r in ranks]
    whole = [r["jobs"][5]["restore"]["bytes_read"] for r in ranks if r["jobs"][5] is not None]
    assert max(many) < min(whole)
