"""Tests of the port that need a CUDA card (marker ``cuda``).

The local-refine kernel against its plain version on the card, the
wrapper's input checks, and the detector on the card against its CPU run.
They import neither JAX nor the JAX package, so a GPU machine without JAX
runs them apart from the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card each test skips.  Scores are sums of small integers in
float32 and counts are integers, so every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import DetectorConfig
from sixdpose_tpu_torch.models.detector import Detector
from sixdpose_tpu_torch.ops import local_refine as LR
from sixdpose_tpu_torch.ops.similarity import similarity_local_sparse

pytestmark = pytest.mark.cuda

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sixdpose_tpu_torch", "testdata")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, c, h, w, t, k, f, xmax=120, ymax=150, b=None, scale=False, active=False):
    rng = np.random.default_rng(seed)
    lead = (k,) if b is None else (b, k)
    maps = rng.integers(0, 5, (c, h, w) if b is None else (b, c, h, w)).astype(np.uint8)
    feats = np.stack(
        [rng.integers(0, xmax, lead + (f,)), rng.integers(0, ymax, lead + (f,)), rng.integers(0, c, lead + (f,))], -1
    ).astype(np.int32)
    valid = rng.random(lead + (f,)) < 0.9
    org = (rng.integers(0, max(1, min(h, w) // t - 4), lead + (2,)) * t).astype(np.int32)
    out = dict(maps=maps, feats=feats, valid=valid, origins=org, scale=None, active=None)
    if scale:
        out["scale"] = rng.uniform(0.4, 1.3, lead).astype(np.float32)
    if active:
        out["active"] = rng.random(lead) < 0.7
    return out


# The shapes of tests/test_pallas.py, a window below 16, a batch of frames,
# F = 700 and F = 61; the levelup maximum F = 8191 (one table pass) and
# F = 9000 (two passes); each split of a candidate into 1, 2 or 4 thread
# groups (chosen from B*K, here for 132 SMs) with F not a multiple of it,
# up to B*K = 1020.
CASES = {
    "vga_t5_K16_F64_scale": (5, 16, dict(c=16, h=480, w=640, t=5, k=16, f=64, scale=True)),
    "t4_K8_F16_active_tails": (4, 16, dict(c=8, h=128, w=128, t=4, k=8, f=16, xmax=30, ymax=30, active=True)),
    "vga_t4_K64_F120_window11": (4, 11, dict(c=16, h=480, w=640, t=4, k=64, f=120)),
    "batch3_t5_K12_F40_active": (5, 16, dict(c=16, h=96, w=128, t=5, k=12, f=40, b=3, active=True)),
    "t5_K5_F700_scale_active": (5, 16, dict(c=16, h=96, w=128, t=5, k=5, f=700, scale=True, active=True)),
    "t4_K9_F61_edges": (4, 16, dict(c=16, h=93, w=122, t=4, k=9, f=61)),
    "t5_K4_F8191_scale_active": (5, 16, dict(c=16, h=480, w=640, t=5, k=4, f=8191, scale=True, active=True)),
    "t5_K3_F9000_two_passes": (5, 16, dict(c=16, h=480, w=640, t=5, k=3, f=9000, scale=True, active=True)),
    "t5_K128_F253_split4": (5, 16, dict(c=16, h=480, w=640, t=5, k=128, f=253, active=True)),
    "t4_K300_F37_split2_window13": (4, 13, dict(c=16, h=203, w=317, t=4, k=300, f=37, scale=True)),
    "batch4_t5_K255_F29_split1": (5, 16, dict(c=16, h=161, w=242, t=5, k=255, f=29, b=4, scale=True, active=True)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain(cuda, name):
    t, window, kw = CASES[name]
    c = _case(list(CASES).index(name), **kw)
    if name.endswith("tails"):
        c["valid"][:, 10:] = False
    args = {n: None if v is None else torch.from_numpy(v).to(cuda) for n, v in c.items()}
    before = LR.similarity_local_sparse_cuda.launches
    ks, kc = LR.similarity_local_sparse_cuda(
        args["maps"], args["feats"], args["valid"], args["origins"], t, window, args["scale"], args["active"]
    )
    ps, pc = similarity_local_sparse(
        args["maps"], args["feats"], args["valid"], args["origins"], t, window, args["scale"], args["active"]
    )
    torch.cuda.synchronize()
    assert LR.similarity_local_sparse_cuda.launches == before + 1
    assert torch.equal(ks, ps) and torch.equal(kc, pc)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    c = _case(1, c=8, h=64, w=64, t=4, k=4, f=8, xmax=20, ymax=20)
    maps, feats, valid, org = (torch.from_numpy(c[n]).to(cuda) for n in ("maps", "feats", "valid", "origins"))
    with pytest.raises(TypeError):
        LR.similarity_local_sparse_cuda(maps.to(torch.int32), feats, valid, org, 4)
    with pytest.raises(ValueError, match="contiguous"):
        LR.similarity_local_sparse_cuda(maps, feats.transpose(0, 1).contiguous().transpose(0, 1), valid, org, 4)
    with pytest.raises(ValueError, match="window"):
        LR.similarity_local_sparse_cuda(maps, feats, valid, org, 4, window=17)
    with pytest.raises(ValueError, match="on cpu"):
        LR.similarity_local_sparse_cuda(maps, feats, valid.cpu(), org, 4)


def _same(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def test_detector_on_card_equals_cpu_run(cuda):
    """A cut bench workload (8 templates) at VGA: the card's result equals
    the port's CPU run everywhere, single frames and a batch, and the
    refine kernel ran."""
    cid, templates, rgb, dep = synthetic.bench_bank(num_templates=8)
    dets = {}
    for device in (cuda, "cpu"):
        dets[device] = Detector(DetectorConfig(t_at_level=(5, 8)), device=device)
        for tl in templates:
            dets[device].bank.add_template_levels(cid, tl)
    before = LR.similarity_local_sparse_cuda.launches
    for thr in (75.0, 30.0):
        gpu = dets[cuda].match_arrays(rgb, dep, thr, cid)
        assert _same(gpu, dets["cpu"].match_arrays(rgb, dep, thr, cid))
    frames = np.stack([rgb, rgb ^ np.uint8(1)])
    batch = dets[cuda].match_batch_arrays(frames, np.stack([dep, dep]), 30.0, cid)
    for i in range(2):
        assert _same([a[i] for a in batch], dets["cpu"].match_arrays(frames[i], dep, 30.0, cid))
    assert LR.similarity_local_sparse_cuda.launches == before + 3


def test_planted_golden_on_card(cuda):
    """The JAX golden of tools/torch_port_golden.py on the card."""
    g = np.load(os.path.join(TESTDATA, "planted_golden.npz"))
    det = Detector.read_classes(
        os.path.join(TESTDATA, "planted_bank.npz"),
        DetectorConfig(t_at_level=tuple(int(v) for v in g["t_at_level"])),
        device=cuda,
    )
    rgb, depth = synthetic.planted_scene(*(int(v) for v in g["scene_xy"]), seed=int(g["scene_seed"]))
    tid, x, y, score, keep = (a.cpu().numpy() for a in det.match_arrays(rgb, depth, float(g["threshold"]), "planted"))
    live = g["score"] >= 0
    np.testing.assert_array_equal(score >= 0, live)
    np.testing.assert_array_equal(keep, g["keep"])
    for a, name in ((tid, "tid"), (x, "x"), (y, "y"), (score, "score")):
        np.testing.assert_array_equal(a[live], g[name][live])
