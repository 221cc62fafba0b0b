"""Port parity: models/templates.py (torch and numpy) against the JAX package.

Features and bank arrays are integers: identical.  A bank saved by either
package loads in the other unchanged.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from sixdpose_tpu.config import ColorGradientConfig as JColor
from sixdpose_tpu.config import DetectorConfig as JConfig
from sixdpose_tpu.models import templates as JT
from sixdpose_tpu_torch.config import ColorGradientConfig, DetectorConfig
from sixdpose_tpu_torch.models import templates as TT


def _object_view(h=96, w=128, seed=3):
    """A three-colour disc on a dome, pasted on a black canvas at a plane."""
    rng = np.random.default_rng(seed)
    s = 48
    yy, xx = np.mgrid[0:s, 0:s]
    m = ((yy - s / 2) ** 2 + (xx - s / 2) ** 2) < (s / 2 - 4) ** 2
    obj = np.zeros((s, s, 3), np.uint8)
    obj[m] = (60, 170, 230)
    obj[m & (xx > s / 2)] = (230, 90, 30)
    obj[m & (yy > s / 2) & (xx <= s / 2)] = (120, 230, 60)
    obj = np.clip(obj + rng.integers(0, 20, (s, s, 3)), 0, 255).astype(np.uint8)
    r2 = ((yy - s / 2) ** 2 + (xx - s / 2) ** 2) / (s / 2 - 4) ** 2
    rgb = np.zeros((h, w, 3), np.uint8)
    depth = np.full((h, w), 900, np.uint16)
    mask = np.zeros((h, w), np.uint8)
    rgb[24 : 24 + s, 40 : 40 + s] = obj
    dome = (850 - 40 * np.sqrt(np.clip(1 - r2, 0, 1))).astype(np.uint16)
    depth[24 : 24 + s, 40 : 40 + s][m] = dome[m]
    mask[24 : 24 + s, 40 : 40 + s] = m * 255
    return rgb, depth, mask


CASES = [
    (dict(t_at_level=(4, 8), use_depth=False, top_k=16), dict(num_features=24)),
    (dict(t_at_level=(5, 8), top_k=16), dict(num_features=24)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_extract_template(case):
    kw, ckw = CASES[case]
    rgb, depth, mask = _object_view()
    jcfg = JConfig(color=JColor(**ckw), **kw)
    tcfg = DetectorConfig(color=ColorGradientConfig(**ckw), **kw)
    j = JT.extract_template(rgb, depth, mask, jcfg)
    t = TT.extract_template(rgb, depth, mask, tcfg)
    assert j is not None and t is not None
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.features, a.features)
        assert (b.width, b.height, b.pyramid_level) == (a.width, a.height, a.pyramid_level)


def test_select_scattered_features_matches_jax(rng):
    xs = rng.integers(0, 60, 300)
    ys = rng.integers(0, 60, 300)
    sc = rng.random(300)
    for nf, dist in ((20, 6.0), (63, 3.0), (150, 2.5)):
        a = JT.select_scattered_features(xs, ys, sc, nf, dist)
        b = TT.select_scattered_features(xs, ys, sc, nf, dist)
        np.testing.assert_array_equal(b, a)


def _random_levels(rng, n_levels=2):
    out = []
    for l in range(n_levels):
        f = int(rng.integers(10, 30))
        feats = np.stack([rng.integers(0, 40, f), rng.integers(0, 40, f), rng.integers(0, 16, f)], 1)
        out.append((feats, 40 >> l, 36 >> l, l))
    return out


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_bank_roundtrip_between_packages(tmp_path, rng, direction):
    """A bank saved by one package loads in the other with identical
    templates, infos and finalized arrays (kernels, nfeat, wh, feats,
    valid) and padded arrays."""
    jcfg, tcfg = JConfig(t_at_level=(5, 8)), DetectorConfig(t_at_level=(5, 8))
    src, dst = (JT, TT) if direction == "jax_to_torch" else (TT, JT)
    src_bank = src.TemplateBank(jcfg if src is JT else tcfg)
    for i in range(4):
        levels = [src.TemplateLevel(f, w, h, l) for f, w, h, l in _random_levels(rng)]
        src_bank.add_template_levels("obj", levels, info={"view": i})
    path = str(tmp_path / "bank.npz")
    src_bank.save(path)
    dst_bank = dst.TemplateBank.load(path, jcfg if dst is JT else tcfg)
    assert dst_bank.num_templates("obj") == 4
    assert dst_bank.infos["obj"][2]["view"] == 2
    for a, b in zip(src_bank.finalized("obj"), dst_bank.finalized("obj")):
        for name in ("kernels", "nfeat", "wh", "feats", "valid"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
            assert getattr(b, name).dtype == getattr(a, name).dtype
    pa, pb = src_bank.to_padded_arrays()["obj"], dst_bank.to_padded_arrays()["obj"]
    for name in ("feats", "valid", "whp"):
        np.testing.assert_array_equal(pb[name], pa[name])
