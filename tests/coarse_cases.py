"""Edge cases of the coarse scorer's contract
(``ops/similarity.py::similarity_multiscale_matmul``), shared by the CPU
tests (the plain gather-sum against the matmul route) and the card tests
(the coarse-scorer kernel against both).  Imports neither JAX nor torch."""

import numpy as np


def edge_case(name):
    """Inputs of one edge case of the coarse scorer's contract: (maps,
    feats, valid, scales, t, kh, kw) as numpy arrays and ints."""
    rng = np.random.default_rng(sum(map(ord, name)))
    kh = kw = 41
    t, b, n, f, c, h, w = 8, None, 23, 37, 16, 96, 128
    scales = [1.0]
    xy_max = (kw + 6, kh + 6)
    if name == "five_scales_with_zeros":
        scales = [0.0, 0.8, 0.0, 1.2, 1.0]
    elif name == "half_ties":  # odd coordinates times .5, 1.5, 2.5 end in .5: rounded half to even
        scales, xy_max, t = [0.5, 1.5, 2.5], (17, 17), 5
    elif name == "extent_border":
        scales = [1.0, 1.03, 0.97]
    elif name == "one_feature":
        f = 1
    elif name == "levelup_max_features":
        n, f, h, w, kh, kw, t = 3, 8191, 64, 80, 33, 33, 4
        xy_max = (kw + 2, kh + 2)
    elif name in ("batch_1", "batch_4"):
        b = int(name[-1])
        scales = [0.9, 1.1]
    elif name == "linemod_padded":  # bottom/right zero blocks, as the multi-scale core pads
        scales = [1.3333334, 0.7058824, 0.0, 0.52173913, 1.0]
        kh, kw, n = 55, 62, 11
        xy_max = (48, 42)
    elif name == "tless_coarse_shape":  # 270 x 360 level-1 maps, 15 x 15 buckets, 620 placements
        n, f, h, w, kh, kw = 12, 62, 270, 360, 113, 113
        xy_max = (kw, kh)
    shape = (c, h, w) if b is None else (b, c, h, w)
    maps = rng.integers(0, 5, shape).astype(np.uint8)
    if name == "linemod_padded":
        pad = [(0, 0)] * (maps.ndim - 2) + [(0, 2 * t), (0, 3 * t)]
        maps = np.pad(maps, pad)
    feats = np.stack(
        [rng.integers(0, xy_max[0], (n, f)), rng.integers(0, xy_max[1], (n, f)), rng.integers(0, c, (n, f))], -1
    ).astype(np.int32)
    if name == "extent_border":  # on, just inside and past the extent's last row and column
        feats[:, :12, 0] = np.tile([kw - 2, kw - 1, kw, kw + 1], 3)
        feats[:, :12, 1] = np.repeat([kh - 1, kh, kh - 2], 4)
    valid = rng.random((n, f)) < 0.85
    valid[min(3, n - 1), :] = False  # a template without features
    return maps, feats, valid, np.array(scales, np.float32), t, kh, kw


EDGE_CASES = ["five_scales_with_zeros", "half_ties", "extent_border", "one_feature", "levelup_max_features",
              "batch_1", "batch_4", "linemod_padded", "tless_coarse_shape"]
