"""Image quantization: color-gradient and depth-normal modalities.

PyTorch port of the JAX package's ``ops/quantize.py``; the behaviour is the
reference's (linemodLevelup.cpp ``quantizedOrientations`` cpp:350-505 and
``quantizedNormals`` cpp:729-819) and the results are bit-identical to the
JAX functions:

- everything up to the phase function is integer arithmetic, or float32
  arithmetic on small integers that is exact in any order;
- the fastAtan2 polynomial is written as separate float32 operations in the
  JAX order, so no fused multiply-add can change a bin;
- the depth-normal azimuth goes through ``torch.atan2``, which may differ
  from XLA's by an ulp; that can only move a pixel whose azimuth lies on a
  bin's half-way point.

Every function takes leading batch dimensions: colour images are
``(..., H, W, 3)``, single-channel images ``(..., H, W)``.  Depth arrives as
int32 holding the uint16 millimetres (torch's uint16 supports few ops).
"""

from __future__ import annotations

import numpy as np
import torch

from sixdpose_tpu_torch.ops.sqrt import sqrt32

# The JAX package's quantizer version: the same behaviour, so a bank cache
# written by either package stays valid for the other (see
# benchmark.train_benchmark_bank).
QUANTIZER_VERSION = "v3-fastatan2-fixedpoint-blur"

# OpenCV's 7-tap Gaussian for sigma=0, times 256 (exact).
_GAUSS7_256 = (8, 28, 56, 72, 56, 28, 8)

# 5-tap kernel used by cv::pyrDown (exact in float32).
_PYR5 = tuple(float(v) for v in np.array([1, 4, 6, 4, 1], np.float32) / np.float32(16))


def _f32(v: float, device) -> torch.Tensor:
    """A float32 scalar rounded the way ``jnp.float32(v)`` rounds it, made on
    ``device`` by a fill (a host-to-device copy would wait for the device)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32, device=device)


def _pad_index(n: int, r: int, mode: str, device) -> torch.Tensor:
    """Source index of each of the n + 2r positions of a padded axis:
    ``edge`` replicates the border, ``reflect`` mirrors without repeating
    it (numpy's "reflect", OpenCV's BORDER_REFLECT_101)."""
    i = torch.arange(-r, n + r, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    i = i.abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _pad2(x: torch.Tensor, r: int, mode: str, dims=(-2, -1)) -> torch.Tensor:
    """Pad two axes of ``x`` by r on each side (edge or reflect)."""
    for d in dims:
        idx = _pad_index(x.shape[d], r, mode, x.device)
        x = x.index_select(d, idx)
    return x


def gaussian_blur7_u8(img: torch.Tensor) -> torch.Tensor:
    """7x7 Gaussian blur of a uint8 image, rounded back to uint8.

    Bit-exact with cv::GaussianBlur(7x7, sigma=0, BORDER_REPLICATE) on 8-bit
    input: the kernel is [8,28,56,72,56,28,8]/256, both passes are integer
    sums and the result rounds half up ((acc + 2^15) >> 16).

    ``img``: (H, W) or (..., H, W, C) uint8.
    """
    r = 3
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    h, w = x.shape[-3], x.shape[-2]
    p = _pad2(x.to(torch.int32), r, "edge", dims=(-3, -2))
    hor = sum(k * p.narrow(-2, i, w) for i, k in enumerate(_GAUSS7_256))
    ver = sum(k * hor.narrow(-3, i, h) for i, k in enumerate(_GAUSS7_256))
    out = ((ver + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)
    return out[..., 0] if squeeze else out


def _sobel3(img_u8: torch.Tensor):
    """3x3 Sobel dx, dy (replicate border) on (..., C, H, W) uint8 -> int32."""
    x = img_u8.to(torch.int32)
    h, w = x.shape[-2], x.shape[-1]
    p = _pad2(x, 1, "edge")

    def sh(dy, dx):
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    dx = (sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1)) - (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1))
    dy = (sh(1, -1) + 2 * sh(1, 0) + sh(1, 1)) - (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1))
    return dx, dy


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``fastAtan2`` polynomial in float32, degrees [0, 360).

    The reference's orientation comes from ``cv::phase`` (cpp:423).  Each
    operation is a separate float32 op in the JAX order, so the bins are
    those of the JAX function (and of OpenCV).
    """
    dev = x.device
    k = 180.0 / np.pi
    p1 = _f32(0.9997878412794807 * k, dev)
    p3 = _f32(-0.3258083974640975 * k, dev)
    p5 = _f32(0.1555786518463281 * k, dev)
    p7 = _f32(-0.04432655554792128 * k, dev)
    eps = _f32(2.220446049250313e-16, dev)  # (float)DBL_EPSILON
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    ax, ay = x.abs(), y.abs()
    steep = ax >= ay
    c = torch.where(steep, ay / (ax + eps), ax / (ay + eps))
    c2 = c * c
    poly = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(steep, poly, _f32(90.0, dev) - poly)
    a = torch.where(x < 0, _f32(180.0, dev) - a, a)
    return torch.where(y < 0, _f32(360.0, dev) - a, a)


def exact_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """IEEE atan2 in degrees [0, 360) — the ``phase="exact"`` variant."""
    a = torch.atan2(y.to(torch.float32), x.to(torch.float32)) * _f32(180.0 / np.pi, x.device)
    return torch.where(a < 0, a + _f32(360.0, x.device), a)


def _box3_votes(eq: torch.Tensor) -> torch.Tensor:
    """3x3 zero-padded box sum of an int32 (..., H, W) plane."""
    h, w = eq.shape[-2], eq.shape[-1]
    p = torch.nn.functional.pad(eq, (1, 1, 1, 1))
    rows3 = p[..., 0:h, :] + p[..., 1 : h + 1, :] + p[..., 2 : h + 2, :]
    return rows3[..., 0:w] + rows3[..., 1 : w + 1] + rows3[..., 2 : w + 2]


def _interior(h: int, w: int, lo: int, hi: int, device) -> torch.Tensor:
    """(H, W) mask of rows in [lo, h - hi) and columns in [lo, w - hi)."""
    row = torch.arange(h, device=device)[:, None]
    col = torch.arange(w, device=device)[None, :]
    return (row >= lo) & (row < h - hi) & (col >= lo) & (col < w - hi)


def quantize_color_gradient(rgb: torch.Tensor, weak_threshold: float = 10.0, phase: str = "cv"):
    """Quantize RGB gradients to 8 orientation bits (cpp:350-505).

    Args:
      rgb: (..., H, W, 3) uint8 image.
      weak_threshold: magnitude gate, compared squared (cpp:423).
      phase: ``"cv"`` (OpenCV's fastAtan2, the reference's own) or
        ``"exact"`` (IEEE atan2).

    Returns:
      quantized: (..., H, W) uint8 one-hot orientation byte (0 = none).
      magnitude: (..., H, W) float32 squared gradient magnitude of the
        dominant channel.
    """
    h, w = rgb.shape[-3], rgb.shape[-2]
    blurred = torch.movedim(gaussian_blur7_u8(rgb), -1, -3)  # (..., 3, H, W)
    dx, dy = _sobel3(blurred)
    mag = (dx * dx + dy * dy).to(torch.float32)

    # Channel with the largest squared magnitude; ties keep the lower
    # channel (the reference's >= cascade, cpp:393-417).
    best_dx, best_dy, best_mag = dx[..., 0, :, :], dy[..., 0, :, :], mag[..., 0, :, :]
    for c in (1, 2):
        better = mag[..., c, :, :] > best_mag
        best_dx = torch.where(better, dx[..., c, :, :], best_dx)
        best_dy = torch.where(better, dy[..., c, :, :], best_dy)
        best_mag = torch.where(better, mag[..., c, :, :], best_mag)

    if phase == "exact":
        ang = exact_atan2_deg(best_dy, best_dx)
    elif phase == "cv":
        ang = fast_atan2_deg(best_dy, best_dx)
    else:
        raise ValueError(f"unknown phase {phase!r}")
    # Round half to even, like cv convertTo; [348.75, 360) wraps to bin 0.
    bins16 = torch.round(ang * _f32(16.0 / 360.0, rgb.device)).to(torch.int32) & 15
    interior = _interior(h, w, 1, 1, rgb.device)
    bins8 = torch.where(interior, bins16 & 7, 0)

    # 3x3 histogram vote over the 8 folded bins; the first maximum wins.
    top_votes = torch.zeros_like(bins8)
    top_bin = torch.zeros_like(bins8)
    for b in range(8):
        votes_b = _box3_votes((bins8 == b).to(torch.int32))
        top_bin = torch.where(votes_b > top_votes, b, top_bin)
        top_votes = torch.maximum(votes_b, top_votes)

    accept = (best_mag > weak_threshold * weak_threshold) & (top_votes >= 5) & interior
    one_hot = torch.bitwise_left_shift(torch.ones_like(top_bin), top_bin).to(torch.uint8)
    quantized = torch.where(accept, one_hot, torch.zeros_like(one_hot))
    return quantized, best_mag


def quantize_depth_normal(
    depth: torch.Tensor,
    distance_threshold: int = 2000,
    difference_threshold: int = 50,
    focal: float = 1150.0,
    lut_parity: bool = False,
) -> torch.Tensor:
    """Quantize depth-image surface normals to 8 azimuth bits (cpp:729-819).

    Args:
      depth: (..., H, W) depth in mm, any integer dtype (int32 in practice).
      distance_threshold / difference_threshold / focal: see the config.
      lut_parity: truncate the normal to NORMAL_LUT's 20-cell grid first,
        as the reference does (cpp:798-800).

    Returns:
      (..., H, W) uint8 one-hot normal byte after a 5x5 median filter.
    """
    h, w = depth.shape[-2], depth.shape[-1]
    dev = depth.device
    r = 5
    d = depth.to(torch.int32)
    p = torch.nn.functional.pad(d, (r, r, r, r))

    def sh(dy, dx):
        return p[..., r + dy : h + r + dy, r + dx : w + r + dx]

    offsets = [(-r, -r), (-r, 0), (-r, r), (0, -r), (0, r), (r, -r), (r, 0), (r, r)]
    zeros = torch.zeros(d.shape, dtype=torch.float32, device=dev)
    a00, a01, a11, b0, b1 = zeros, zeros, zeros, zeros, zeros
    # Every term below is a small integer, so these float32 sums are exact.
    for dy_, dx_ in offsets:
        delta = (sh(dy_, dx_) - d).to(torch.float32)
        f = (delta.abs() < difference_threshold).to(torch.float32)
        i, j = float(dx_), float(dy_)  # reference passes (i=dx, j=dy)
        a00 = a00 + f * i * i
        a01 = a01 + f * i * j
        a11 = a11 + f * j * j
        b0 = b0 + f * i * delta
        b1 = b1 + f * j * delta

    det = a00 * a11 - a01 * a01
    ddx = a11 * b0 - a01 * b1
    ddy = -a01 * b0 + a00 * b1

    nx = _f32(focal, dev) * ddx
    ny = _f32(focal, dev) * ddy
    nz = -det * d.to(torch.float32)
    norm = sqrt32(nx * nx + ny * ny + nz * nz)

    if lut_parity:
        nn = torch.clamp(norm, min=1e-12)
        v1 = torch.floor(nx / nn * _f32(10.0, dev) + _f32(10.0, dev)).clamp(0, 19)
        v2 = torch.floor(ny / nn * _f32(10.0, dev) + _f32(10.0, dev)).clamp(0, 19)
        nx = (v1 - _f32(10.0, dev)) / _f32(10.0, dev)
        ny = (v2 - _f32(10.0, dev)) / _f32(10.0, dev)

    # Azimuth bin: nearest of 8 sectors (reference NORMAL_LUT semantics).
    ang = torch.atan2(ny, nx)
    ang = torch.where(ang < 0, ang + _f32(2.0 * np.pi, dev), ang)
    bin8 = torch.round(ang * _f32(8.0 / (2.0 * np.pi), dev)).to(torch.int32) % 8
    byte = torch.bitwise_left_shift(torch.ones_like(bin8), bin8).to(torch.uint8)

    # Reference loops y in [r, H-r-1), x in [r, W-r-1)  (cpp:752, 758).
    valid = _interior(h, w, r, r + 1, dev) & (d < distance_threshold) & (norm > 0)
    quantized = torch.where(valid, byte, torch.zeros_like(byte))
    return median5x5_onehot_u8(quantized)


def _box5(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    rows5 = sum(x[..., dy : h + dy, :] for dy in range(5))
    return sum(rows5[..., dx : w + dx] for dx in range(5))


def median5x5_onehot_u8(img: torch.Tensor) -> torch.Tensor:
    """5x5 median (replicate border) of an image whose bytes are one-hot or
    zero: the smallest value v with count(pixels <= v) >= 13."""
    h, w = img.shape[-2], img.shape[-1]
    p = _pad2(img, 2, "edge")
    cum = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    cums = []
    for v in (0, 1, 2, 4, 8, 16, 32, 64):
        cum = cum + _box5((p == v).to(torch.int32), h, w)
        cums.append(cum)
    med = torch.full(img.shape, 128, dtype=torch.uint8, device=img.device)
    for v, c in zip((64, 32, 16, 8, 4, 2, 1, 0), reversed(cums)):
        med = torch.where(c >= 13, torch.full((), v, dtype=torch.uint8, device=img.device), med)
    return med


def median5x5_u8(img: torch.Tensor) -> torch.Tensor:
    """5x5 median filter on a uint8 image (cv::medianBlur(dst, dst, 5))."""
    h, w = img.shape[-2], img.shape[-1]
    p = _pad2(img, 2, "edge")
    stack = torch.stack(
        [p[..., 2 + dy : h + 2 + dy, 2 + dx : w + 2 + dx] for dy in range(-2, 3) for dx in range(-2, 3)],
        dim=0,
    )
    return torch.sort(stack, dim=0).values[12]


# ---------------------------------------------------------------------------
# Pyramid downsampling
# ---------------------------------------------------------------------------


def _pyr_down(img: torch.Tensor, dims, vmax: int) -> torch.Tensor:
    """cv::pyrDown along two axes: 5-tap Gaussian (reflect-101 border),
    2x decimation, round half to even.  The float32 sums are of small
    multiples of 1/256, so they are exact in any order."""
    dt = img.dtype
    r = 2
    hd, wd = dims
    h, w = img.shape[hd], img.shape[wd]
    p = _pad2(img.to(torch.float32), r, "reflect", dims=dims)
    hor = torch.zeros_like(p.narrow(wd, 0, w))
    for i, k in enumerate(_PYR5):
        hor = hor + k * p.narrow(wd, i, w)
    out = torch.zeros_like(hor.narrow(hd, 0, h))
    for i, k in enumerate(_PYR5):
        out = out + k * hor.narrow(hd, i, h)
    idx_h = torch.arange(0, h, 2, device=img.device)
    idx_w = torch.arange(0, w, 2, device=img.device)
    out = out.index_select(hd, idx_h).index_select(wd, idx_w)
    return torch.round(out).clamp(0, vmax).to(dt)


def pyr_down_rgb(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown of a uint8 (H, W) or (..., H, W, C) image."""
    dims = (0, 1) if img.dim() == 2 else (-3, -2)
    return _pyr_down(img, dims, 255 if img.dtype == torch.uint8 else 65535)


def pyr_down_depth(depth: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown of a (..., H, W) depth image holding uint16 values
    (the reference pyrDowns depth too, cpp:568-571)."""
    return _pyr_down(depth, (-2, -1), 65535)


def nn_down2(img: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x downsample of (..., H, W): the top-left pixel of
    each 2x2 block, as cv::resize INTER_NEAREST picks (cpp:861-864)."""
    return img[..., ::2, ::2]


def color_gradient_pyramid(rgb: torch.Tensor, levels: int, weak_threshold: float = 10.0):
    """(quantized, magnitude) of an RGB image at each pyramid level, level 0
    first (reference ColorGradientPyramid, cpp:557-584)."""
    out = []
    cur = rgb
    for l in range(levels):
        if l > 0:
            cur = pyr_down_rgb(cur)
        out.append(quantize_color_gradient(cur, weak_threshold))
    return out


def depth_normal_pyramid(
    depth: torch.Tensor,
    levels: int,
    distance_threshold: int = 2000,
    difference_threshold: int = 50,
    focal: float = 1150.0,
    lut_parity: bool = False,
):
    """Quantized normals at level 0, nearest-neighbour downsampled for the
    coarser levels (reference DepthNormalPyramid, cpp:857-864)."""
    cur = quantize_depth_normal(depth, distance_threshold, difference_threshold, focal, lut_parity)
    out = [cur]
    for _ in range(1, levels):
        cur = nn_down2(cur)
        out.append(cur)
    return out
