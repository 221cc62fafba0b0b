// The response pyramid of a batch of RGB-D frames: colour-gradient and
// depth-normal quantization, orientation spreading and the response maps of
// every pyramid level, a few launches a frame, written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package builds the pyramid as one XLA
// program (_build_response_pyramid, sixdpose_tpu/models/detector.py).  The
// port ran the same chain as eager PyTorch (ops/quantize.py, ops/spread.py):
// 1,370 small kernels a frame at two levels, 2.5 ms of device time, and
// about 18 us of host a launch, so the pyramid took more host time than
// any other stage of every benchmark cell.  These kernels are that chain
// with the launches taken out: all of them are enqueued by one call of
// response_pyramid_launch.
//
// Contract: the bytes of models/detector.py::_build_response_pyramid_plain.
//   - The 7x7 blur, Sobel, the channel choice, the 3x3 vote, pyrDown (its
//     float32 sums are exact multiples of 1/256), the 5x5 one-hot median
//     and the spread are integer arithmetic here.
//   - Every float32 operation of the orientation (fastAtan2) and of the
//     depth normal is repeated in the plain version's order and rounding:
//     __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, since nvcc would
//     contract a*b + c into an FMA; rintf for torch.round; atan2f, which is
//     what torch.atan2 runs on CUDA; the norm's sqrt in float64, rounded to
//     float32 (ops/sqrt.py::sqrt32).  The float constants are the float32
//     roundings that _f32 makes, as hex literals; the thresholds come in
//     already rounded to float32, as torch compares a float32 tensor with
//     a Python number.
//
// What bounds it on the H100.  At 720 x 540 a frame reads and writes about
// 10.5 MB, 3 us at 3.35 TB/s, and the stencils' integer work is a few
// hundred operations a pixel.  What matters is the launch count and the
// host's part in it, so the design is few launches and no temporary
// planes beyond each level's one-byte quantized images:
//
// 1. color_quantize: one block of 256 threads per 32 x 16 output tile.  It
//    stages the tile's RGB with a 5-pixel halo in shared memory (3 for the
//    blur, 1 for Sobel, 1 for the vote; replicate-border indices), blurs in
//    two integer passes, takes Sobel, the dominant channel and the bin at
//    the tile plus 1, then votes.  Blurred pixels outside the frame are the
//    border pixel's blur, so Sobel sees the plain version's replicated
//    border.
// 2. pyr_down: one thread per output pixel of level l + 1, its 5 x 5 taps
//    (reflect-101) read through L1.  Colour at level l + 1 quantizes its
//    output.  Depth at level l is level 0 read with stride 2^l
//    (nn_down2), so it needs no launch.
// 3. depth_normal: one block per 32 x 16 tile; the depth with a halo of
//    5 + 2 (zeros outside the frame, as the plain version pads), the normals'
//    bytes at the tile plus 2 (the median's replicated border: a normal
//    outside the frame is the border pixel's), then the 5x5 median of the
//    one-hot bytes by counts.
// 4. spread_response: one launch per level for both modalities.  A thread
//    takes 4 neighbouring pixels of a row: the t x t OR (anchored top left,
//    zeros past the bottom and right) from its t rows of t + 3 bytes, then
//    the LUT's 8 responses of each, packed into one 32-bit word per
//    orientation plane, so a warp writes 128 bytes of each plane.  It
//    writes straight into the level's (B, 8 * modalities, H_l, W_l) output
//    at the modality's channel offset.
//
// Nothing limits B, H, W or t here beyond int64 offsets: the tiles and the
// batch are flattened into grid.x and a grid.y of at most 65,535 frames.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;     // output columns a tile block
constexpr int kTileH = 16;     // output rows a tile block
constexpr int kThreads = 256;  // threads of every block
constexpr int kMaxGridY = 65535;

// _f32 of the plain version's constants (np.float32 of the double).
constexpr float kP1 = 0x1.ca44dcp+5f;      // 0.9997878412794807 * 180 / pi
constexpr float kP3 = -0x1.2aaddcp+4f;     // -0.3258083974640975 * 180 / pi
constexpr float kP5 = 0x1.1d3f7ep+3f;      // 0.1555786518463281 * 180 / pi
constexpr float kP7 = -0x1.4515b2p+1f;     // -0.04432655554792128 * 180 / pi
constexpr float kEps = 0x1p-52f;           // (float)DBL_EPSILON
constexpr float kDegToBin16 = 0x1.6c16c2p-5f;  // 16 / 360
constexpr float kTwoPi = 0x1.921fb6p+2f;       // 2 pi
constexpr float kRadToBin8 = 0x1.45f306p+0f;   // 8 / (2 pi)
constexpr float kNormMin = 0x1.197998p-40f;    // 1e-12

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// fastAtan2 of (y, x) in degrees, then torch.round(a * 16 / 360) & 15:
// each operation of ops/quantize.py::fast_atan2_deg in its order.
__device__ __forceinline__ int orientation_bin16(int iy, int ix) {
  const float x = (float)ix, y = (float)iy;
  const float ax = fabsf(x), ay = fabsf(y);
  const bool steep = ax >= ay;
  const float c = steep ? __fdiv_rn(ay, __fadd_rn(ax, kEps)) : __fdiv_rn(ax, __fadd_rn(ay, kEps));
  const float c2 = __fmul_rn(c, c);
  float poly = __fadd_rn(__fmul_rn(kP7, c2), kP5);
  poly = __fadd_rn(__fmul_rn(poly, c2), kP3);
  poly = __fadd_rn(__fmul_rn(poly, c2), kP1);
  poly = __fmul_rn(poly, c);
  float a = steep ? poly : __fsub_rn(90.0f, poly);
  if (x < 0.0f) a = __fsub_rn(180.0f, a);
  if (y < 0.0f) a = __fsub_rn(360.0f, a);
  return (int)rintf(__fmul_rn(a, kDegToBin16)) & 15;
}

// grid (tiles, frames).  rgb (B, h, w, 3) -> q (B, h, w) one-hot bytes.
__global__ void __launch_bounds__(kThreads) color_quantize_kernel(
    const uint8_t* __restrict__ rgb, uint8_t* __restrict__ q, int h, int w, int tiles_x, float weak2) {
  constexpr int SH = kTileH + 10, SW = kTileW + 10;  // source: halo 5
  constexpr int BH = kTileH + 4, BW = kTileW + 4;    // blurred: halo 2
  constexpr int GH = kTileH + 2, GW = kTileW + 2;    // bins: halo 1
  constexpr uint8_t kOutside = 0xFF;                 // a bin position outside the frame: no vote
  __shared__ uint8_t s_src[3][SH][SW];
  __shared__ int s_hor[3][SH][BW];
  __shared__ uint8_t s_blur[3][BH][BW];
  __shared__ uint8_t s_bin[GH][GW];
  __shared__ int s_mag[kTileH][kTileW];

  const int tid = threadIdx.x;
  const int ox = (blockIdx.x % tiles_x) * kTileW, oy = (blockIdx.x / tiles_x) * kTileH;
  const size_t plane = (size_t)h * w;
  const uint8_t* img = rgb + (size_t)blockIdx.y * plane * 3;

  for (int i = tid; i < SH * SW * 3; i += kThreads) {
    const int c = i % 3, p = i / 3, sx = p % SW, sy = p / SW;
    const int gy = clampi(oy - 5 + sy, 0, h - 1), gx = clampi(ox - 5 + sx, 0, w - 1);
    s_src[c][sy][sx] = img[((size_t)gy * w + gx) * 3 + c];
  }
  __syncthreads();
  // Horizontal pass of the 7-tap [8 28 56 72 56 28 8] at each blurred
  // column's centre, clamped into the frame.
  for (int i = tid; i < 3 * SH * BW; i += kThreads) {
    const int bx = i % BW, r = i / BW, sy = r % SH, c = r / SH;
    const uint8_t* row = s_src[c][sy] + (clampi(ox - 2 + bx, 0, w - 1) - (ox - 5));
    s_hor[c][sy][bx] = 8 * (row[-3] + row[3]) + 28 * (row[-2] + row[2]) + 56 * (row[-1] + row[1]) + 72 * row[0];
  }
  __syncthreads();
  for (int i = tid; i < 3 * BH * BW; i += kThreads) {
    const int bx = i % BW, r = i / BW, by = r % BH, c = r / BH;
    const int cy = clampi(oy - 2 + by, 0, h - 1) - (oy - 5);
    const int v = 8 * (s_hor[c][cy - 3][bx] + s_hor[c][cy + 3][bx]) + 28 * (s_hor[c][cy - 2][bx] + s_hor[c][cy + 2][bx]) +
                  56 * (s_hor[c][cy - 1][bx] + s_hor[c][cy + 1][bx]) + 72 * s_hor[c][cy][bx];
    s_blur[c][by][bx] = (uint8_t)min((v + (1 << 15)) >> 16, 255);
  }
  __syncthreads();
  // Sobel of each channel, the dominant one (ties keep the lower channel),
  // its folded bin; 0 off the interior, kOutside off the frame.
  for (int i = tid; i < GH * GW; i += kThreads) {
    const int px = i % GW, py = i / GW;
    const int gy = oy - 1 + py, gx = ox - 1 + px;
    uint8_t bin = kOutside;
    int best_m = 0;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      int best_dx = 0, best_dy = 0;
      for (int c = 0; c < 3; ++c) {
        const uint8_t(*B)[BW] = s_blur[c];
        const int y = py + 1, x = px + 1;
        const int dx = (B[y - 1][x + 1] + 2 * B[y][x + 1] + B[y + 1][x + 1]) -
                       (B[y - 1][x - 1] + 2 * B[y][x - 1] + B[y + 1][x - 1]);
        const int dy = (B[y + 1][x - 1] + 2 * B[y + 1][x] + B[y + 1][x + 1]) -
                       (B[y - 1][x - 1] + 2 * B[y - 1][x] + B[y - 1][x + 1]);
        const int m = dx * dx + dy * dy;
        if (c == 0 || m > best_m) {
          best_m = m;
          best_dx = dx;
          best_dy = dy;
        }
      }
      const bool interior = gy >= 1 && gy < h - 1 && gx >= 1 && gx < w - 1;
      bin = interior ? (uint8_t)(orientation_bin16(best_dy, best_dx) & 7) : 0;
    }
    s_bin[py][px] = bin;
    if (py >= 1 && py <= kTileH && px >= 1 && px <= kTileW) s_mag[py - 1][px - 1] = best_m;
  }
  __syncthreads();
  // 3x3 vote (zeros outside the frame): the first bin with the most votes.
  uint8_t* out = q + (size_t)blockIdx.y * plane;
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int tx = i % kTileW, ty = i / kTileW;
    const int y = oy + ty, x = ox + tx;
    if (y >= h || x >= w) continue;
    uint32_t counts = 0;  // 4 bits a bin
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const uint8_t b = s_bin[ty + dy][tx + dx];
        if (b != kOutside) counts += 1u << (4 * b);
      }
    }
    int top_votes = 0, top_bin = 0;
    for (int b = 0; b < 8; ++b) {
      const int v = (counts >> (4 * b)) & 15;
      if (v > top_votes) {
        top_votes = v;
        top_bin = b;
      }
    }
    const bool interior = y >= 1 && y < h - 1 && x >= 1 && x < w - 1;
    const bool accept = (float)s_mag[ty][tx] > weak2 && top_votes >= 5 && interior;
    out[(size_t)y * w + x] = accept ? (uint8_t)(1u << top_bin) : 0;
  }
}

// Reflect-101 index into [0, n) (OpenCV's default border).
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * (n - 1) - i;
  return i;
}

// grid (ceil(h2 * w2 / kThreads), frames).  cv::pyrDown of (B, h, w, 3)
// into (B, h2, w2, 3): sum of [1 4 6 4 1]^2 taps, rounded half to even.
__global__ void __launch_bounds__(kThreads) pyr_down_kernel(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int h, int w, int h2, int w2) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)h2 * w2) return;
  const int x = (int)(p % w2), y = (int)(p / w2);
  const uint8_t* img = src + (size_t)blockIdx.y * h * w * 3;
  const int k[5] = {1, 4, 6, 4, 1};
  int cols[5];
  for (int j = 0; j < 5; ++j) cols[j] = reflect101(2 * x + j - 2, w) * 3;
  int s0 = 0, s1 = 0, s2 = 0;
  for (int i = 0; i < 5; ++i) {
    const uint8_t* row = img + (size_t)reflect101(2 * y + i - 2, h) * w * 3;
    int r0 = 0, r1 = 0, r2 = 0;
    for (int j = 0; j < 5; ++j) {
      r0 += k[j] * row[cols[j]];
      r1 += k[j] * row[cols[j] + 1];
      r2 += k[j] * row[cols[j] + 2];
    }
    s0 += k[i] * r0;
    s1 += k[i] * r1;
    s2 += k[i] * r2;
  }
  uint8_t* o = dst + ((size_t)blockIdx.y * h2 * w2 + p) * 3;
  o[0] = (uint8_t)rintf((float)s0 * 0x1p-8f);
  o[1] = (uint8_t)rintf((float)s1 * 0x1p-8f);
  o[2] = (uint8_t)rintf((float)s2 * 0x1p-8f);
}

struct DepthArgs {
  long long distance_threshold;  // d < this (int)
  float difference_threshold;    // |delta| < this (float32)
  float focal;
  int lut_parity;
};

// The quantized normal byte at (cy, cx) of the frame, the depth tile's
// (ty, tx): each float32 operation of ops/quantize.py::quantize_depth_normal
// in its order.
__device__ uint8_t normal_byte(const int32_t (*D)[kTileW + 14], int ty, int tx, int cy, int cx, int h, int w,
                               const DepthArgs& a) {
  const int dys[8] = {-5, -5, -5, 0, 0, 5, 5, 5};
  const int dxs[8] = {-5, 0, 5, -5, 5, -5, 0, 5};
  const int d = D[ty][tx];
  float a00 = 0.0f, a01 = 0.0f, a11 = 0.0f, b0 = 0.0f, b1 = 0.0f;
  for (int k = 0; k < 8; ++k) {
    const float delta = (float)(int32_t)((uint32_t)D[ty + dys[k]][tx + dxs[k]] - (uint32_t)d);
    const float f = fabsf(delta) < a.difference_threshold ? 1.0f : 0.0f;
    const float i = (float)dxs[k], j = (float)dys[k];
    a00 = __fadd_rn(a00, __fmul_rn(__fmul_rn(f, i), i));
    a01 = __fadd_rn(a01, __fmul_rn(__fmul_rn(f, i), j));
    a11 = __fadd_rn(a11, __fmul_rn(__fmul_rn(f, j), j));
    b0 = __fadd_rn(b0, __fmul_rn(__fmul_rn(f, i), delta));
    b1 = __fadd_rn(b1, __fmul_rn(__fmul_rn(f, j), delta));
  }
  const float det = __fsub_rn(__fmul_rn(a00, a11), __fmul_rn(a01, a01));
  const float ddx = __fsub_rn(__fmul_rn(a11, b0), __fmul_rn(a01, b1));
  const float ddy = __fadd_rn(__fmul_rn(-a01, b0), __fmul_rn(a00, b1));
  float nx = __fmul_rn(a.focal, ddx);
  float ny = __fmul_rn(a.focal, ddy);
  const float nz = __fmul_rn(-det, (float)d);
  const float ss = __fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)), __fmul_rn(nz, nz));
  const float norm = __double2float_rn(__dsqrt_rn((double)ss));
  if (a.lut_parity) {
    const float nn = fmaxf(norm, kNormMin);
    const float v1 = fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(__fdiv_rn(nx, nn), 10.0f), 10.0f)), 0.0f), 19.0f);
    const float v2 = fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(__fdiv_rn(ny, nn), 10.0f), 10.0f)), 0.0f), 19.0f);
    nx = __fdiv_rn(__fsub_rn(v1, 10.0f), 10.0f);
    ny = __fdiv_rn(__fsub_rn(v2, 10.0f), 10.0f);
  }
  float ang = atan2f(ny, nx);
  if (ang < 0.0f) ang = __fadd_rn(ang, kTwoPi);
  const int bin = (int)rintf(__fmul_rn(ang, kRadToBin8)) & 7;
  const bool valid = cy >= 5 && cy < h - 6 && cx >= 5 && cx < w - 6 && (long long)d < a.distance_threshold &&
                     norm > 0.0f;
  return valid ? (uint8_t)(1u << bin) : 0;
}

// grid (tiles, frames).  depth (B, h, w) int32 -> q (B, h, w): the normals'
// one-hot bytes after the 5x5 median (replicate border).
__global__ void __launch_bounds__(kThreads) depth_normal_kernel(
    const int32_t* __restrict__ depth, uint8_t* __restrict__ q, int h, int w, int tiles_x, DepthArgs a) {
  constexpr int DH = kTileH + 14, DW = kTileW + 14;  // depth: halo 5 + 2
  constexpr int NH = kTileH + 4, NW = kTileW + 4;    // normals: halo 2
  __shared__ int32_t s_d[DH][DW];
  __shared__ uint8_t s_n[NH][NW];

  const int tid = threadIdx.x;
  const int ox = (blockIdx.x % tiles_x) * kTileW, oy = (blockIdx.x / tiles_x) * kTileH;
  const size_t plane = (size_t)h * w;
  const int32_t* dep = depth + (size_t)blockIdx.y * plane;
  for (int i = tid; i < DH * DW; i += kThreads) {
    const int sx = i % DW, sy = i / DW;
    const int gy = oy - 7 + sy, gx = ox - 7 + sx;
    s_d[sy][sx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? dep[(size_t)gy * w + gx] : 0;
  }
  __syncthreads();
  for (int i = tid; i < NH * NW; i += kThreads) {
    const int nx = i % NW, ny = i / NW;
    const int cy = clampi(oy - 2 + ny, 0, h - 1), cx = clampi(ox - 2 + nx, 0, w - 1);
    s_n[ny][nx] = normal_byte(s_d, cy - (oy - 7), cx - (ox - 7), cy, cx, h, w, a);
  }
  __syncthreads();
  // The median of one-hot bytes: the first value of 0, 1, 2, ..., 64 whose
  // count with the values before it reaches 13, else 128.
  uint8_t* out = q + (size_t)blockIdx.y * plane;
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int tx = i % kTileW, ty = i / kTileW;
    const int y = oy + ty, x = ox + tx;
    if (y >= h || x >= w) continue;
    unsigned long long counts = 0;  // 6 bits a value: 0, then 1 << (k - 1) at k
    for (int dy = 0; dy < 5; ++dy) {
      for (int dx = 0; dx < 5; ++dx) counts += 1ull << (6 * __ffs(s_n[ty + dy][tx + dx]));
    }
    uint8_t med = 128;
    int cum = 0;
    for (int k = 0; k < 8; ++k) {
      cum += (int)((counts >> (6 * k)) & 63);
      if (cum >= 13) {
        med = k == 0 ? 0 : (uint8_t)(1u << (k - 1));
        break;
      }
    }
    out[(size_t)y * w + x] = med;
  }
}

__device__ __forceinline__ uint32_t rotl8(uint32_t s, int k) { return ((s << k) | (s >> (8 - k))) & 0xFF; }

// The 8 responses of a spread byte, orientation o in byte o of the result
// (ops/spread.py::compute_response_maps).  lut: 0 levelup, 1 stock, 2
// binary45.
__device__ __forceinline__ unsigned long long responses(uint32_t s, int lut) {
  const uint32_t near = rotl8(s, 1) | rotl8(s, 7);
  unsigned long long out = 0;
  for (int o = 0; o < 8; ++o) {
    uint32_t r = 0;
    if (lut == 0) {
      r = (s >> o) & 1 ? 4 : ((near >> o) & 1 ? 1 : 0);
    } else if (lut == 1) {
      for (int d = 4; d >= 0; --d) {
        const uint32_t ring = d == 0 ? s : rotl8(s, d) | rotl8(s, 8 - d);
        if ((ring >> o) & 1) r = 4 - d;
      }
    } else {
      r = ((s | near) >> o) & 1 ? 4 : 0;
    }
    out |= (unsigned long long)r << (8 * o);
  }
  return out;
}

struct Plane {
  const uint8_t* q;   // quantized bytes of modality m, frame 0
  size_t frame;       // elements between frames
  long long row, col; // elements between rows and between columns at this level
};

// grid (ceil(W / 4 / 32) * ceil(H / 8), frames * modalities), block 32 x 8.
// Thread: 4 neighbouring pixels of one row of one modality.
__global__ void __launch_bounds__(kThreads) spread_response_kernel(
    Plane p0, Plane p1, uint8_t* __restrict__ out, int modalities, int channels, int H, int W, int tiles_x, int t,
    int lut) {
  const int m = blockIdx.y % modalities;
  const size_t b = blockIdx.y / modalities;
  const Plane& pl = m == 0 ? p0 : p1;
  const int x0 = ((blockIdx.x % tiles_x) * 32 + threadIdx.x) * 4;
  const int y = (blockIdx.x / tiles_x) * 8 + threadIdx.y;
  if (x0 >= W || y >= H) return;
  uint32_t s[4] = {0, 0, 0, 0};
  const uint8_t* base = pl.q + b * pl.frame;
  for (int r = 0; r < t && y + r < H; ++r) {
    const uint8_t* row = base + (y + r) * pl.row;
    for (int c = 0; c < t + 3 && x0 + c < W; ++c) {
      const uint32_t v = row[(x0 + c) * pl.col];
      for (int k = 0; k < 4; ++k) {
        if (c >= k && c - k < t) s[k] |= v;
      }
    }
  }
  uint32_t words[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int k = 0; k < 4; ++k) {
    const unsigned long long r = responses(s[k], lut);
    for (int o = 0; o < 8; ++o) words[o] |= (uint32_t)((r >> (8 * o)) & 0xFF) << (8 * k);
  }
  const size_t hw = (size_t)H * W;
  uint8_t* dst = out + (b * channels + 8 * m) * hw + (size_t)y * W + x0;
  if ((W & 3) == 0) {
    for (int o = 0; o < 8; ++o) *reinterpret_cast<uint32_t*>(dst + o * hw) = words[o];
  } else {
    for (int o = 0; o < 8; ++o) {
      for (int k = 0; k < 4 && x0 + k < W; ++k) dst[o * hw + k] = (uint8_t)(words[o] >> (8 * k));
    }
  }
}

}  // namespace

// ---- launcher -------------------------------------------------------------

// Enqueue the pyramid of B frames on `stream`.
//   rgb (B, H, W, 3) uint8, null without colour; depth (B, H, W) int32, null
//   without depth; out[l] (B, 8 * modalities, H_l, W_l) uint8, colour maps
//   first; H_0 = H, H_l = ceil(H_{l-1} / 2), the same for W; t[l] >= 1.
//   work (ops/response_pyramid.py::workspace_bytes): with depth, the
//   quantized bytes of level 0 (B * H * W); then, with colour, for each
//   level l its RGB if l > 0 (3 * B * H_l * W_l) and its quantized bytes
//   (B * H_l * W_l).
//   lut: 0 levelup, 1 stock, 2 binary45.  weak2 and difference_threshold
//   are the float32 roundings of weak_threshold ** 2 and the threshold.
// Returns cudaGetLastError() as an int (0 = success).
extern "C" int response_pyramid_launch(const void* rgb, const void* depth, void* work, void* const* out,
                                       const int* t, int levels, int B, int H, int W, int use_color, int use_depth,
                                       int lut, int lut_parity, float weak2, long long distance_threshold,
                                       float difference_threshold, float focal, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || levels <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int modalities = (use_color ? 1 : 0) + (use_depth ? 1 : 0);
  const int channels = 8 * modalities;
  const DepthArgs da{distance_threshold, difference_threshold, focal, lut_parity};
  uint8_t* ws = (uint8_t*)work;
  uint8_t* qd = nullptr;
  if (use_depth) {
    qd = ws;
    ws += (size_t)B * H * W;
  }
  const uint8_t* rgb_prev = nullptr;
  int h = H, w = W, hp = 0, wp = 0;
  for (int l = 0; l < levels; ++l) {
    if (l > 0) {
      hp = h;
      wp = w;
      h = (h + 1) / 2;
      w = (w + 1) / 2;
    }
    const int tiles_x = (w + kTileW - 1) / kTileW;
    const unsigned tiles = (unsigned)tiles_x * ((h + kTileH - 1) / kTileH);
    uint8_t* qc = nullptr;
    if (use_color) {
      const uint8_t* rgb_l = (const uint8_t*)rgb;
      if (l > 0) {
        uint8_t* down = ws;
        ws += (size_t)3 * B * h * w;
        for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
          const dim3 grid((unsigned)(((long long)h * w + kThreads - 1) / kThreads), min(B - b0, kMaxGridY));
          pyr_down_kernel<<<grid, kThreads, 0, st>>>(rgb_prev + (size_t)b0 * hp * wp * 3,
                                                     down + (size_t)b0 * h * w * 3, hp, wp, h, w);
        }
        rgb_l = down;
      }
      qc = ws;
      ws += (size_t)B * h * w;
      for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
        color_quantize_kernel<<<dim3(tiles, min(B - b0, kMaxGridY)), kThreads, 0, st>>>(
            rgb_l + (size_t)b0 * h * w * 3, qc + (size_t)b0 * h * w, h, w, tiles_x, weak2);
      }
      rgb_prev = rgb_l;
    }
    if (use_depth && l == 0) {
      for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
        depth_normal_kernel<<<dim3(tiles, min(B - b0, kMaxGridY)), kThreads, 0, st>>>(
            (const int32_t*)depth + (size_t)b0 * H * W, qd + (size_t)b0 * H * W, H, W, tiles_x, da);
      }
    }
    // Depth at level l is level 0 at every 2^l-th row and column (nn_down2);
    // from level 31 on a level has one pixel, level 0's first.
    const int sh = l < 31 ? l : 31;
    const Plane pc{qc, (size_t)h * w, w, 1};
    const Plane pd{qd, (size_t)H * W, (long long)W << sh, 1ll << sh};
    const int sr_tiles_x = (w + 127) / 128;
    const unsigned sr_tiles = (unsigned)sr_tiles_x * ((h + 7) / 8);
    const int per_launch = kMaxGridY / modalities;
    for (int b0 = 0; b0 < B; b0 += per_launch) {
      Plane q0 = use_color ? pc : pd, q1 = pd;
      q0.q += (size_t)b0 * q0.frame;
      if (q1.q) q1.q += (size_t)b0 * q1.frame;
      spread_response_kernel<<<dim3(sr_tiles, min(B - b0, per_launch) * modalities), dim3(32, 8), 0, st>>>(
          q0, q1, (uint8_t*)out[l] + (size_t)b0 * channels * h * w, modalities, channels, h, w, sr_tiles_x, t[l],
          lut);
    }
  }
  return (int)cudaGetLastError();
}
