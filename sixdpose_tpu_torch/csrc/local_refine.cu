// Local-refine kernel: feature-sparse window scores for the pyramid
// refinement of the template matcher, written for Hopper (sm_90a).
//
// Replaces the five Pallas TPU kernels of the JAX package, which share one
// contract (that of similarity_local_sparse, sixdpose_tpu/ops/similarity.py:603):
//   v1 similarity_local_sparse_pallas     sixdpose_tpu/ops/pallas/local_refine.py:772 (_refine_kernel :51)
//   v2 similarity_local_sparse_pallas_v2  :162 (_refine_kernel_v2 :108)
//   v3 similarity_local_sparse_pallas_v3  :308 (_refine_kernel_v3 :251)
//   v4 similarity_local_sparse_pallas_v4  :472 (_refine_kernel_v4 :400)
//   v5 similarity_local_sparse_pallas_v5  :646 (_refine_kernel_v5 :578)
// The variants differ only in TPU workarounds (DMA row alignment, SMEM
// table budget, MXU selection contractions); this one kernel takes any K,
// any F, any map size and window <= 16, and a leading batch of frames.
//
// Contract, per frame b and candidate k: for every in-range valid feature
// (x, y, c) (scaled by scale[k] and rounded half to even when given), add
// the (window x window) block of space-to-depth channel c*t*t + (y%t)*t +
// (x%t) starting at s2d block (oy/t + y/t, ox/t + x/t), zeros past the map.
// scores (B, K, window, window) f32; counts (B, K) i32 of in-range valid
// features; inactive candidates score zeros and keep their counts.
//
// Layout choice: the kernel reads the raw (C, H, W) response maps with the
// s2d index arithmetic (window cell (i, j) of the feature is pixel
// ((by + i)*t + y%t, (bx + j)*t + x%t) of channel c) instead of an s2d copy.
// That saves the permute pass and its 4.9 MB write and read per level and
// frame, and a pixel past H or W is exactly an s2d zero pad, so the zero
// fill is one bounds test per read that never wraps into the next row or
// channel.
//
// What bounds it on the H100: memory, and in practice launch latency.  At
// the main path's shapes (maps (16, 480, 640) uint8 at t=5, K=128
// candidates x F=254 features) it reads at most the 4.9 MB of maps, which
// sit in the 50 MB L2, plus 390 KB of feature tables, and writes 131 KB:
// about 1.6 us at 3.35 TB/s.  The arithmetic is K*F*256 = 8.3 M integer
// adds, which is negligible.  So the design keeps it simple and spends no
// bytes twice: one block per (candidate, frame) with one thread per output
// cell (256), feature tables staged through shared memory in chunks of 256
// (F may reach 8191), out-of-range and padded features compacted away
// before the window loop (the loop runs over valid features only), and
// int32 accumulation written once as float32.  Blocks of inactive
// candidates only count their features.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one thread per cell of the 16x16 window
constexpr int kChunk = 256;    // features staged in shared memory per pass

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (q * b > a) ? q - 1 : q;
}

__global__ void __launch_bounds__(kThreads) local_refine_kernel(
    const uint8_t* __restrict__ maps,    // (B, C, H, W)
    const int32_t* __restrict__ feats,   // (B, K, F, 3) x, y, channel
    const bool* __restrict__ valid,      // (B, K, F)
    const int32_t* __restrict__ origins, // (B, K, 2) y, x
    const float* __restrict__ scale,     // (B, K) or null
    const bool* __restrict__ active,     // (B, K) or null
    float* __restrict__ scores,          // (B, K, window, window)
    int32_t* __restrict__ counts,        // (B, K)
    int C, int H, int W, int K, int F, int t, int window) {
  __shared__ int s_base[kChunk];  // channel plane + row0 * W + col0
  __shared__ int s_row0[kChunk];
  __shared__ int s_col0[kChunk];
  __shared__ int s_n;

  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const long long cand = (long long)b * K + k;
  const int i = threadIdx.x / 16;
  const int j = threadIdx.x % 16;
  const bool live = active == nullptr || active[cand];
  const int hb = (H + t - 1) / t;
  const int wb = (W + t - 1) / t;
  const int oy = floor_div(origins[2 * cand], t);
  const int ox = floor_div(origins[2 * cand + 1], t);
  const float sc = scale != nullptr ? scale[cand] : 1.0f;
  const uint8_t* frame = maps + (long long)b * C * H * W;
  const int32_t* fk = feats + cand * F * 3;
  const bool* vk = valid + cand * F;

  int acc = 0;
  int total = 0;
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    const int f = f0 + threadIdx.x;
    if (f < F) {
      int x = fk[3 * f];
      int y = fk[3 * f + 1];
      const int c = fk[3 * f + 2];
      if (scale != nullptr) {  // one f32 multiply, round half to even
        x = (int)rintf(__fmul_rn((float)x, sc));
        y = (int)rintf(__fmul_rn((float)y, sc));
      }
      bool ok = vk[f] && x >= 0 && y >= 0;
      int by = oy + y / t;  // x, y >= 0 wherever ok, so / is floor
      int bx = ox + x / t;
      ok = ok && by < hb && bx < wb;
      if (ok) {
        const int slot = atomicAdd(&s_n, 1);
        if (c >= 0 && c < C) {
          by = max(by, 0);  // the JAX clip to [0, hb-1]; by < hb already
          bx = max(bx, 0);
          const int r0 = by * t + y % t;
          const int c0 = bx * t + x % t;
          s_row0[slot] = r0;
          s_col0[slot] = c0;
          s_base[slot] = c * H * W + r0 * W + c0;
        } else {  // a channel past the maps reads the zero channel
          s_row0[slot] = H;
          s_col0[slot] = W;
          s_base[slot] = 0;
        }
      }
    }
    __syncthreads();
    const int n = s_n;
    total += n;
    if (live && i < window && j < window) {
      const int di = i * t;
      const int dj = j * t;
      const int off = di * W + dj;
#pragma unroll 8
      for (int e = 0; e < n; ++e) {
        if (s_row0[e] + di < H && s_col0[e] + dj < W) {
          acc += __ldg(frame + s_base[e] + off);
        }
      }
    }
    __syncthreads();
  }
  if (i < window && j < window) {
    scores[cand * window * window + i * window + j] = (float)acc;
  }
  if (threadIdx.x == 0) counts[cand] = total;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = success).
extern "C" int local_refine_launch(
    const void* maps, const void* feats, const void* valid, const void* origins,
    const void* scale, const void* active, void* scores, void* counts,
    int B, int C, int H, int W, int K, int F, int t, int window, void* stream) {
  if (B == 0 || K == 0) return 0;
  dim3 grid(K, B);
  local_refine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)maps, (const int32_t*)feats, (const bool*)valid,
      (const int32_t*)origins, (const float*)scale, (const bool*)active,
      (float*)scores, (int32_t*)counts, C, H, W, K, F, t, window);
  return (int)cudaGetLastError();
}
