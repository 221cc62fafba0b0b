// Coarse scorer kernel: feature-sparse gather-sums of every (scale,
// template) row at every stride-t placement of the coarsest pyramid level,
// written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package scores the coarse level as XLA
// matmuls over a dense float32 weight tensor W[bucket, row, channel]
// (its shift-bucketed matmul route, sixdpose_tpu/ops/similarity.py), the right
// design for a TPU, whose matrix unit is fast and whose gathers are slow.
// The port ran the same design as one cuBLAS addmm per shift bucket and row
// chunk; on the H100 that was 95-99.5% of every benchmark cell's device
// time and most of its launches, although only the row's features of W are
// non-zero (62 of 230,400 entries a row at the T-LESS coarse shape).  This
// kernel sums just those entries.
//
// Contract (that of its plain version, similarity_multiscale_sparse in
// ops/similarity.py): feature f = (x, y, c) of
// template n at scale s sits at (xs, ys) = (rint(x * s), rint(y * s)) (one
// float32 multiply, rounded half to even) and counts only if valid, inside
// the (kh, kw) extent and s > 0.  It reads the space-to-depth maps
// (B, ct2 = C*t*t, hb, wb) at one packed offset
//     off = c' * hb * wb + (ys / t) * wb + xs / t,
//     c'  = clamp(c * t * t + (ys % t) * t + xs % t, 0, ct2 - 1),
// so that raw[b, s*N + n, y, x] = sum over counted features of
// maps[b][off + y * wb + x], and nfeat[s*N + n] is the count.
//
// What bounds it on the H100.  At the T-LESS coarse call (38,880 rows of at
// most 62 features, 1,024 s2d channels, 620 placements) the bytes-once bound
// is about 0.04 ms (96 MB of output), but the work is 1.5 G byte lookups:
// a gather.  The maps (1.6 MB a frame) sit in the 50 MB L2, and in the s2d
// layout neighbouring placements along x are neighbouring bytes, so a
// warp's 32 lookups of one feature fall in two or three 32-byte sectors.
// The kernel is bound by how fast the SMs issue those loads and L2 returns
// their sectors; its int32 adds are free beside them.  The design:
//
// 1. A block is 128 threads, one placement each, and takes kRows template
//    rows, so each thread keeps kRows int32 sums in registers.  The sums are
//    exact (responses 0..4, at most 4 * 8191 a sum) and the output is
//    written once, as float32.
// 2. The block stages its rows' packed offsets in shared memory first,
//    computed from the feature lists in the block's prologue (the same
//    float32 arithmetic as the plain version: __fmul_rn, no FMA
//    contraction, and rintf), compacted per row with one shared atomic a
//    kept feature; unused slots hold -1.  Features are staged kChunk at a
//    time, so any F (levelup's 8191 included) fits.
// 3. The loop over features reads a step's kRows offsets as two 16-byte
//    shared loads (the same address in every lane: a broadcast) and issues
//    kUnroll * kRows independent map loads before the first add.  A slot
//    of -1 loads nothing, so rows of scale 0 (no proposal) write zeros
//    without reading the maps, and a block whose rows all lack features
//    skips the loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;        // template rows a block (int32 sums a thread)
constexpr int kThreads = 128;   // placements a block, one a thread
constexpr int kChunk = 1024;    // features staged a pass (32 KB of offsets)
constexpr int kUnroll = 4;      // feature steps a loop iteration

// grid (ceil(SN / kRows), ceil(P / kThreads), max(B, 1)).  Table entry e of row r is
// tab[e * kRows + r]: rows 0-3 and 4-7 of an entry are one int4 each.
__global__ void __launch_bounds__(kThreads) coarse_score_kernel(
    const uint8_t* __restrict__ maps,    // (B, ct2, hb, wb) space-to-depth
    const int32_t* __restrict__ feats,   // (N, F, 3) x, y, channel
    const bool* __restrict__ valid,      // (N, F)
    const float* __restrict__ scales,    // (S,)
    float* __restrict__ raw,             // (B, S*N, ho, wo)
    int32_t* __restrict__ nfeat,         // (S*N,)
    int B, int N, int F, int SN, int ct2, int hb, int wb, int ho, int wo, int t, int kh, int kw) {
  extern __shared__ int4 s_tab[];
  __shared__ int s_cnt[kRows];
  __shared__ int s_total[kRows];
  int* tab = reinterpret_cast<int*>(s_tab);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int P = ho * wo;
  const int p = blockIdx.y * kThreads + tid;
  const bool live = p < P && (int)blockIdx.z < B;  // grid.z is 1 when B is 0
  const int base = live ? (p / wo) * wb + p % wo : 0;
  const int plane = hb * wb;
  const uint8_t* frame = maps + (size_t)blockIdx.z * ct2 * plane;

  if (tid < kRows) s_total[tid] = 0;
  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;

  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int fn = min(kChunk, F - f0);
    if (tid < kRows) s_cnt[tid] = 0;
    __syncthreads();
    for (int i = tid; i < kRows * fn; i += kThreads) {
      const int r = i / fn;
      const int row = row0 + r;
      if (row < SN) {
        const size_t nf = (size_t)(row % N) * F + f0 + (i - r * fn);
        const float sc = scales[row / N];
        const int xs = (int)rintf(__fmul_rn((float)feats[3 * nf], sc));
        const int ys = (int)rintf(__fmul_rn((float)feats[3 * nf + 1], sc));
        if (valid[nf] && sc > 0.0f && xs >= 0 && xs < kw && ys >= 0 && ys < kh) {
          const int cp = min(max(feats[3 * nf + 2] * (t * t) + (ys % t) * t + xs % t, 0), ct2 - 1);
          tab[atomicAdd(&s_cnt[r], 1) * kRows + r] = cp * plane + (ys / t) * wb + xs / t;
        }
      }
    }
    __syncthreads();
    int n_max = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) n_max = max(n_max, s_cnt[r]);
    const int n_pad = (n_max + kUnroll - 1) / kUnroll * kUnroll;
    for (int i = tid; i < kRows * n_pad; i += kThreads) {
      if (i / kRows >= s_cnt[i % kRows]) tab[i] = -1;
    }
    if (tid < kRows) s_total[tid] += s_cnt[tid];
    __syncthreads();

    if (live) {
      for (int e = 0; e < n_pad; e += kUnroll) {
        int v[kUnroll][kRows];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int4 lo = s_tab[2 * (e + u)];
          const int4 hi = s_tab[2 * (e + u) + 1];
          const int off[kRows] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[u][r] = off[r] >= 0 ? (int)__ldg(frame + off[r] + base) : 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] += v[u][r];
        }
      }
    }
    __syncthreads();  // the next pass rewrites the table and the counts
  }

  if (live) {
    float* out = raw + ((size_t)blockIdx.z * SN + row0) * P + p;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r < SN) out[(size_t)r * P] = (float)acc[r];
    }
  }
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid < kRows && row0 + tid < SN) nfeat[row0 + tid] = s_total[tid];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = success).
// B or ho * wo may be 0: the counts are still written.
extern "C" int coarse_score_launch(
    const void* maps, const void* feats, const void* valid, const void* scales, void* raw, void* nfeat,
    int B, int N, int F, int S, int ct2, int hb, int wb, int ho, int wo, int t, int kh, int kw, void* stream) {
  const long long sn = (long long)S * N;
  if (sn == 0) return 0;
  const int tiles = max(1, (ho * wo + kThreads - 1) / kThreads);
  const int slots = (min(max(F, 1), kChunk) + kUnroll - 1) / kUnroll * kUnroll;
  const dim3 grid((unsigned)((sn + kRows - 1) / kRows), (unsigned)tiles, (unsigned)max(B, 1));
  coarse_score_kernel<<<grid, kThreads, (size_t)slots * kRows * sizeof(int), (cudaStream_t)stream>>>(
      (const uint8_t*)maps, (const int32_t*)feats, (const bool*)valid, (const float*)scales, (float*)raw,
      (int32_t*)nfeat, B, N, F, (int)sn, ct2, hb, wb, ho, wo, t, kh, kw);
  return (int)cudaGetLastError();
}
