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
// Layout: the kernel reads the raw (C, H, W) response maps with the s2d
// index arithmetic (window cell (i, j) of the feature is pixel
// ((by + i)*t + y%t, (bx + j)*t + x%t) of channel c) instead of an s2d copy,
// which would cost a 4.9 MB write and read per level and frame.
//
// What bounds it on the H100.  At the main path's call (maps (16, 480, 640)
// uint8 at t=5, K=128 candidates x F=254 features) the byte bound is about
// 1 us: 2.6 MB of touched map bytes, which sit in the 50 MB L2, plus the
// feature tables.  The work is a gather: every (feature, window row) is 16
// bytes at stride t, so a warp's load touches 3-4 32-byte L2 sectors per
// row, about 55 MB of sector traffic for that call.  The kernel is therefore
// bound by L2 sector throughput once enough loads are in flight, never by
// its int32 adds; with one bounds-tested load in flight per thread it would
// wait one L2 round trip per feature instead.  The design does three things:
//
// 1. Unconditional loads, many in flight.  Staging a feature stores, beside
//    its base address, which of the window's rows and columns fall inside
//    the map (two 16-bit masks).  In the window loop a thread tests its own
//    (row, column) bits and loads from its cell when they hold and from the
//    feature's base (always in the frame) otherwise, then adds under a
//    select.  No load sits behind a branch, so a step of kUnroll features
//    issues kUnroll independent loads before the first add.
// 2. More warps per candidate.  A block is S groups of 256 threads (one per
//    window cell); group g sums features g, g+S, g+2S, ... of the candidate,
//    and the S partial int32 sums are reduced through shared memory.  The
//    wrapper chooses S in {1, 2, 4} from B*K so that the card holds about
//    32 warps per SM (S=4 at B=1, K=128).  Integer sums are exact in any
//    order, so the result is bit-equal to the plain version.
// 3. The table is staged once.  In-range features are compacted (warp
//    ballots, one shared atomic per warp) into a table in dynamic shared
//    memory of up to kTableCap entries (64 KB: the levelup maximum of 8191
//    features in one pass); features past that are taken in further passes.
//    The table tail is padded with inert entries to a multiple of S*kUnroll
//    so the window loop has no bounds test.  Features that are out of range,
//    padded, of a channel past the maps, or whose window lies wholly past
//    the map are counted (as the contract says) but never reach the loop;
//    blocks of inactive candidates only count.
//
// It stays several times its byte bound: the stride-t gather moves whole
// sectors for 16 useful bytes per row, and a call this short is comparable
// to the launch's own latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCells = 256;       // threads per group: one per cell of the 16x16 window
constexpr int kUnroll = 8;        // features (independent loads) per thread per step
constexpr int kTableCap = 8192;   // features staged per pass
constexpr int kMaxGroups = 4;
constexpr int kPad = kMaxGroups * kUnroll;  // table tail padding, >= S*kUnroll - 1

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (q * b > a) ? q - 1 : q;
}

__device__ __forceinline__ unsigned low_bits(int n) {  // n in 0..16
  return (1u << n) - 1u;
}

// One block per (candidate k, frame b): S groups of 256 threads.
// Table entry: x = channel plane + row0 * W + col0 (the window's corner
// pixel, inside the frame), y = in-map rows (bits 0..15) | columns (16..31).
template <int S>
__global__ void __launch_bounds__(kCells * S, 4 / S) local_refine_kernel(
    const uint8_t* __restrict__ maps,    // (B, C, H, W)
    const int32_t* __restrict__ feats,   // (B, K, F, 3) x, y, channel
    const bool* __restrict__ valid,      // (B, K, F)
    const int32_t* __restrict__ origins, // (B, K, 2) y, x
    const float* __restrict__ scale,     // (B, K) or null
    const bool* __restrict__ active,     // (B, K) or null
    float* __restrict__ scores,          // (B, K, window, window)
    int32_t* __restrict__ counts,        // (B, K)
    int C, int H, int W, int K, int F, int t, int window) {
  extern __shared__ int2 s_tab[];        // kTableCap + kPad entries at most
  __shared__ int s_part[S > 1 ? S - 1 : 1][kCells];
  __shared__ int s_n;
  __shared__ int s_total;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid / kCells;
  const int cell = tid % kCells;
  const int i = cell / 16;
  const int j = cell % 16;
  const unsigned tbit = (1u << i) | (1u << (16 + j));
  // Offset of cell (i, j) from the window's corner; used only where both
  // bits hold, and then it stays inside the frame.
  const unsigned off = (unsigned)(i * t) * (unsigned)W + (unsigned)(j * t);

  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const long long cand = (long long)b * K + k;
  const bool live = active == nullptr || active[cand];
  const int hb = (H + t - 1) / t;
  const int wb = (W + t - 1) / t;
  const int oy = floor_div(origins[2 * cand], t);
  const int ox = floor_div(origins[2 * cand + 1], t);
  const float sc = scale != nullptr ? scale[cand] : 1.0f;
  const uint8_t* frame = maps + (long long)b * C * H * W;
  const int32_t* fk = feats + cand * F * 3;
  const bool* vk = valid + cand * F;

  if (tid == 0) s_total = 0;
  int acc = 0;
  for (int f0 = 0; f0 < F; f0 += kTableCap) {
    const int fend = min(F, f0 + kTableCap);
    if (tid == 0) s_n = 0;
    __syncthreads();
    for (int fb = f0; fb < fend; fb += kCells * S) {  // same trip count in every thread
      const int f = fb + tid;
      bool ok = false;
      bool keep = false;
      int2 entry = make_int2(0, 0);
      if (f < fend) {
        int x = fk[3 * f];
        int y = fk[3 * f + 1];
        const int c = fk[3 * f + 2];
        if (scale != nullptr) {  // one f32 multiply, round half to even
          x = (int)rintf(__fmul_rn((float)x, sc));
          y = (int)rintf(__fmul_rn((float)y, sc));
        }
        ok = vk[f] && x >= 0 && y >= 0;
        int by = oy + y / t;  // x, y >= 0 wherever ok, so / is floor
        int bx = ox + x / t;
        ok = ok && by < hb && bx < wb;
        if (ok && live && c >= 0 && c < C) {  // a channel past the maps reads zeros
          by = max(by, 0);  // the JAX clip to [0, hb-1]; by < hb already
          bx = max(bx, 0);
          const int r0 = by * t + y % t;
          const int c0 = bx * t + x % t;
          const int nr = min(window, (H - r0 + t - 1) / t);  // <= 0 when r0 >= H
          const int nc = min(window, (W - c0 + t - 1) / t);
          if (nr > 0 && nc > 0) {
            keep = true;
            entry = make_int2(c * H * W + r0 * W + c0, (int)(low_bits(nr) | (low_bits(nc) << 16)));
          }
        }
      }
      const unsigned ok_mask = __ballot_sync(0xffffffffu, ok);
      const unsigned keep_mask = __ballot_sync(0xffffffffu, keep);
      int slot = 0;
      if (lane == 0) {
        if (ok_mask) atomicAdd(&s_total, __popc(ok_mask));
        if (keep_mask) slot = atomicAdd(&s_n, __popc(keep_mask));
      }
      slot = __shfl_sync(0xffffffffu, slot, 0);
      if (keep) s_tab[slot + __popc(keep_mask & ((1u << lane) - 1u))] = entry;
    }
    __syncthreads();
    const int n = s_n;
    const int npad = (n + S * kUnroll - 1) / (S * kUnroll) * (S * kUnroll);
    if (tid < npad - n) s_tab[n + tid] = make_int2(0, 0);  // inert: no bit set, loads frame[0]
    __syncthreads();

    for (int e = g; e < npad; e += S * kUnroll) {
      int v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int2 en = s_tab[e + u * S];
        const bool in = ((unsigned)en.y & tbit) == tbit;
        v[u] = __ldg(frame + ((unsigned)en.x + (in ? off : 0u)));
        v[u] = in ? v[u] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += v[u];
    }
    if (fend < F) __syncthreads();  // the next pass rewrites the table
  }

  if (S > 1) {
    if (g > 0) s_part[g - 1][cell] = acc;
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int q = 0; q < S - 1; ++q) acc += s_part[q][cell];
    }
  }
  if (g == 0 && i < window && j < window) {
    scores[cand * window * window + i * window + j] = (float)acc;
  }
  if (tid == 0) counts[cand] = s_total;
}

template <int S>
int launch(const void* maps, const void* feats, const void* valid, const void* origins,
           const void* scale, const void* active, void* scores, void* counts,
           int B, int C, int H, int W, int K, int F, int t, int window, cudaStream_t stream) {
  const size_t smem = (size_t)(min(F, kTableCap) + kPad) * sizeof(int2);
  if (smem > 48 * 1024) {  // above 48 KB only after raising the function's limit
    const cudaError_t err = cudaFuncSetAttribute(
        local_refine_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  local_refine_kernel<S><<<dim3(K, B), kCells * S, smem, stream>>>(
      (const uint8_t*)maps, (const int32_t*)feats, (const bool*)valid,
      (const int32_t*)origins, (const float*)scale, (const bool*)active,
      (float*)scores, (int32_t*)counts, C, H, W, K, F, t, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` with `groups` (1, 2 or 4) groups of 256 threads per
// candidate; returns cudaGetLastError() as an int (0 = success).
extern "C" int local_refine_launch(
    const void* maps, const void* feats, const void* valid, const void* origins,
    const void* scale, const void* active, void* scores, void* counts,
    int B, int C, int H, int W, int K, int F, int t, int window, int groups, void* stream) {
  if (B == 0 || K == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (groups) {
    case 1: return launch<1>(maps, feats, valid, origins, scale, active, scores, counts, B, C, H, W, K, F, t, window, s);
    case 2: return launch<2>(maps, feats, valid, origins, scale, active, scores, counts, B, C, H, W, K, F, t, window, s);
    case 4: return launch<4>(maps, feats, valid, origins, scale, active, scores, counts, B, C, H, W, K, F, t, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
