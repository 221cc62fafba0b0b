// Ordered per-segment float32 sums, on sm_90a.
//
// Replaces XLA's CPU `segment_sum` in the JAX package's ALIC update
// (sixdpose_tpu/seg/dasp.py:307,310 and seg/slic.py:149,152); it has no TPU
// kernel.  out[s, c] = vals[i0, c] + vals[i1, c] + ... over the rows i of
// segment s in ascending order, added one at a time in float32 from +0.0:
// the order XLA's scatter-add takes on the CPU, so the sums equal the JAX
// package's bits.  Atomics (`index_add_`) would add in no fixed order.
//
// What bounds it: the longest segment's chain of dependent float32 adds
// (2,704 rows in the VGA bin-picking frame, about 5.5 us at 4 cycles a
// dependent add and 1.98 GHz), above the bytes (N x C x 4 plus the ids,
// read once: 5 us at HBM's rate).  So the design keeps everything else off
// that chain:
//
// 1. The layout, a stable counting sort of the rows by id, in three
//    launches on int32 positions.  A warp ranks 1,024 ids; a tile is up to
//    eight such warps, one block.
//    a. `tile_count`: each warp counts its ids into its own row of shared
//       counters (`__match_any_sync` groups the lanes with one id; the
//       group's lowest lane adds its size), and the block writes the
//       tile's count of every segment: counts[t][s].
//    b. `scan`: one block turns counts into each (segment, tile)'s first
//       position in segment-major order, an exclusive scan with the tiles
//       of one segment in order, and writes each segment's start.
//    c. `scatter`: each warp counts again, a prefix over the tile's warps
//       gives each warp its first position per segment, and a lane's row
//       goes to that base plus its rank among the earlier lanes with its id
//       (`__popc` of the group's mask below the lane).  Tiles, warps, steps
//       and lanes all run in row order, so the sort is stable.
//    Ids outside [0, S) are dropped.
// 2. `sums`: one block per segment.  Seven loader warps stage the segment's
//    rows into shared memory, 256 rows at a time, channel-major and
//    double-buffered, with the row positions of the chunk after next copied
//    beside them, by asynchronous copies (cp.async) that are all in flight
//    at once; meanwhile one lane per channel runs the ordered chain
//    (`__fadd_rn`, never contracted) over the chunk staged before, from
//    shared memory only, four rows a 16-byte load.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpRows = 1024;        // ids one warp ranks in the layout
constexpr int kKeys = kWarpRows / 32;  // ids per lane
constexpr int kMaxTileWarps = 8;
constexpr int kScanThreads = 1024;
constexpr int kLoaders = 224;          // staging threads of a sums block
constexpr int kBatch = 8;              // row positions a staging thread reads before issuing their copies
constexpr int kMaxChunkRows = 256;
constexpr int kSmemLimit = 232448;     // a block's shared memory on sm_90
constexpr int kSmemDefault = 48 * 1024;
constexpr unsigned kAll = 0xffffffffu;

template <typename Id>
__device__ __forceinline__ void load_keys(const Id* __restrict__ ids, long long row0, int N, int S, int lane,
                                          int (&key)[kKeys]) {
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const long long row = row0 + j * 32 + lane;
    const long long v = row < N ? (long long)ids[row] : -1;
    key[j] = (v >= 0 && v < S) ? (int)v : -1;
  }
}

// Adds the warp's ids into its counters `cnt` (S ints of shared memory).
__device__ __forceinline__ void warp_count(const int (&key)[kKeys], int lane, int* cnt) {
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const unsigned peers = __match_any_sync(kAll, key[j]);
    if (key[j] >= 0 && lane == __ffs(peers) - 1) cnt[key[j]] += __popc(peers);
    __syncwarp();
  }
}

template <typename Id>
__global__ void tile_count_kernel(const Id* __restrict__ ids, int N, int S, int* __restrict__ counts) {
  extern __shared__ int cnt_all[];  // one row of S counters per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tw = blockDim.x >> 5;
  int* cnt = cnt_all + warp * S;
  for (int s = lane; s < S; s += 32) cnt[s] = 0;
  __syncwarp();
  int key[kKeys];
  load_keys(ids, ((long long)blockIdx.x * tw + warp) * kWarpRows, N, S, lane, key);
  warp_count(key, lane, cnt);
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int total = 0;
    for (int w = 0; w < tw; ++w) total += cnt_all[w * S + s];
    counts[(size_t)blockIdx.x * S + s] = total;
  }
}

// counts (T, S) -> each entry's first position in segment-major order, in
// place; starts[s] the first position of segment s, starts[S] the total.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ counts, int T, int S, int* __restrict__ starts) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int carry = 0;
  for (int s0 = 0; s0 < S; s0 += kScanThreads) {
    const int s = s0 + threadIdx.x;
    int total = 0;
    if (s < S) {
#pragma unroll 8
      for (int t = 0; t < T; ++t) total += counts[(size_t)t * S + s];
    }
    int incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kAll, v, d);
        if (lane >= d) v += u;
      }
      warp_sums[lane] = v;
    }
    __syncthreads();
    if (s < S) {
      int run = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + incl - total;
      starts[s] = run;
      for (int t0 = 0; t0 < T; t0 += 8) {  // eight loads in flight, then eight stores
        int c[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) c[j] = t0 + j < T ? counts[(size_t)(t0 + j) * S + s] : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (t0 + j < T) counts[(size_t)(t0 + j) * S + s] = run;
          run += c[j];
        }
      }
    }
    carry += warp_sums[31];
    __syncthreads();  // warp_sums is rewritten by the next round
  }
  if (threadIdx.x == 0) starts[S] = carry;
}

template <typename Id>
__global__ void scatter_kernel(const Id* __restrict__ ids, int N, int S, const int* __restrict__ offsets,
                               int* __restrict__ order) {
  extern __shared__ int cnt_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tw = blockDim.x >> 5;
  int* cnt = cnt_all + warp * S;
  for (int s = lane; s < S; s += 32) cnt[s] = 0;
  __syncwarp();
  const long long row0 = ((long long)blockIdx.x * tw + warp) * kWarpRows;
  int key[kKeys];
  load_keys(ids, row0, N, S, lane, key);
  warp_count(key, lane, cnt);
  __syncthreads();
  // Each warp's first position per segment: the tile's offset plus the
  // counts of the tile's earlier warps.
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int run = offsets[(size_t)blockIdx.x * S + s];
    for (int w = 0; w < tw; ++w) {
      const int c = cnt_all[w * S + s];
      cnt_all[w * S + s] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int k = key[j];
    const unsigned peers = __match_any_sync(kAll, k);
    if (k >= 0) order[cnt[k] + __popc(peers & below)] = (int)(row0 + j * 32 + lane);
    __syncwarp();  // every lane has read cnt[k] before its group's lowest lane moves it
    if (k >= 0 && lane == __ffs(peers) - 1) cnt[k] += __popc(peers);
    __syncwarp();
  }
}

// Rows per staged chunk of the sums kernel: 256, fewer (a multiple of four)
// where two chunks of C channels and two of row positions would pass 48 KB.
// A chunk is stored channel-major, each channel's rows padded by four
// floats, so a chain lane reads four rows with one 16-byte load and the
// lanes of a quarter-warp fall in different banks.
__host__ __device__ inline int chunk_rows(int C) {
  const int r = (kSmemDefault - 32 * C) / (8 * C + 8) / 4 * 4;
  return r < kMaxChunkRows ? (r < 4 ? 4 : r) : kMaxChunkRows;
}

__host__ __device__ inline size_t sums_smem(int C) {
  const int R = chunk_rows(C);
  return (size_t)2 * C * (R + 4) * sizeof(float) + (size_t)2 * R * sizeof(int);
}

__device__ __forceinline__ void loaders_sync() { asm volatile("bar.sync 1, %0;" ::"r"(kLoaders) : "memory"); }

// A 4-byte copy from device memory to the shared-memory address `dst` (a
// shared-window offset, computed once a block: converting a generic
// pointer for every copy cost more instructions than the copy) that
// completes asynchronously.
__device__ __forceinline__ void copy_async(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src));
}

// Waits for this thread's asynchronous copies.
__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

__device__ __forceinline__ float add4(float acc, float4 v) {
  acc = __fadd_rn(acc, v.x);
  acc = __fadd_rn(acc, v.y);
  acc = __fadd_rn(acc, v.z);
  return __fadd_rn(acc, v.w);
}

__global__ void sums_kernel(const float* __restrict__ vals, const int* __restrict__ order,
                            const int* __restrict__ starts, int C, float* __restrict__ out) {
  extern __shared__ float4 stage4[];  // two chunks of C x (R + 4) floats, then two of R row positions
  float* const stage = (float*)stage4;
  const int R = chunk_rows(C), RP = R + 4;
  int* const pos0 = (int*)(stage + 2 * C * RP);
  const unsigned stage_at = (unsigned)__cvta_generic_to_shared(stage);
  const unsigned pos_at = stage_at + (unsigned)(2 * C * RP * sizeof(float));
  const int s = blockIdx.x;
  const int begin = starts[s];
  const int n = starts[s + 1] - begin;
  const int tid = threadIdx.x;
  const int lt = tid - ((int)blockDim.x - kLoaders);  // loader index, < 0 for chain threads
  if (n == 0) {
    if (tid < C) out[(size_t)s * C + tid] = 0.0f;
    return;
  }
  const int chunks = (n + R - 1) / R;
  auto rows_in = [&](int k) { return min(R, n - k * R); };
  // Staging copies go from device memory to shared memory asynchronously
  // (cp.async): no register holds them and nothing waits for one until the
  // end of the stage, so a thread has all its copies of a chunk in flight.
  auto copy_pos = [&](int k) {
    const unsigned p = pos_at + (unsigned)((k & 1) * R * sizeof(int));
    const int* const src = order + begin + k * R;
    for (int r = lt; r < rows_in(k); r += kLoaders) copy_async(p + 4 * r, src + r);
  };
  // Element e of a chunk is row e / C, channel e % C; a staging thread
  // takes elements lt, lt + kLoaders, ..., reading kBatch row positions
  // before it issues their copies, and walks (row, channel) by the step's
  // quotient and remainder.
  const int dr = kLoaders / C, dc = kLoaders - dr * C;
  auto gather = [&](int k) {
    const int* const p = pos0 + (k & 1) * R;
    const unsigned dst = stage_at + (unsigned)((k & 1) * C * RP * sizeof(float));
    const int total = rows_in(k) * C;
    int r = lt / C, c = lt - r * C;
    for (int e0 = lt; e0 < total; e0 += kBatch * kLoaders) {
      int from[kBatch], to[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (e0 + j * kLoaders < total) {
          from[j] = p[r] * C + c;
          to[j] = c * RP + r;
        }
        c += dc;
        r += dr;
        if (c >= C) {
          c -= C;
          ++r;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (e0 + j * kLoaders < total) copy_async(dst + 4 * to[j], vals + from[j]);
    }
  };
  if (lt >= 0) {
    copy_pos(0);
    if (chunks > 1) copy_pos(1);
    copies_wait();
    loaders_sync();
    gather(0);
    copies_wait();
  }
  __syncthreads();
  float acc = 0.0f;
  for (int k = 0; k < chunks; ++k) {
    if (lt >= 0) {
      if (k + 2 < chunks) copy_pos(k + 2);
      if (k + 1 < chunks) gather(k + 1);
      copies_wait();
    } else if (tid < C) {
      // The chain over chunk k's rows of channel tid: four rows a 16-byte
      // load, each load issued four loads ahead of its adds.
      const float4* const src = (const float4*)(stage + (k & 1) * C * RP + tid * RP);
      const int rows = rows_in(k), q = rows >> 2;
      float4 ring[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ring[j] = src[min(j, q)];
      int b = 0;
      for (; b + 4 <= q; b += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc = add4(acc, ring[j]);
          ring[j] = src[min(b + 4 + j, q)];
        }
      }
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (b + j < q) acc = add4(acc, ring[j]);
      const float* const tail = (const float*)(src + q);
      for (int r = 0; r < (rows & 3); ++r) acc = __fadd_rn(acc, tail[r]);
    }
    __syncthreads();
  }
  if (tid < C) out[(size_t)s * C + tid] = acc;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  if (bytes <= (size_t)kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename Id>
cudaError_t layout(const Id* ids, int N, int S, int tile_warps, int* counts, int* order, int* starts,
                   cudaStream_t stream) {
  const int T = (N + tile_warps * kWarpRows - 1) / (tile_warps * kWarpRows);
  const size_t smem = (size_t)tile_warps * S * sizeof(int);
  cudaError_t err;
  if (T > 0) {
    if ((err = allow_smem(tile_count_kernel<Id>, smem)) != cudaSuccess) return err;
    tile_count_kernel<Id><<<T, tile_warps * 32, smem, stream>>>(ids, N, S, counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, T, S, starts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (T > 0) {
    if ((err = allow_smem(scatter_kernel<Id>, smem)) != cudaSuccess) return err;
    scatter_kernel<Id><<<T, tile_warps * 32, smem, stream>>>(ids, N, S, counts, order);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// The layout alone.  ids (N,) int32 (id_bytes 4) or int64 (8); scratch
// int32: counts (T x S, T = ceil(N / (tile_warps x 1024))), then order (N,),
// then starts (S + 1,).  order[starts[s] .. starts[s + 1]) lists segment
// s's rows in ascending order.
extern "C" int segment_layout_launch(const void* ids, int id_bytes, int N, int S, int tile_warps, void* scratch,
                                     void* stream) {
  if (S <= 0 || tile_warps < 1 || tile_warps > kMaxTileWarps || (id_bytes != 4 && id_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const int T = (N + tile_warps * kWarpRows - 1) / (tile_warps * kWarpRows);
  int* counts = (int*)scratch;
  int* order = counts + (size_t)T * S;
  int* starts = order + N;
  if (id_bytes == 4)
    return (int)layout((const int*)ids, N, S, tile_warps, counts, order, starts, (cudaStream_t)stream);
  return (int)layout((const long long*)ids, N, S, tile_warps, counts, order, starts, (cudaStream_t)stream);
}

// The sums alone, from a layout: vals (N, C) float32 -> out (S, C).
extern "C" int segment_sums_launch(const void* vals, const void* order, const void* starts, int S, int C, void* out,
                                   void* stream) {
  if (S <= 0 || C <= 0) return 0;
  const int chain = (C + 31) / 32 * 32;
  if (chain + kLoaders > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sums_smem(C);
  const cudaError_t err = allow_smem(sums_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sums_kernel<<<S, chain + kLoaders, smem, (cudaStream_t)stream>>>((const float*)vals, (const int*)order,
                                                                    (const int*)starts, C, (float*)out);
  return (int)cudaGetLastError();
}

// The whole call: the layout into `scratch`, then the sums into `out`.
extern "C" int segment_sum_launch(const void* vals, const void* ids, int id_bytes, int N, int S, int C,
                                  int tile_warps, void* scratch, void* out, void* stream) {
  if (S <= 0 || C <= 0) return 0;
  const int err = segment_layout_launch(ids, id_bytes, N, S, tile_warps, scratch, stream);
  if (err != 0) return err;
  const int T = (N + tile_warps * kWarpRows - 1) / (tile_warps * kWarpRows);
  const int* order = (const int*)scratch + (size_t)T * S;
  return segment_sums_launch(vals, order, order + N, S, C, out, stream);
}
