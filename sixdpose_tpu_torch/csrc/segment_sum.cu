// Ordered per-segment float32 sums, on sm_90a.
//
// Replaces XLA's CPU `segment_sum` in the JAX package's ALIC update
// (sixdpose_tpu/seg/dasp.py:307,310 and seg/slic.py:149,152); it has no TPU
// kernel.  out[s, c] = vals[i0, c] + vals[i1, c] + ... over the rows i of
// segment s in ascending order, added one at a time in float32 from +0.0:
// the order XLA's scatter-add takes on the CPU, so the sums equal the JAX
// package's bits.  Atomics (`index_add_`) would add in no fixed order.
//
// Layout: the wrapper sorts the ids stably (CSR: `order` lists each
// segment's rows in ascending order from `starts[s]`, `counts[s]` of them).
// One thread per (segment, channel) walks its segment's rows; the threads
// of one segment are neighbours, so each row's C values are read together.
//
// What bounds it: the longest segment's walk, a chain of dependent float32
// adds fed by gathered loads (the bytes, N x C x 4 plus the ids, are read
// once).  The loop is unrolled so that several rows' loads are in flight
// while the adds, which must stay in order, wait for them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals, const long long* __restrict__ order,
                   const long long* __restrict__ starts, const long long* __restrict__ counts, int S, int C,
                   float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= S * C) return;
  const int s = t / C;
  const int c = t - s * C;
  const long long* rows = order + starts[s];
  const int n = (int)counts[s];
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < n; ++k) acc = __fadd_rn(acc, vals[rows[k] * C + c]);
  out[t] = acc;
}

}  // namespace

// vals (N, C) float32, order (N,) int64, starts / counts (S,) int64 ->
// out (S, C) float32, on `stream`.
extern "C" int segment_sum_launch(const void* vals, const void* order, const void* starts, const void* counts, int S,
                                  int C, void* out, void* stream) {
  if (S <= 0 || C <= 0) return 0;
  const int blocks = (S * C + kThreads - 1) / kThreads;
  segment_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const long long*)order, (const long long*)starts, (const long long*)counts, S, C,
      (float*)out);
  return (int)cudaGetLastError();
}
