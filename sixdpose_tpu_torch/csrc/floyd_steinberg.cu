// Floyd-Steinberg density seeding for DASP superpixels, on sm_90a.
//
// Replaces the JAX package's host scan `native_bridge.floyd_steinberg`
// (native/sixdpose_native.cpp, called at sixdpose_tpu/seg/dasp.py:154); it
// has no TPU kernel.  The reference is FloydSteinberg.cpp:35-138.
//
// What it computes: a serpentine error diffusion over an (H, W) float32
// density in double precision.  Even rows run left to right, odd rows right
// to left; a pixel whose diffused value v reaches 0.5 is a seed, and its
// error e = v - (0 or 1) goes 7/16 to the next pixel of the row and 3/16,
// 5/16, 1/16 to the pixels behind, under and ahead of it in the next row.
// The output is the seeds' (x, y) as float32 in scan order and their count.
//
// What bounds it: the scan is one dependent chain, pixel after pixel (each
// v needs the previous pixel's 7/16).  So one thread runs it, and the design
// keeps that chain short: the row being scanned and the next row live in
// shared memory as doubles and are read one pixel ahead; the next row's
// three contributions are carried in registers (the element behind the
// pixel is finished and stored when the pixel is done).  A pixel's chain is
// an add, a compare, a subtract and a multiply, none of them waiting for
// memory.  While thread 0 scans row y, the block's other warps stage row
// y + 2's density into a third shared buffer.
//
// Exactness: every step is the host scan's double operation with its own
// rounding (__dadd_rn, __dsub_rn, __dmul_rn: nvcc may not contract them into
// fused multiply-adds), in the host scan's order per element: the density,
// then 1/16, 5/16 and 3/16 from the row above in scan order, then 7/16.
// e * 7 / 16 is e * 0.4375: e * 7 rounds the exact product, and dividing by
// 16 scales it exactly, so both round the same exact value (likewise 3/16,
// 5/16, 1/16).  The first pixel of a row adds a carry of +0.0, which leaves
// every value unchanged (the diffused values are never -0.0).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
floyd_steinberg_kernel(const float* __restrict__ density, int H, int W, float* __restrict__ seeds,
                       int* __restrict__ count, int cap) {
  extern __shared__ double rows[];  // three rows of W doubles
  const int tid = threadIdx.x;
  for (int i = tid; i < W; i += kThreads) {
    rows[i] = (double)density[i];
    if (H > 1) rows[W + i] = (double)density[W + i];
  }
  __syncthreads();
  int n = 0;
  for (int y = 0; y < H; ++y) {
    double* cur = rows + (y % 3) * W;
    double* nxt = rows + ((y + 1) % 3) * W;
    double* pre = rows + ((y + 2) % 3) * W;
    if (tid >= 32) {
      if (y + 2 < H) {
        const float* src = density + (size_t)(y + 2) * W;
        for (int i = tid - 32; i < W; i += kThreads - 32) pre[i] = (double)src[i];
      }
    } else if (tid == 0) {
      const int sgn = (y % 2 == 0) ? 1 : -1;
      const int x0 = (sgn > 0) ? 0 : W - 1;
      const bool below = y + 1 < H;
      double carry = 0.0;
      double b_prev = 0.0;                   // next-row element behind the pixel
      double b_cur = below ? nxt[x0] : 0.0;  // under it
      double c_ahead = cur[x0];              // this row at the pixel, read ahead
      double n_ahead = (below && W > 1) ? nxt[x0 + sgn] : 0.0;  // next row ahead of it
      for (int i = 0; i < W; ++i) {
        const int x = x0 + i * sgn;
        const bool ahead = i + 1 < W;
        const double v = __dadd_rn(c_ahead, carry);
        const double n_here = n_ahead;
        if (ahead) {
          c_ahead = cur[x + sgn];
          if (below && i + 2 < W) n_ahead = nxt[x + 2 * sgn];
        }
        const double out = (v >= 0.5) ? 1.0 : 0.0;
        if (out > 0.0) {
          if (n < cap) {
            seeds[2 * n] = (float)x;
            seeds[2 * n + 1] = (float)y;
          }
          ++n;
        }
        const double e = __dsub_rn(v, out);
        carry = __dmul_rn(e, 0.4375);
        if (below) {
          if (i > 0) nxt[x - sgn] = __dadd_rn(b_prev, __dmul_rn(e, 0.1875));
          b_cur = __dadd_rn(b_cur, __dmul_rn(e, 0.3125));
          const double b_next = ahead ? __dadd_rn(n_here, __dmul_rn(e, 0.0625)) : 0.0;
          b_prev = b_cur;
          b_cur = b_next;
        }
      }
      if (below) nxt[x0 + (W - 1) * sgn] = b_prev;
    }
    __syncthreads();
  }
  if (tid == 0) *count = n;
}

}  // namespace

// density (H, W) float32 -> seeds (cap, 2) float32 (the first count rows
// written) and count (1,) int32; one block, on `stream`.
extern "C" int floyd_steinberg_launch(const void* density, int H, int W, void* seeds, void* count, int cap,
                                      void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const size_t smem = (size_t)3 * W * sizeof(double);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(floyd_steinberg_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  floyd_steinberg_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)density, H, W, (float*)seeds, (int*)count, cap);
  return (int)cudaGetLastError();
}
