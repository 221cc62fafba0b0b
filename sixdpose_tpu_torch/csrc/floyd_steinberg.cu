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
// What bounds it: the scan is one dependent chain, pixel after pixel: v is
// this pixel's value plus the previous pixel's 7/16, so a pixel's chain is
// an add, a compare, a select between e = v and e = v - 1, and a multiply by
// 0.4375, all in double precision.  One thread runs it;
// `floyd_steinberg_chain_launch` below runs that chain alone, in registers,
// to measure the bound on the card.  The design keeps everything else off
// the chain:
//
// - Thread 0 only scans.  The row's values (density plus what the row above
//   diffused) are read from one shared buffer of doubles, the next row's
//   density (staged as doubles) from another, and its finished values go to
//   a third.  The next row's three pending elements live in registers.
// - A group of eight pixels keeps its seeds as the bits of one register
//   byte, stored to shared memory once: no global store and no counter in
//   the chain.
// - Each direction has its own loop, and the last row its own, so the inner
//   loop tests nothing but its bound; the first and last pixels of a row
//   need no test either (pads beside each row take their out-of-row reads
//   and writes).  Values are loaded a group of eight pixels ahead, into
//   registers (see `scan_row`).
// - While thread 0 scans row y, warp 1 compacts row y - 1's seed words into
//   (x, y) pairs (a popc prefix over the words) and keeps the count, and
//   warps 2-7 stage row y + 2's density.  One barrier a row.
//
// Exactness: every step is the host scan's double operation with its own
// rounding (__dadd_rn, __dsub_rn, __dmul_rn: nvcc may not contract them into
// fused multiply-adds), in the host scan's order per element: the density,
// then 1/16, 5/16 and 3/16 from the row above in scan order, then 7/16.
// e * 7 / 16 is e * 0.4375: e * 7 rounds the exact product, and dividing by
// 16 scales it exactly, so both round the same exact value (likewise 3/16,
// 5/16, 1/16).  The host's e = v - 0.0 is v itself, so the select keeps v.
// The first pixel of a row adds a carry of -0.0, which changes no value.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // warp 0: the scan (lane 0); warp 1: seeds; warps 2-7: staging
constexpr int kStageFrom = 64;
constexpr int kSmemLimit = 232448;
constexpr unsigned kAll = 0xffffffffu;

// The chain's select: the error of a pixel whose diffused value is v.
__device__ __forceinline__ double diffuse(double v, bool& seed) {
  seed = v >= 0.5;
  return seed ? __dsub_rn(v, 1.0) : v;
}

// One row in direction SGN (+1 left to right).  c: the row's values; d: the
// next row's density; out: the next row's finished values (each pointing
// at column 0, with kPad spare elements on either side); seed_bytes: the
// row's seeds, bit j of byte i / 8 for the (i = 8k + j)-th pixel in scan
// order.  BELOW: a next row exists.
//
// Every pixel runs one body.  The first adds a carry of -0.0, which leaves
// every value as it is (x + -0.0 is x), so it takes its value as the host
// does; the pads take the first pixel's store behind it and the last
// pixel's read ahead of it, so no pixel tests where it is.  Pixels run in
// groups of kGroup whose values are loaded into registers a group ahead:
// the compiler keeps a shared load behind every earlier shared store,
// `__restrict__` or not (read in the SASS), so a load issued one pixel
// ahead waited for the previous pixel's store.  A group's seeds are one
// byte, stored once.
constexpr int kGroup = 8;
constexpr int kPad = 2 * kGroup;

template <int SGN, bool BELOW>
__device__ __forceinline__ void scan_row(const double* __restrict__ c, const double* __restrict__ d,
                                         double* __restrict__ out, unsigned char* __restrict__ seed_bytes, int W) {
  const int x0 = SGN > 0 ? 0 : W - 1;
  const double* cp = c + x0;  // pixel i of the scan: cp[i * SGN]
  const double* dp = d + x0;
  double* op = out + x0;
  double carry = -0.0;
  double b_prev = 0.0;                   // next row, behind the pixel
  double b_cur = BELOW ? dp[0] : 0.0;    // under it
  auto pixel = [&](int i, double cv, double dv, unsigned& byte, int j) {
    bool seed;
    const double e = diffuse(__dadd_rn(cv, carry), seed);
    carry = __dmul_rn(e, 0.4375);
    byte |= seed ? 1u << j : 0u;
    if (BELOW) {
      op[(i - 1) * SGN] = __dadd_rn(b_prev, __dmul_rn(e, 0.1875));
      b_prev = __dadd_rn(b_cur, __dmul_rn(e, 0.3125));
      b_cur = __dadd_rn(dv, __dmul_rn(e, 0.0625));
    }
  };
  double cq[kGroup], dq[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    cq[j] = cp[j * SGN];
    dq[j] = BELOW ? dp[(j + 1) * SGN] : 0.0;
  }
  int i0 = 0;
  for (; i0 + kGroup <= W; i0 += kGroup) {
    double cn[kGroup], dn[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      cn[j] = cp[(i0 + kGroup + j) * SGN];
      dn[j] = BELOW ? dp[(i0 + kGroup + j + 1) * SGN] : 0.0;
    }
    unsigned byte = 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) pixel(i0 + j, cq[j], dq[j], byte, j);
    seed_bytes[i0 >> 3] = (unsigned char)byte;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      cq[j] = cn[j];
      dq[j] = dn[j];
    }
  }
  if (i0 < W) {
    unsigned byte = 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (i0 + j < W) pixel(i0 + j, cq[j], dq[j], byte, j);
    seed_bytes[i0 >> 3] = (unsigned char)byte;
  }
  if (BELOW) op[(W - 1) * SGN] = b_prev;
}

// Warp 1: row y's seed words -> (x, y) pairs from position n on, in scan
// order; returns the new count (the same in every lane).  Bits past the
// row's end in its last word are stale and masked off.
__device__ int compact(const unsigned* __restrict__ words, int y, int W, int nw, int n, float2* __restrict__ seeds,
                       int cap, int lane) {
  const unsigned last_mask = (W & 31) ? (1u << (W & 31)) - 1u : kAll;
  for (int k0 = 0; k0 < nw; k0 += 32) {
    const int k = k0 + lane;
    unsigned w = k < nw ? words[k] : 0u;
    if (k == nw - 1) w &= last_mask;
    const int cnt = __popc(w);
    int incl = cnt;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, dd);
      if (lane >= dd) incl += v;
    }
    int pos = n + incl - cnt;
    while (w) {
      const int i = k * 32 + __ffs(w) - 1;
      w &= w - 1;
      if (pos < cap) seeds[pos] = make_float2((float)((y & 1) ? W - 1 - i : i), (float)y);
      ++pos;
    }
    n += __shfl_sync(kAll, incl, 31);
  }
  return n;
}

__global__ void __launch_bounds__(kThreads)
floyd_steinberg_kernel(const float* __restrict__ density, int H, int W, float2* __restrict__ seeds,
                       int* __restrict__ count, int cap) {
  extern __shared__ double smem[];
  const int nw = (W + 31) / 32;
  const int rs = W + 2 * kPad;  // a row buffer: kPad spare doubles, the row, kPad spare
  double* vals = smem + kPad;                      // two rows of values: the row scanned, the next
  double* dens = smem + 2 * rs + kPad;             // two rows of density
  unsigned* words = (unsigned*)(smem + 4 * rs);    // two rows of seed words
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < W; i += kThreads) {
    vals[i] = (double)density[i];
    if (H > 1) dens[rs + i] = (double)density[W + i];
  }
  __syncthreads();
  int n = 0;
  for (int y = 0; y < H; ++y) {
    if (tid == 0) {
      const double* c = vals + (y & 1) * rs;
      double* out = vals + ((y + 1) & 1) * rs;
      const double* d = dens + ((y + 1) & 1) * rs;
      unsigned char* wy = (unsigned char*)(words + (y & 1) * nw);
      if (y + 1 < H) {
        if (y & 1) scan_row<-1, true>(c, d, out, wy, W);
        else scan_row<1, true>(c, d, out, wy, W);
      } else {
        if (y & 1) scan_row<-1, false>(c, d, out, wy, W);
        else scan_row<1, false>(c, d, out, wy, W);
      }
    } else if (tid >= kStageFrom) {
      if (y + 2 < H) {
        const float* src = density + (size_t)(y + 2) * W;
        double* dst = dens + (y & 1) * rs;
        for (int i = tid - kStageFrom; i < W; i += kThreads - kStageFrom) dst[i] = (double)src[i];
      }
    } else if (tid >= 32 && y > 0) {
      n = compact(words + ((y - 1) & 1) * nw, y - 1, W, nw, n, seeds, cap, lane);
    }
    __syncthreads();
  }
  if (tid >= 32 && tid < 64) {
    n = compact(words + ((H - 1) & 1) * nw, H - 1, W, nw, n, seeds, cap, lane);
    if (tid == 32) *count = n;
  }
}

// The chain alone: n pixels of value c, in registers, no memory, no branch.
__global__ void chain_kernel(int n, double c, double* __restrict__ out) {
  double carry = 0.0;
  unsigned seeds = 0;
  for (int i = 0; i < n; ++i) {
    bool seed;
    carry = __dmul_rn(diffuse(__dadd_rn(c, carry), seed), 0.4375);
    seeds += seed;
  }
  out[0] = carry;
  out[1] = (double)seeds;
}

// Shared memory of one launch at width W: four padded rows of doubles (two
// of values, two of density), two rows of seed words.
long long smem_bytes(int W) { return 32LL * (W + 2 * kPad) + 8LL * ((W + 31) / 32); }

}  // namespace

// density (H, W) float32 -> seeds (cap, 2) float32 (the first count rows
// written) and count (1,) int32; one block, on `stream`.
extern "C" int floyd_steinberg_launch(const void* density, int H, int W, void* seeds, void* count, int cap,
                                      void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const long long smem = smem_bytes(W);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(floyd_steinberg_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  floyd_steinberg_kernel<<<1, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)density, H, W, (float2*)seeds, (int*)count, cap);
  return (int)cudaGetLastError();
}

// The chain probe: one thread, n iterations of the scan's per-pixel chain;
// out (2,) float64 receives the last carry and the seed count.
extern "C" int floyd_steinberg_chain_launch(int n, double c, void* out, void* stream) {
  chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(n, c, (double*)out);
  return (int)cudaGetLastError();
}
