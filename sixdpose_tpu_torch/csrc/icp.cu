// Batched projective point-to-plane ICP in one launch: every Gauss-Newton
// iteration of every candidate and the final fitness and rmse, written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package runs ICP as one XLA program
// (icp_batch, sixdpose_tpu/models/refine.py).  The port ran the same
// algorithm as eager PyTorch (icp_batch_plain, models/refine.py), about 300
// small kernels an iteration whatever the batch: 5,971 launches and 15.7 ms
// of device time a served T-LESS frame, for 240 candidates, and 5,737 for
// 57 on the LINEMOD host route, each launch costing the host ~19 us.  This
// kernel is that loop with the launches taken out.
//
// Contract: the bits of icp_batch_plain.  ICP's inlier gate turns one ulp
// into millimetres, so every float32 operation of the plain version is
// repeated here in its order and rounding: __fadd_rn / __fsub_rn /
// __fmul_rn / __fdiv_rn (nvcc would contract a*b + c into an FMA), the
// correctly rounded __fsqrt_rn for sqrt32, rintf for torch.round, sin and
// cos in float64 rounded to float32, clamps that keep a NaN as torch.clamp
// does, every add of a zero that the plain version makes (signed zeros),
// short axes added in index order, and the sums over the points in
// _tree_sum's order (zero-padded to a power of two P, then x[i] + x[i +
// P/2] level by level).  The per-iteration gate, colour weight and colour
// divisor are float32 scalars computed on the host, as the plain step
// computes them, and come in the launch arguments (a schedule of more than
// 128 iterations from a table on the device).
//
// What bounds it on the H100.  The work is small: at the served T-LESS
// call (240 candidates of 512 points, 20 iterations) about 1.5 GFLOP and
// 170 MB of table rows gathered from the packed scene maps (20 MB for a
// 720 x 540 frame, which the 50 MB L2 holds): 0.02 ms at the card's
// float32 rate, 0.4 ms measured.  What bounds it is latency:
// each iteration is a chain of a gather, two block reductions and a
// serial 6 x 6 solve, and 20 iterations run one after another.  The
// design keeps that chain inside one block and on chip:
//
// 1. One block of 256 threads per candidate; all candidates run at once
//    (240 blocks fit the 132 SMs in one wave at two blocks an SM).  Thread
//    t holds the points t, t + 256, ... of the phase's cloud (up to 8,
//    RegCloud's M, chosen from N) in registers, with their validity and
//    chroma; the pose lives in shared memory for the whole loop.  A larger
//    cloud (StreamCloud, N > 2,048) is read from global memory as the
//    sums need it, each point associated again for each group of columns,
//    and added in the same order by a binary counter (tree_stream).
// 2. An iteration gathers one packed (H*W, 7) row per point (nearest tap,
//    the early iterations on the strided coarse subset) or four (bilinear,
//    the last iterations on the full cloud), plus one (H*W, 6) chroma row
//    when colour is on, and keeps each point's terms in registers.
// 3. Two block reductions follow the tree exactly: a thread adds its
//    points pairwise in registers (the tree's top levels), the 256 partial
//    sums go to shared memory (42 columns x 256 x 4 B = 43 KB), and each
//    warp finishes whole columns, 8 values a lane then 5 shuffle levels.
//    First the 4 columns of the inlier count and centroid, then the 42 of
//    H and g.
// 4. Thread 0 solves the damped 6 x 6 system (unpivoted Gauss-Jordan),
//    builds the Rodrigues rotation and composes the pose while the block
//    waits: a few hundred dependent operations, short beside a launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads a block (one candidate)
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 42;               // the 36 entries of H, then the 6 of g
constexpr int kMaxIters = 128;          // iterations a schedule in the launch arguments holds
constexpr int kLevels = 17;             // StreamCloud's counter: 2^16 points a thread at most

struct Schedule {                       // float32, one entry an iteration
  float gate[kMaxIters];                // correspondence gate (m)
  float w_col[kMaxIters];               // colour-term weight
  float sdiv[kMaxIters];                // sigma * chroma_scale
};

struct Params {
  const float* packed;                  // (H*W, 7) points | normals | valid
  const float* chroma;                  // (H*W, 6) c | du | dv, or null
  const float* pts;                     // (K, N, 3) model points (m)
  const bool* valid;                    // (K, N)
  const float* pchroma;                 // (K, N, 2), or null
  const float* cam;                     // (3, 3) scene intrinsics
  const float* init_T;                  // (K, 4, 4)
  float* T_out;                         // (K, 4, 4)
  float* fitness;                       // (K,)
  float* rmse;                          // (K,)
  const float* sched;                   // (3, max_iters) schedule on the device, or null (then the Schedule)
  int N, h, w, max_iters, n_near, stride;
  float point_weight, lm_damping, chroma_scale, corr_dist;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp keeps a NaN (fmaxf alone would drop it).
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// _norm: sqrt32 of the squares added in order.
__device__ __forceinline__ float norm3(float a, float b, float c) {
  return __fsqrt_rn(add_rn(add_rn(mul_rn(a, a), mul_rn(b, b)), mul_rn(c, c)));
}

// The tree's levels over a thread's m (a power of two) values: v[j] +=
// v[j + h] for h = m/2 .. 1, which is _tree_sum's order for elements t +
// kThreads * j.  Leaves the sum in v[0].
template <int M, int C>
__device__ __forceinline__ void tree_regs(float (&v)[M][C], int m) {
#pragma unroll
  for (int h = M / 2; h >= 1; h >>= 1) {
    if (h < m) {
#pragma unroll
      for (int j = 0; j < h; ++j) {
#pragma unroll
        for (int c = 0; c < C; ++c) v[j][c] = add_rn(v[j][c], v[j + h][c]);
      }
    }
  }
}

// One column's np (a power of two, at most kThreads) partial sums in shared
// memory, reduced by one warp in the tree's order; the sum is in lane 0.
__device__ __forceinline__ float warp_tree(const float* col, int np) {
  const int lane = threadIdx.x & 31;
  float v[kThreads / 32][1];
  const int per = np >= 32 ? np / 32 : 1;
#pragma unroll
  for (int j = 0; j < kThreads / 32; ++j) v[j][0] = (j < per && lane + 32 * j < np) ? col[lane + 32 * j] : 0.0f;
  tree_regs<kThreads / 32, 1>(v, per);
  for (int h = min(np, 32) / 2; h >= 1; h >>= 1) v[0][0] = add_rn(v[0][0], __shfl_down_sync(0xffffffffu, v[0][0], h));
  return v[0][0];
}

struct Scene {
  const float* packed;
  const float* chroma;
  float fx, fy, cx, cy;
  int h, w;
};

// _SceneLookup.project.
__device__ __forceinline__ bool project(const Scene& s, const float p[3], float& u, float& v) {
  u = add_rn(mul_rn(div_rn(p[0], p[2]), s.fx), s.cx);
  v = add_rn(mul_rn(div_rn(p[1], p[2]), s.fy), s.cy);
  return u >= 0.0f && u <= (float)(s.w - 1) && v >= 0.0f && v <= (float)(s.h - 1) && p[2] > 1e-6f;
}

// _SceneLookup.pixel: round, cast, then clip.
__device__ __forceinline__ int pixel(const Scene& s, float u, float v) {
  const int ur = min(max((int)rintf(u), 0), s.w - 1);
  const int vr = min(max((int)rintf(v), 0), s.h - 1);
  return vr * s.w + ur;
}

// _SceneLookup.nearest.
__device__ __forceinline__ bool nearest(const Scene& s, const float p[3], float q[3], float n[3]) {
  float u, v;
  const bool inb = project(s, p, u, v);
  const float* tap = s.packed + (size_t)pixel(s, u, v) * 7;
  const bool ok = inb && __ldg(tap + 6) > 0.5f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q[c] = ok ? __ldg(tap + c) : 0.0f;
    n[c] = ok ? __ldg(tap + 3 + c) : 0.0f;
  }
  return ok;
}

// _SceneLookup.bilinear.
__device__ __forceinline__ bool bilinear(const Scene& s, const float p[3], float q[3], float n[3]) {
  float u, v;
  const bool inb = project(s, p, u, v);
  const int u0 = min(max((int)floorf(u), 0), s.w - 1);
  const int v0 = min(max((int)floorf(v), 0), s.h - 1);
  const int u1 = min(u0 + 1, s.w - 1);
  const int v1 = min(v0 + 1, s.h - 1);
  const float fu = clamp_to(sub_rn(u, (float)u0), 0.0f, 1.0f);
  const float fv = clamp_to(sub_rn(v, (float)v0), 0.0f, 1.0f);
  const float gu = sub_rn(1.0f, fu), gv = sub_rn(1.0f, fv);
  const float wt[4] = {mul_rn(gu, gv), mul_rn(fu, gv), mul_rn(gu, fv), mul_rn(fu, fv)};
  const int idx[4] = {v0 * s.w + u0, v0 * s.w + u1, v1 * s.w + u0, v1 * s.w + u1};
  float acc[7];
#pragma unroll
  for (int tp = 0; tp < 4; ++tp) {
    const float* tap = s.packed + (size_t)idx[tp] * 7;
    const float wv = mul_rn(wt[tp], __ldg(tap + 6));
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      const float x = mul_rn(wv, __ldg(tap + c));
      acc[c] = tp == 0 ? x : add_rn(acc[c], x);
    }
  }
  const float ws = acc[6];
  const float wsc = clamp_min(ws, 1e-9f);
  const float nn = norm3(acc[3], acc[4], acc[5]);
  const float nnc = clamp_min(nn, 1e-9f);
  const bool ok = inb && ws > 0.5f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q[c] = ok ? div_rn(acc[c], wsc) : 0.0f;
    n[c] = nn > 1e-6f ? div_rn(acc[3 + c], nnc) : 0.0f;
  }
  return ok;
}

// p = R x + t (_rigid: _matvec added in order, then + t).
__device__ __forceinline__ void rigid(const float* T, const float x[3], float p[3]) {
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    p[m] = add_rn(add_rn(add_rn(mul_rn(T[4 * m], x[0]), mul_rn(T[4 * m + 1], x[1])), mul_rn(T[4 * m + 2], x[2])),
                  T[4 * m + 3]);
  }
}

// One point's terms of an iteration, kept between the two reductions.
struct Pt {
  float p[3], n[3], d[3], r, w;
  float dc[6], rc[2], cw;  // colour: dc/dp (2 x 3), chroma residual, weight
};

// The association half of the plain step for one point: p, the lookup, the
// residuals and the inlier weight; with colour, the chroma tap's Jacobian
// dc/dp, residual and robust weight.
__device__ __forceinline__ void associate(const Scene& s, const float* T, const float x[3], bool valid,
                                          const float pch[2], bool near, bool color, float gate, float sdiv,
                                          float cs, Pt& o) {
  rigid(T, x, o.p);
  float q[3];
  const bool ok = near ? nearest(s, o.p, q, o.n) : bilinear(s, o.p, q, o.n);
#pragma unroll
  for (int c = 0; c < 3; ++c) o.d[c] = sub_rn(o.p[c], q[c]);
  o.r = add_rn(add_rn(mul_rn(o.d[0], o.n[0]), mul_rn(o.d[1], o.n[1])), mul_rn(o.d[2], o.n[2]));
  const bool good = valid && ok && q[2] > 0.0f && norm3(o.d[0], o.d[1], o.d[2]) < gate &&
                    norm3(o.n[0], o.n[1], o.n[2]) > 0.5f;
  o.w = good ? 1.0f : 0.0f;
  if (color) {
    const float pz = clamp_min(o.p[2], 1e-6f);
    const float u = add_rn(mul_rn(div_rn(o.p[0], pz), s.fx), s.cx);
    const float v = add_rn(mul_rn(div_rn(o.p[1], pz), s.fy), s.cy);
    const float* ct = s.chroma + (size_t)pixel(s, u, v) * 6;
    float c6[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) c6[c] = __ldg(ct + c);
    const float pz2 = mul_rn(pz, pz);
    const float dudp[3] = {div_rn(s.fx, pz), 0.0f, div_rn(mul_rn(-s.fx, o.p[0]), pz2)};
    const float dvdp[3] = {0.0f, div_rn(s.fy, pz), div_rn(mul_rn(-s.fy, o.p[1]), pz2)};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      o.rc[a] = mul_rn(sub_rn(c6[a], pch[a]), cs);
      const float gu = mul_rn(c6[2 + a], cs), gv = mul_rn(c6[4 + a], cs);
#pragma unroll
      for (int b = 0; b < 3; ++b) o.dc[3 * a + b] = add_rn(mul_rn(gu, dudp[b]), mul_rn(gv, dvdp[b]));
    }
    const bool bright = add_rn(c6[0], c6[1]) > 1e-6f;
    const float rmag = div_rn(add_rn(fabsf(o.rc[0]), fabsf(o.rc[1])), sdiv);
    o.cw = div_rn(mul_rn(o.w, bright ? 1.0f : 0.0f), add_rn(1.0f, mul_rn(rmag, rmag)));
  }
}

// Row `row` of one point's normal equations: H[row][0..5] for row < 6, g
// for row 6, with the plain step's products and in-order sums.
__device__ __forceinline__ void normal_row(const Pt& s, const float c[3], int row, bool color, float pw, float wc,
                                           float out[6]) {
  const float pc[3] = {sub_rn(s.p[0], c[0]), sub_rn(s.p[1], c[1]), sub_rn(s.p[2], c[2])};
  const float a[6] = {sub_rn(mul_rn(pc[1], s.n[2]), mul_rn(pc[2], s.n[1])),
                      sub_rn(mul_rn(pc[2], s.n[0]), mul_rn(pc[0], s.n[2])),
                      sub_rn(mul_rn(pc[0], s.n[1]), mul_rn(pc[1], s.n[0])), s.n[0], s.n[1], s.n[2]};
  // J = [-[pc]x | I], negated from _skew's entries (so -(+0) = -0).
  const float jpt[3][6] = {{-0.0f, pc[2], -pc[1], 1.0f, 0.0f, 0.0f},
                           {-pc[2], -0.0f, pc[0], 0.0f, 1.0f, 0.0f},
                           {pc[1], -pc[0], -0.0f, 0.0f, 0.0f, 1.0f}};
  float jc[2][6];
  if (color) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        jc[b][j] = add_rn(add_rn(mul_rn(s.dc[3 * b], jpt[0][j]), mul_rn(s.dc[3 * b + 1], jpt[1][j])),
                          mul_rn(s.dc[3 * b + 2], jpt[2][j]));
      }
    }
  }
  if (row < 6) {
    const int i = row;
    const float aw = mul_rn(a[i], s.w);
    const float jw[3] = {mul_rn(jpt[0][i], s.w), mul_rn(jpt[1][i], s.w), mul_rn(jpt[2][i], s.w)};
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float m = add_rn(add_rn(mul_rn(jw[0], jpt[0][j]), mul_rn(jw[1], jpt[1][j])), mul_rn(jw[2], jpt[2][j]));
      out[j] = add_rn(mul_rn(aw, a[j]), mul_rn(pw, m));
    }
    if (color) {
      const float jcw[2] = {mul_rn(jc[0][i], s.cw), mul_rn(jc[1][i], s.cw)};
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        out[j] = add_rn(out[j], mul_rn(wc, add_rn(mul_rn(jcw[0], jc[0][j]), mul_rn(jcw[1], jc[1][j]))));
      }
    }
  } else {
    const float nd[3] = {-s.d[0], -s.d[1], -s.d[2]};
    const float nr = -s.r;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float aw = mul_rn(a[i], s.w);
      const float jw[3] = {mul_rn(jpt[0][i], s.w), mul_rn(jpt[1][i], s.w), mul_rn(jpt[2][i], s.w)};
      const float mv = add_rn(add_rn(mul_rn(jw[0], nd[0]), mul_rn(jw[1], nd[1])), mul_rn(jw[2], nd[2]));
      out[i] = add_rn(mul_rn(aw, nr), mul_rn(pw, mv));
      if (color) {
        const float jcw[2] = {mul_rn(jc[0][i], s.cw), mul_rn(jc[1][i], s.cw)};
        out[i] = add_rn(out[i], mul_rn(wc, add_rn(mul_rn(jcw[0], -s.rc[0]), mul_rn(jcw[1], -s.rc[1]))));
      }
    }
  }
}

// The damped solve, the Rodrigues update and the composition of one
// iteration (thread 0): s2 holds H (row-major) then g, c the inlier
// centroid, T the pose (updated in place when n_in >= 6).
__device__ void update_pose(const float* s2, const float c[3], float n_in, float lm, float* T) {
  float A[6][7];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const bool dg = i == j;
      A[i][j] = add_rn(add_rn(s2[6 * i + j], mul_rn(lm, dg ? s2[7 * i] : 0.0f)), mul_rn(1e-9f, dg ? 1.0f : 0.0f));
    }
    A[i][6] = s2[36 + i];
  }
  // _solve_spd: unpivoted Gauss-Jordan, each step from the previous matrix.
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float row[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) row[j] = div_rn(A[k][j], A[k][k]);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i == k) continue;
      const float f = A[i][k];
#pragma unroll
      for (int j = 0; j < 7; ++j) A[i][j] = sub_rn(A[i][j], mul_rn(f, row[j]));
    }
#pragma unroll
    for (int j = 0; j < 7; ++j) A[k][j] = row[j];
  }
  // _so3_exp of xi[:3].
  const float theta = add_rn(norm3(A[0][6], A[1][6], A[2][6]), 1e-12f);
  const float k0 = div_rn(A[0][6], theta), k1 = div_rn(A[1][6], theta), k2 = div_rn(A[2][6], theta);
  const float kx[3][3] = {{0.0f, -k2, k1}, {k2, 0.0f, -k0}, {-k1, k0, 0.0f}};
  // Two calls, as torch.sin and torch.cos make: the volatile copy keeps the
  // compiler from fusing them into one sincos.
  volatile double th_c = (double)theta;
  const float sn = (float)sin((double)theta);
  const float cs = (float)cos((double)th_c);
  const float omc = sub_rn(1.0f, cs);
  float dT[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = add_rn(add_rn(mul_rn(kx[i][0], kx[0][j]), mul_rn(kx[i][1], kx[1][j])), mul_rn(kx[i][2], kx[2][j]));
      dT[i][j] = add_rn(add_rn(i == j ? 1.0f : 0.0f, mul_rn(sn, kx[i][j])), mul_rn(omc, kk));
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float mv = add_rn(add_rn(mul_rn(dT[i][0], c[0]), mul_rn(dT[i][1], c[1])), mul_rn(dT[i][2], c[2]));
    dT[i][3] = add_rn(sub_rn(c[i], mv), A[3 + i][6]);
  }
  if (!(n_in >= 6.0f)) return;
  float out[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float r[4] = {i < 3 ? dT[i][0] : 0.0f, i < 3 ? dT[i][1] : 0.0f, i < 3 ? dT[i][2] : 0.0f,
                        i < 3 ? dT[i][3] : 1.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[4 * i + j] = add_rn(add_rn(add_rn(mul_rn(r[0], T[j]), mul_rn(r[1], T[4 + j])), mul_rn(r[2], T[8 + j])),
                              mul_rn(r[3], T[12 + j]));
    }
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) T[e] = out[e];
}

// A phase's cloud: the candidate's points taken every `stride` points, n
// of them.  Thread t takes the points t + kThreads * j, j < m (a power of
// two: the cloud zero-padded to P = m * kThreads when n > kThreads), and
// np (P, at most kThreads) partial sums a column go to the warps.
struct Phase {
  int stride, n, m, np;
};

__device__ __forceinline__ Phase phase_of(int stride, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return {stride, n, max(1, p / kThreads), min(p, kThreads)};
}

// What one iteration's association and normal equations take.
struct Iter {
  Scene s;
  float T[16];
  bool near, color;
  float gate, sdiv, cs, pw, wc;
};

// Point e of candidate k's phase cloud: coordinates, validity and chroma.
__device__ __forceinline__ void load_point(const Params& P, int k, const Phase& ph, int e, bool color, float x[3],
                                           bool& val, float pch[2]) {
  const size_t i = (size_t)k * P.N + (size_t)e * ph.stride;
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = P.pts[3 * i + c];
  val = P.valid[i];
  if (color) {
    pch[0] = P.pchroma[2 * i];
    pch[1] = P.pchroma[2 * i + 1];
  }
}

// s1 = [w, p w] of one point.
__device__ __forceinline__ void s1_terms(const Pt& st, float v[4]) {
  v[0] = st.w;
#pragma unroll
  for (int c = 0; c < 3; ++c) v[1 + c] = mul_rn(st.p[c], st.w);
}

// The final fitness and rmse terms of one point (bilinear association):
// dist^2 of an inlier into v; returns whether it is one.
__device__ __forceinline__ bool final_term(const Iter& I, const float x[3], bool val, float corr, float& v) {
  float p[3], q[3], n[3];
  rigid(I.T, x, p);
  const bool ok = bilinear(I.s, p, q, n);
  const float dist = norm3(sub_rn(p[0], q[0]), sub_rn(p[1], q[1]), sub_rn(p[2], q[2]));
  const bool good = val && ok && q[2] > 0.0f && dist < corr;
  v = good ? mul_rn(dist, dist) : 0.0f;
  return good;
}

// A thread's points in registers (M of them, so N <= M * kThreads), with
// each point's terms kept between the two reductions.
template <int M>
struct RegCloud {
  static constexpr int kMinBlocks = M <= 2 ? 2 : 1;
  Phase ph;
  float x[M][3];
  bool val[M];
  float pch[M][2];
  Pt st[M];

  __device__ __forceinline__ bool has(int j) const { return j < ph.m && (int)threadIdx.x + kThreads * j < ph.n; }

  __device__ __forceinline__ void load(const Params& P, int k, const Phase& p, bool color) {
    ph = p;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (has(j)) load_point(P, k, ph, threadIdx.x + kThreads * j, color, x[j], val[j], pch[j]);
    }
  }

  __device__ __forceinline__ void s1(const Params&, const Iter& I, float out[4]) {
    float v[M][4];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (has(j)) {
        associate(I.s, I.T, x[j], val[j], pch[j], I.near, I.color, I.gate, I.sdiv, I.cs, st[j]);
        s1_terms(st[j], v[j]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[j][c] = 0.0f;
      }
    }
    tree_regs<M, 4>(v, ph.m);
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = v[0][c];
  }

  __device__ __forceinline__ void row(const Params&, const Iter& I, int r, const float c[3], float out[6]) {
    float v[M][6];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (has(j)) {
        normal_row(st[j], c, r, I.color, I.pw, I.wc, v[j]);
      } else {
#pragma unroll
        for (int q = 0; q < 6; ++q) v[j][q] = 0.0f;
      }
    }
    tree_regs<M, 6>(v, ph.m);
#pragma unroll
    for (int q = 0; q < 6; ++q) out[q] = v[0][q];
  }

  __device__ __forceinline__ void fin(const Params& P, const Iter& I, float& out, int& n_good, int& n_valid) {
    float v[M][1];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      v[j][0] = 0.0f;
      if (has(j)) {
        n_good += final_term(I, x[j], val[j], P.corr_dist, v[j][0]);
        n_valid += val[j];
      }
    }
    tree_regs<M, 1>(v, ph.m);
    out = v[0][0];
  }
};

// A thread's m values f(j), j < m, added in the tree's order without
// holding them: the stride tree over j is the pairwise tree over the values
// taken in bit-reversed order of j, added here as a binary counter (acc[l]
// holds the sum of the last 2^l values while bit l of the count is set).
// m is a power of two below 2^kLevels.
template <int C, class F>
__device__ __forceinline__ void tree_stream(int m, F f, float out[C]) {
  const int bits = 31 - __clz(m);
  float acc[kLevels][C] = {};
  for (int s = 0; s < m; ++s) {
    float x[C];
    f(bits ? (int)(__brev((unsigned)s) >> (32 - bits)) : 0, x);
    bool carry = true;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      if (carry) {
        if ((s >> l) & 1) {
#pragma unroll
          for (int c = 0; c < C; ++c) x[c] = add_rn(acc[l][c], x[c]);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[l][c] = x[c];
          carry = false;
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    if (l == bits) {
#pragma unroll
      for (int c = 0; c < C; ++c) out[c] = acc[l][c];
    }
  }
}

// A thread's points read from global memory as they are needed (any N):
// each point is associated again for every group of columns, and the
// values are added by tree_stream in the order RegCloud adds them.
struct StreamCloud {
  static constexpr int kMinBlocks = 1;
  Phase ph;
  int k;
  bool color;

  __device__ __forceinline__ void load(const Params&, int k_, const Phase& p, bool color_) {
    ph = p;
    k = k_;
    color = color_;
  }

  // Point j of this thread associated: false for the padding.
  __device__ __forceinline__ bool point(const Params& P, const Iter& I, int j, Pt& st) const {
    const int e = threadIdx.x + kThreads * j;
    if (e >= ph.n) return false;
    float x[3], pch[2];
    bool val;
    load_point(P, k, ph, e, color, x, val, pch);
    associate(I.s, I.T, x, val, pch, I.near, I.color, I.gate, I.sdiv, I.cs, st);
    return true;
  }

  __device__ __forceinline__ void s1(const Params& P, const Iter& I, float out[4]) {
    tree_stream<4>(ph.m, [&](int j, float v[4]) {
      Pt st;
      if (point(P, I, j, st)) {
        s1_terms(st, v);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = 0.0f;
      }
    }, out);
  }

  __device__ __forceinline__ void row(const Params& P, const Iter& I, int r, const float c[3], float out[6]) {
    tree_stream<6>(ph.m, [&](int j, float v[6]) {
      Pt st;
      if (point(P, I, j, st)) {
        normal_row(st, c, r, I.color, I.pw, I.wc, v);
      } else {
#pragma unroll
        for (int q = 0; q < 6; ++q) v[q] = 0.0f;
      }
    }, out);
  }

  __device__ __forceinline__ void fin(const Params& P, const Iter& I, float& out, int& n_good, int& n_valid) {
    float o[1];
    tree_stream<1>(ph.m, [&](int j, float v[1]) {
      const int e = threadIdx.x + kThreads * j;
      v[0] = 0.0f;
      if (e < ph.n) {
        float x[3], pch[2];
        bool val;
        load_point(P, k, ph, e, false, x, val, pch);
        n_good += final_term(I, x, val, P.corr_dist, v[0]);
        n_valid += val;
      }
    }, o);
    out = o[0];
  }
};

template <class Cloud>
__global__ void __launch_bounds__(kThreads, Cloud::kMinBlocks) icp_kernel(const Params P, const Schedule S) {
  __shared__ float buf[kCols * kThreads];
  __shared__ float s_sum[kCols];
  __shared__ float s_T[16];
  __shared__ int s_cnt[2];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int k = blockIdx.x;
  const bool color = P.chroma != nullptr;
  Iter I;
  I.s = Scene{P.packed, P.chroma, P.cam[0], P.cam[4], P.cam[2], P.cam[5], P.h, P.w};
  I.color = color;
  I.cs = P.chroma_scale;
  I.pw = P.point_weight;
  if (t < 16) s_T[t] = P.init_T[16 * k + t];
  if (t < 2) s_cnt[t] = 0;

  Cloud cl;
  const int n_coarse = (P.N + P.stride - 1) / P.stride;

  for (int it = 0; it < P.max_iters; ++it) {
    I.near = it < P.n_near;
    if (it == 0 || it == P.n_near) cl.load(P, k, I.near ? phase_of(P.stride, n_coarse) : phase_of(1, P.N), color);
    __syncthreads();  // s_T: the start pose, or the last iteration's
#pragma unroll
    for (int e = 0; e < 16; ++e) I.T[e] = s_T[e];
    I.gate = P.sched ? P.sched[it] : S.gate[it];
    I.wc = P.sched ? P.sched[P.max_iters + it] : S.w_col[it];
    I.sdiv = P.sched ? P.sched[2 * P.max_iters + it] : S.sdiv[it];
    const bool live = t < cl.ph.np;

    // Association, and the inlier count and centroid (s1 = [w, p w]).
    if (live) {
      float v[4];
      cl.s1(P, I, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) buf[c * kThreads + t] = v[c];
    }
    __syncthreads();
    if (warp < 4) {
      const float sum = warp_tree(buf + warp * kThreads, cl.ph.np);
      if (lane == 0) s_sum[warp] = sum;
    }
    __syncthreads();
    const float n_in = s_sum[0];
    const float den = clamp_min(n_in, 1.0f);
    const float c[3] = {div_rn(s_sum[1], den), div_rn(s_sum[2], den), div_rn(s_sum[3], den)};
    __syncthreads();  // s_sum is rewritten below

    // The normal equations, summed over the points (s2 = [H | g]).
    if (live) {
#pragma unroll
      for (int row = 0; row < 7; ++row) {
        float v[6];
        cl.row(P, I, row, c, v);
#pragma unroll
        for (int q = 0; q < 6; ++q) buf[(6 * row + q) * kThreads + t] = v[q];
      }
    }
    __syncthreads();
    for (int col = warp; col < kCols; col += kWarps) {
      const float sum = warp_tree(buf + col * kThreads, cl.ph.np);
      if (lane == 0) s_sum[col] = sum;
    }
    __syncthreads();
    if (t == 0) {
      update_pose(s_sum, c, n_in, P.lm_damping, I.T);
#pragma unroll
      for (int e = 0; e < 16; ++e) s_T[e] = I.T[e];
    }
  }

  // Final fitness and rmse: bilinear association of the full cloud.
  if (P.n_near == P.max_iters) cl.load(P, k, phase_of(1, P.N), false);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 16; ++e) I.T[e] = s_T[e];
  if (t < cl.ph.np) {
    float v;
    int n_good = 0, n_valid = 0;
    cl.fin(P, I, v, n_good, n_valid);
    buf[t] = v;
    if (n_good) atomicAdd(&s_cnt[0], n_good);
    if (n_valid) atomicAdd(&s_cnt[1], n_valid);
  }
  __syncthreads();
  if (warp == 0) {
    const float sum = warp_tree(buf, cl.ph.np);
    if (lane == 0) {
      const int ng = s_cnt[0];
      P.fitness[k] = div_rn((float)ng, (float)max(s_cnt[1], 1));
      P.rmse[k] = __fsqrt_rn(div_rn(sum, (float)max(ng, 1)));
    }
  }
  if (t < 16) P.T_out[16 * k + t] = I.T[t];
}

}  // namespace

// Launch on `stream`: one block a candidate.  The schedule (max_iters
// float32 gates, then as many colour weights, then as many colour
// divisors) comes as `sched` in host memory, copied into the launch
// arguments (max_iters <= kMaxIters), or as `sched_dev` on the device.
// `chroma` and `pchroma` are both null (no colour term) or both set.
// Returns cudaGetLastError() as an int (0 = success), or -1 for sizes the
// kernel does not take (ops/icp.py checks them first).
extern "C" int icp_launch(const void* packed, const void* chroma, const void* pts, const void* valid,
                          const void* pchroma, const void* cam, const void* init_T, void* T_out, void* fitness,
                          void* rmse, const float* sched, const void* sched_dev, int K, int N, int h, int w,
                          int max_iters, int n_near, int stride, float point_weight, float lm_damping,
                          float chroma_scale, float corr_dist, void* stream) {
  if (K <= 0) return 0;
  if (max_iters < 0 || (sched_dev == nullptr && max_iters > kMaxIters) || N < 0 ||
      N > (1 << (kLevels - 1)) * kThreads) {
    return -1;
  }
  Params P{(const float*)packed, (const float*)chroma, (const float*)pts, (const bool*)valid,
           (const float*)pchroma, (const float*)cam, (const float*)init_T, (float*)T_out, (float*)fitness,
           (float*)rmse, (const float*)sched_dev, N, h, w, max_iters, n_near, stride, point_weight, lm_damping,
           chroma_scale, corr_dist};
  Schedule S{};
  if (sched_dev == nullptr) {
    for (int i = 0; i < max_iters; ++i) {
      S.gate[i] = sched[i];
      S.w_col[i] = sched[max_iters + i];
      S.sdiv[i] = sched[2 * max_iters + i];
    }
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= kThreads) {
    icp_kernel<RegCloud<1>><<<K, kThreads, 0, st>>>(P, S);
  } else if (N <= 2 * kThreads) {
    icp_kernel<RegCloud<2>><<<K, kThreads, 0, st>>>(P, S);
  } else if (N <= 4 * kThreads) {
    icp_kernel<RegCloud<4>><<<K, kThreads, 0, st>>>(P, S);
  } else if (N <= 8 * kThreads) {
    icp_kernel<RegCloud<8>><<<K, kThreads, 0, st>>>(P, S);
  } else {
    icp_kernel<StreamCloud><<<K, kThreads, 0, st>>>(P, S);
  }
  return (int)cudaGetLastError();
}
