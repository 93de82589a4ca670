// RANSAC-PnP for every stream in two launches: hypotheses, then selection.
//
// Not a Pallas kernel. It replaces svo_tpu's plain-jnp PnP
// (svo_tpu/geometry/pnp.py::ransac_pnp), which the port first wrote as plain
// PyTorch (geometry/pnp.py::ransac_pnp_ref): there every scalar step of its
// small-matrix chains (the unrolled 12x12 Cholesky, 8 inverse iterations of
// two triangular solves, 8 Newton polar steps, each LO chain's 6x6 solves)
// is a kernel of its own, ~6,300 launches of a microsecond or two a frame
// step, for ~15 MFLOP and ~0.6 MB of work at 8 streams.
//
// What bounds it: neither bytes nor operations (both are well under a
// microsecond of the card) but the latency of a few sequential chains: a
// hypothesis's DLT (Cholesky, 16 triangular solves, 8 polar steps) and each
// LO chain (rounds x iterations of Gauss-Newton, each a sum over the points
// and a 6x6 solve). So the design aims for the shortest chain:
// - launch 1, grid (warps / 2, S), 2 warps a block, one warp a task. A
//   task is a hypothesis (Gumbel top-6 by 6 warp arg-max rounds, the DLT,
//   its MSAC score), a prior pose's MSAC score, or an LO chain from a prior
//   (strict, or annealed by lo_anneal): the prior chains do not depend on
//   the hypotheses, so they run beside them;
// - launch 2, one warp a stream: the first-index arg-min of the scores,
//   the LO chain from the winner, the strict-consensus comparison, the
//   rescue rule, inlier_ratio, ok and T_wc = inverse(T_final).
// Up to N = 128 slots (the narrow path) a lane holds 4 of the stream's
// slots and their residuals in registers; past 128, up to 2,048 (the wide
// path, below), a point is read where it is needed and the sums over the
// points follow the plain path's split at that N. The small
// dense algebra (12x12 and 6x6 Cholesky and solves, polar, the se(3)
// exponential, 4x4 products) runs in every lane of the warp on the same
// values, in registers: no exchange, and every lane ends with the same
// bits. A^T A and each Gauss-Newton sum are spread over the lanes through
// shared memory.
//
// Bit-equal to the plain path on the card at N = 128 slots (the narrow
// path) and at N = 256, 1,024 and 2,048 (the wide path). The plain path is a chain of tensor ops,
// each rounding once, and the kernel repeats each op's arithmetic in its
// order (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn: nothing contracted).
// The orders were read off the card (PyTorch 2.11, CUDA 12.8, H100) by
// holding each op of the plain path against candidate orders on its own
// inputs. Below 128 the plain path's cuBLAS kernels and reduction configs
// change with N; the narrow path keeps N = 128's orders and agrees with it
// to rounding. The orders:
// - a product with more than one output column (cuBLAS gemm): a fused
//   multiply-add chain in k order (dot_chain), except for a single 3x3 or
//   4x4 product (S = 1: the se(3) exponential's W W, the pose update E T,
//   the final inverse), which is two halves (dot_halves);
// - a matrix-vector product (a bmm with one column: the Cholesky's einsum,
//   the cheirality depths, V v, J^T r): two halves of k, each a chain, then
//   added (dot_halves); the 6x6 Cholesky's einsum of a single stream (S = 1,
//   cuBLAS's gemv) a chain of roundings (dot_gemv);
// - a division by a Python number: a product by its float32 reciprocal
//   (PyTorch's scalar division), by a tensor: a true division;
// - a sum over a contiguous last axis of n < 128 elements (tsum, warp_sum):
//   32 threads, thread t adding elements t, t + 32, ... into four
//   accumulators from 0, then a shuffle tree of offsets 16, 8, 4, 2, 1; of
//   128 elements (warp_sum): thread t's four accumulators take elements
//   4t .. 4t + 3 (vectorised loads), then the same tree;
// - a Gauss-Newton sum over the points (dim -3; column_sum): BH threads a
//   column, thread y adding points y, y + BH, ... into four accumulators,
//   then a tree of offsets BH / 2 .. 1; BH is what PyTorch's reduction
//   config picks for S streams (geometry/pnp.py::gn_split), 1 for a single
//   stream.
// Ties and NaNs go as torch.sort (stable, descending: NaN first, the lower
// index first) and torch.argmin (NaN first, the first index) take them.
// There are no atomics: two launches on the same inputs give the same bits.
// A stream's result does not depend on the others' data; like the plain
// path's, its Gauss-Newton sums and single-stream products follow S.
//
// Launches on the caller's stream, allocates nothing, does not
// synchronise; the caller allocates the outputs and the scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSL = 4;             // slots a lane
constexpr int kMaxN = 32 * kSL;    // slots a stream of the narrow path
constexpr int kMaxWideN = 2048;    // slots a stream of the wide path
constexpr int kMaxParts = 128;     // threads of a wide Gauss-Newton sum (bh x ctas)
constexpr int kWarps = 2;          // warps a block of launch 1
constexpr int kMaxSchedule = 8;    // LO rounds a chain, at most
constexpr int kNC = 27;            // GN terms a point: H's 21 lower entries, g's 6
constexpr int kDltSmem = 144 + 78;  // floats of the DLT's A and A^T A
constexpr int kHyp = 17;           // a scored pose: 16 entries, the MSAC score
constexpr int kChain = 18;         // an LO chain's result: pose, strict count, score

struct Args {
  const float* K;          // (3, 3)
  const float* Xw;         // (S, N, 3)
  const float* uv;         // (S, N, 2)
  const uint8_t* valid;    // (S, N) bool
  const float* noise;      // (S, H, N)
  const float* T_init;     // (S, P, 4, 4) or null (P = 0)
  int S, N, H, P, iters, n_strict, n_anneal;
  int single;              // S == 1: the single-matrix products' orders
  int bh_H, bh_g;          // threads a Gauss-Newton sum of H, of g
  int ct_H, ct_g;          // N > 128: blocks a Gauss-Newton sum of H, of g
  int bw_h, bw_s;          // N > 128: threads of a hypothesis's MSAC sum, of a chain's
  float strict[kMaxSchedule];  // inlier gates of each LO round, squared px
  float anneal[kMaxSchedule];
  float thr2;              // the strict gate and the MSAC clamp
  float margin;            // rescue_margin
  float* hyp;              // (S, H + P, kHyp)
  float* chain;            // (S, 2P + 1, kChain): prior i strict 2i, annealed
                           // 2i + 1, the winner's 2P
  uint8_t* cmask;          // (S, 2P + 1, N): each chain's strict inliers
  int* best;               // (S,) the MSAC winner
  int* idx;                // (S, H, 6) the hypotheses' index sets
  float* T_wc;             // (S, 4, 4)
  uint8_t* inliers;        // (S, N) bool
  float* ratio;            // (S,)
  uint8_t* ok;             // (S,) bool
};

// ---- one rounding per tensor op -------------------------------------------

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ float sqr(float a) { return __fsqrt_rn(a); }

// torch.clamp(x, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
// torch.where(|x| < eps, eps, x)
__device__ __forceinline__ float away(float x, float eps) { return fabsf(x) < eps ? eps : x; }

// lower-packed index of (i, j), j <= i
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// shared floats of a warp: every point's Gauss-Newton terms and their 32
// sums, or the DLT's A and A^T A
__host__ __device__ constexpr int warp_floats(int N) {
  return N * kNC + 32 > kDltSmem ? N * kNC + 32 : kDltSmem;
}

__host__ __device__ constexpr int last_pow2(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

// torch.sum over a contiguous last axis of n < 128 elements x[0..n-1]: as
// 32 threads with 0 past n; the threads past last_pow2(n) only add zeros
template <int n>
__device__ __forceinline__ float tsum(const float* x) {
  static_assert(n >= 1 && n < 128, "tsum takes 1 to 127 elements");
  constexpr int bw = last_pow2(n) < 32 ? last_pow2(n) : 32;
  float v[bw];
#pragma unroll
  for (int t = 0; t < bw; ++t) {
    float vl[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) vl[m] = t + bw * m < n ? add(0.0f, x[t + bw * m]) : 0.0f;
    v[t] = add(add(add(vl[0], vl[1]), vl[2]), vl[3]);
  }
#pragma unroll
  for (int o = bw / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int t = 0; t < o; ++t) v[t] = add(v[t], v[t + o]);
  }
  return v[0];
}

// Slot j of a lane: when N is 128, where the sum over the slots is
// vectorised by 4, slots 4 lane .. 4 lane + 3, else lane + 32 j.
__device__ __forceinline__ int slot(int lane, int j, bool vec) {
  return vec ? 4 * lane + j : lane + 32 * j;
}

// torch.sum over the N slots of a warp (x[j] is the lane's slot j, 0 past
// N), every lane getting the total: the lane is the reduction's thread
// (with 4 contiguous slots, or slots t, t + 32, ...); a butterfly gives
// each lane the pairs the shuffle tree forms (a + b = b + a).
__device__ __forceinline__ float warp_sum(const float* x, int N, bool vec, int lane) {
  float vl[kSL] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    if (slot(lane, j, vec) < N) vl[j] = add(vl[j], x[j]);
  }
  float v = add(add(add(vl[0], vl[1]), vl[2]), vl[3]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_count(unsigned bits) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < kSL; ++j) c += __popc(__ballot_sync(kFull, (bits >> j) & 1u));
  return c;
}

// ---- dot products in cuBLAS's orders ---------------------------------------

template <int FROM, int TO>
__device__ __forceinline__ float dot_chain(const float* a, const float* b) {
  float acc = mul(a[FROM], b[FROM]);
#pragma unroll
  for (int k = FROM + 1; k < TO; ++k) acc = fma_(a[k], b[k], acc);
  return acc;
}

template <int K>
__device__ __forceinline__ float dot_halves(const float* a, const float* b) {
  constexpr int h = (K + 1) / 2;
  if constexpr (K > h) {
    return add(dot_chain<0, h>(a, b), dot_chain<h, K>(a, b));
  } else {
    return dot_chain<0, h>(a, b);
  }
}

template <int K>
__device__ __forceinline__ float dot_gemv(const float* a, const float* b) {
  static_assert(K <= 4, "the single-stream einsum has at most 4 terms");
  if constexpr (K == 3) {
    return dot_halves<3>(a, b);
  } else {
    float acc = mul(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < K; ++k) acc = add(acc, mul(a[k], b[k]));
    return acc;
  }
}

// C = A @ B for n x n row-major: a chain, or two halves for one matrix
template <int n>
__device__ __forceinline__ void matmul(const float* A, const float* B, float* C, bool single) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float a[n], b[n];
#pragma unroll
      for (int k = 0; k < n; ++k) {
        a[k] = A[n * i + k];
        b[k] = B[n * k + j];
      }
      C[n * i + j] = single ? dot_halves<n>(a, b) : dot_chain<0, n>(a, b);
    }
  }
}

// ---- small dense algebra, the same in every lane ---------------------------

// linalg.cholesky_unrolled of B = M + c I (M lower-packed in shared memory;
// off the diagonal M + c * 0, as the plain path adds c * eye)
template <int n, bool GEMV, int j = 0>
__device__ __forceinline__ void chol(const float* M, float c, float cz, float* L) {
  if constexpr (j < n) {
    float s = add(M[tri(j, j)], c);
    if constexpr (j > 0) {
      float sq[j];
#pragma unroll
      for (int k = 0; k < j; ++k) sq[k] = mul(L[tri(j, k)], L[tri(j, k)]);
      s = sub(s, tsum<j>(sq));
    }
    const float d = sqr(clamp_min(s, 1e-20f));
    L[tri(j, j)] = d;
    if constexpr (j + 1 < n) {
#pragma unroll
      for (int i = j + 1; i < n; ++i) {
        float r = add(M[tri(i, j)], cz);
        if constexpr (j > 0) {  // einsum("...ik,...k->...i", L[j+1:, :j], L[j, :j])
          float a[j], b[j];
#pragma unroll
          for (int k = 0; k < j; ++k) {
            a[k] = L[tri(i, k)];
            b[k] = L[tri(j, k)];
          }
          if constexpr (GEMV) {
            r = sub(r, dot_gemv<j>(a, b));
          } else {
            r = sub(r, dot_halves<j>(a, b));
          }
        }
        L[tri(i, j)] = dvd(r, d);
      }
    }
    chol<n, GEMV, j + 1>(M, c, cz, L);
  }
}

// linalg.cho_solve_unrolled: forward L y = b, then backward L^T x = y
template <int n, int i = 0>
__device__ __forceinline__ void forward(const float* L, const float* b, float* y) {
  if constexpr (i < n) {
    float s = b[i];
    if constexpr (i > 0) {
      float pr[i];
#pragma unroll
      for (int k = 0; k < i; ++k) pr[k] = mul(L[tri(i, k)], y[k]);
      s = sub(s, tsum<i>(pr));
    }
    y[i] = dvd(s, L[tri(i, i)]);
    forward<n, i + 1>(L, b, y);
  }
}

template <int n, int i = n - 1>
__device__ __forceinline__ void backward(const float* L, const float* y, float* x) {
  if constexpr (i >= 0) {
    float s = y[i];
    if constexpr (i + 1 < n) {
      float pr[n - 1 - i];
#pragma unroll
      for (int k = 0; k < n - 1 - i; ++k) pr[k] = mul(L[tri(i + 1 + k, i)], x[i + 1 + k]);
      s = sub(s, tsum<n - 1 - i>(pr));
    }
    x[i] = dvd(s, L[tri(i, i)]);
    backward<n, i - 1>(L, y, x);
  }
}

__device__ __forceinline__ bool finite16(const float* T) {
  bool f = true;
#pragma unroll
  for (int k = 0; k < 16; ++k) f = f && isfinite(T[k]);
  return f;
}

// linalg.polar3x3: 8 scaled Newton steps X <- 0.5 (X s + X^-T / s)
__device__ void polar(const float* M, float* X) {
  {
    const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5], g = M[6],
                h = M[7], i = M[8];
    const float det = add(sub(mul(a, sub(mul(e, i), mul(f, h))), mul(b, sub(mul(d, i), mul(f, g)))),
                          mul(c, sub(mul(d, h), mul(e, g))));
    const float sgn = det < 0.0f ? -1.0f : 1.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) X[k] = mul(M[k], sgn);
  }
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    const float a = X[0], b = X[1], c = X[2], d = X[3], e = X[4], f = X[5], g = X[6],
                h = X[7], i = X[8];
    float adj[9];  // inv3x3's adjugate, row-major
    adj[0] = sub(mul(e, i), mul(f, h));
    adj[1] = sub(mul(c, h), mul(b, i));
    adj[2] = sub(mul(b, f), mul(c, e));
    adj[3] = sub(mul(f, g), mul(d, i));
    adj[4] = sub(mul(a, i), mul(c, g));
    adj[5] = sub(mul(c, d), mul(a, f));
    adj[6] = sub(mul(d, h), mul(e, g));
    adj[7] = sub(mul(b, g), mul(a, h));
    adj[8] = sub(mul(a, e), mul(b, d));
    const float det = add(add(mul(a, adj[0]), mul(b, adj[3])), mul(c, adj[6]));
    const float inv_det = dvd(1.0f, away(det, 1e-12f));
    float inv[9], sq[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) inv[k] = mul(adj[k], inv_det);
#pragma unroll
    for (int k = 0; k < 9; ++k) sq[k] = mul(X[k], X[k]);
    const float nx = sqr(add(tsum<9>(sq), 1e-20f));
    // X^-T * X^-T keeps the transposed layout: summed in inv's memory order
#pragma unroll
    for (int k = 0; k < 9; ++k) sq[k] = mul(inv[k], inv[k]);
    const float ni = sqr(add(tsum<9>(sq), 1e-20f));
    const float s = sqr(dvd(ni, nx));
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        X[3 * r + q] = mul(0.5f, add(mul(X[3 * r + q], s), dvd(inv[3 * q + r], s)));
      }
    }
  }
}

// ---- the camera, a stream's points ------------------------------------------

struct Cam {
  float fx, fy, cx, cy;
};

__device__ __forceinline__ Cam load_cam(const float* K) {
  return Cam{K[0], K[4], K[2], K[5]};
}

struct Pts {
  float X[kSL], Y[kSL], Z[kSL], u[kSL], v[kSL];
  unsigned valid;  // bit j: the lane's slot j
  bool vec;        // the slot layout (slot())
};

__device__ __forceinline__ void load_pts(const Args& a, int s, int lane, Pts& p) {
  p.valid = 0u;
  p.vec = a.N % 128 == 0;
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    const int n = slot(lane, j, p.vec);
    if (n < a.N) {
      const size_t o = static_cast<size_t>(s) * a.N + n;
      p.X[j] = a.Xw[3 * o];
      p.Y[j] = a.Xw[3 * o + 1];
      p.Z[j] = a.Xw[3 * o + 2];
      p.u[j] = a.uv[2 * o];
      p.v[j] = a.uv[2 * o + 1];
      p.valid |= (a.valid[o] ? 1u : 0u) << j;
    } else {
      p.X[j] = p.Y[j] = p.Z[j] = p.u[j] = p.v[j] = 0.0f;
    }
  }
}

// X @ R^T + t of one point under a 4x4 pose
__device__ __forceinline__ void transform(const float* T, float X, float Y, float Z, float* Xc) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Xc[i] = add(fma_(Z, T[4 * i + 2], fma_(Y, T[4 * i + 1], mul(X, T[4 * i]))), T[4 * i + 3]);
  }
}

// _reproj_errors of one point: the squared pixel error and the depth
__device__ __forceinline__ float reproj(const Cam& c, const float* T, const Pts& p, int j,
                                        float& z) {
  float Xc[3];
  transform(T, p.X[j], p.Y[j], p.Z[j], Xc);
  z = Xc[2];
  const float zs = away(z, 1e-9f);
  const float du = sub(add(dvd(mul(c.fx, Xc[0]), zs), c.cx), p.u[j]);
  const float dv = sub(add(dvd(mul(c.fy, Xc[1]), zs), c.cy), p.v[j]);
  return add(mul(du, du), mul(dv, dv));
}

// inliers at `gate` ((err2 < gate) & (z > 0) & valid) as slot bits, and the
// MSAC score sum(where(valid, where(z > 0, clamp(err2, max=thr2), thr2), 0))
__device__ __forceinline__ unsigned consensus(const Cam& c, const float* T, const Pts& p,
                                              float gate, float thr2, int N, int lane,
                                              float* score) {
  unsigned in = 0u;
  float res[kSL];
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    res[j] = 0.0f;
    if (slot(lane, j, p.vec) >= N) continue;
    float z;
    const float e2 = reproj(c, T, p, j, z);
    const bool val = (p.valid >> j) & 1u;
    in |= ((e2 < gate) && (z > 0.0f) && val ? 1u : 0u) << j;
    const float r2 = z > 0.0f ? (isnan(e2) ? e2 : fminf(e2, thr2)) : thr2;
    res[j] = val ? r2 : 0.0f;
  }
  if (score != nullptr) *score = warp_sum(res, N, p.vec, lane);
  return in;
}

// ---- Gauss-Newton on se(3), the LO chain ------------------------------------

// se3.exp of the twist [v, w] into a 4x4 pose
__device__ void se3_exp(const float* xi, float* E, bool single) {
  const float* v = xi;
  const float* w = xi + 3;
  const float ww[3] = {mul(w[0], w[0]), mul(w[1], w[1]), mul(w[2], w[2])};
  const float theta2 = tsum<3>(ww);
  const bool small = theta2 < 1e-8f;
  const float theta = sqr(add(theta2, 1e-8f));
  const float A = small ? sub(1.0f, mul(theta2, 1.0f / 6.0f)) : dvd(sinf(theta), theta);
  const float B = small ? sub(0.5f, mul(theta2, 1.0f / 24.0f))
                        : dvd(sub(1.0f, cosf(theta)), theta2);
  const float C = small ? sub(1.0f / 6.0f, mul(theta2, 1.0f / 120.0f))
                        : dvd(sub(1.0f, A), theta2);
  const float W[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
  float WW[9];
  matmul<3>(W, W, WW, single);
  float V[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float I = r == q ? 1.0f : 0.0f;
      E[4 * r + q] = add(add(I, mul(A, W[3 * r + q])), mul(B, WW[3 * r + q]));
      V[3 * r + q] = add(add(I, mul(B, W[3 * r + q])), mul(C, WW[3 * r + q]));
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) E[4 * r + 3] = dot_halves<3>(V + 3 * r, v);
  E[12] = 0.0f;
  E[13] = 0.0f;
  E[14] = 0.0f;
  E[15] = 1.0f;
}

// One column of a Gauss-Newton sum over the points (col[n * kNC] is point
// n's term): BH threads, thread y adding points y, y + BH, ... into four
// accumulators, then the tree of offsets BH / 2, ..., 1 (BH <= 8 at N <=
// 128), unrolled, every load in flight at once.
template <int BH>
__device__ __forceinline__ float column_sum_unrolled(const float* col, int N) {
  float acc[BH][4];
#pragma unroll
  for (int y = 0; y < BH; ++y) {
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[y][m] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < 128; ++n) {
    if (n < N) acc[n % BH][(n / BH) % 4] = add(acc[n % BH][(n / BH) % 4], col[n * kNC]);
  }
  float part[BH];
#pragma unroll
  for (int y = 0; y < BH; ++y) part[y] = add(add(add(acc[y][0], acc[y][1]), acc[y][2]), acc[y][3]);
#pragma unroll
  for (int o = BH / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int y = 0; y < o; ++y) part[y] = add(part[y], part[y + o]);
  }
  return part[0];
}

__device__ __forceinline__ float column_sum(const float* col, int N, int bh) {
  switch (bh) {
    case 2: return column_sum_unrolled<2>(col, N);
    case 4: return column_sum_unrolled<4>(col, N);
    case 8: return column_sum_unrolled<8>(col, N);
    default: return column_sum_unrolled<1>(col, N);
  }
}

__device__ void gn_solve(const Args& a, const float* tot, float* T);

// One masked Gauss-Newton step of _gn_refine: each lane writes its points'
// 27 terms of J^T (J w) and J^T (r w) to shared memory, lane q < 27 sums
// term q over the points, then every lane solves and updates T.
__device__ void gn_step(const Args& a, const Cam& c, const Pts& p, float* T, unsigned sel,
                        float* sm, int lane) {
  const float nfx = -c.fx, nfy = -c.fy;
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    const int n = slot(lane, j, p.vec);
    if (n >= a.N) continue;
    float Xc[3];
    transform(T, p.X[j], p.Y[j], p.Z[j], Xc);
    const float x = Xc[0], y = Xc[1], z = Xc[2];
    const float inv_z = dvd(1.0f, away(z, 1e-9f));
    const float r0 = sub(add(mul(mul(c.fx, x), inv_z), c.cx), p.u[j]);
    const float r1 = sub(add(mul(mul(c.fy, y), inv_z), c.cy), p.v[j]);
    const float zero = 0.0f;
    const float Jpi[2][3] = {
        {mul(c.fx, inv_z), zero, mul(mul(mul(nfx, x), inv_z), inv_z)},
        {zero, mul(c.fy, inv_z), mul(mul(mul(nfy, y), inv_z), inv_z)}};
    // [I | -hat(Xc)]
    const float Jx[3][6] = {{1.0f, 0.0f, 0.0f, -zero, z, -y},
                            {0.0f, 1.0f, 0.0f, -z, -zero, x},
                            {0.0f, 0.0f, 1.0f, y, -x, -zero}};
    const float w = (sel >> j) & 1u ? 1.0f : 0.0f;
    float J[2][6], Jw[2][6];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        J[r][q] = fma_(Jpi[r][2], Jx[2][q], fma_(Jpi[r][1], Jx[1][q], mul(Jpi[r][0], Jx[0][q])));
        Jw[r][q] = mul(J[r][q], w);
      }
    }
    const float rw0 = mul(r0, w), rw1 = mul(r1, w);
    float* row = sm + n * kNC;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) {
        row[tri(i, k)] = fma_(J[1][i], Jw[1][k], mul(J[0][i], Jw[0][k]));
      }
      row[21 + i] = add(mul(J[0][i], rw0), mul(J[1][i], rw1));
    }
  }
  __syncwarp();
  float* tot = sm + a.N * kNC;
  if (lane < kNC) tot[lane] = column_sum(sm + lane, a.N, lane < 21 ? a.bh_H : a.bh_g);
  __syncwarp();
  gn_solve(a, tot, T);
}

// The rest of a Gauss-Newton step from the sums tot (H's 21 lower entries,
// then g's 6), in every lane: H = sum + 1e-6 I; delta = -H^-1 g, zeroed
// unless finite; T <- exp(delta) T.
__device__ void gn_solve(const Args& a, const float* tot, float* T) {
  float L[21], g[6], y[6], x[6];
  if (a.single) {
    chol<6, true>(tot, 1e-6f, 0.0f, L);
  } else {
    chol<6, false>(tot, 1e-6f, 0.0f, L);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = tot[21 + i];
  __syncwarp();
  forward<6>(L, g, y);
  backward<6>(L, y, x);
  bool fin = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    x[i] = -x[i];
    fin = fin && isfinite(x[i]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = fin ? x[i] : 0.0f;
  float E[16], Tn[16];
  se3_exp(x, E, a.single);
  matmul<4>(E, T, Tn, a.single);  // se3.compose(exp(delta), T)
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = Tn[k];
}

// lo_from: each round selects inliers at its gate, then refines
__device__ void lo_chain(const Args& a, const Cam& c, const Pts& p, float* T, const float* gates,
                         int rounds, float* sm, int lane) {
  for (int r = 0; r < rounds; ++r) {
    const unsigned sel = consensus(c, T, p, gates[r], a.thr2, a.N, lane, nullptr);
    for (int it = 0; it < a.iters; ++it) gn_step(a, c, p, T, sel, sm, lane);
  }
}

// ---- launch 1: hypotheses and the chains from the priors ---------------------

// torch.sort(descending, stable): does (a, ia) come before (b, ib)?
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// The first 6 of a stable descending sort of where(valid, noise, -inf)
__device__ void top6(const float* noise, const Pts& p, int N, int lane, int* idx) {
  float key[kSL];
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    const int n = slot(lane, j, p.vec);
    key[j] = n < N ? ((p.valid >> j) & 1u ? noise[n] : -INFINITY) : 0.0f;
  }
  unsigned taken = 0u;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float bv = 0.0f;
    int bi = -1;
#pragma unroll
    for (int j = 0; j < kSL; ++j) {
      const int n = slot(lane, j, p.vec);
      if (n < N && !((taken >> j) & 1u) && (bi < 0 || before(key[j], n, bv, bi))) {
        bv = key[j];
        bi = n;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (oi >= 0 && (bi < 0 || before(ov, oi, bv, bi))) {
        bv = ov;
        bi = oi;
      }
    }
    idx[r] = bi;
#pragma unroll
    for (int j = 0; j < kSL; ++j) {
      if (slot(lane, j, p.vec) == bi) taken |= 1u << j;
    }
  }
}

// _dlt6 of the 6 points idx: the row-normalised 12x12 system, A^T A
// spread over the lanes, then in every lane the shifted Cholesky, 8
// inverse iterations, the cheirality flip, polar and scale.
__device__ void dlt(const Args& a, const Cam& c, int s, const int* idx, float* sm, int lane,
                    float* T) {
  float X[6], Y[6], Z[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const size_t o = static_cast<size_t>(s) * a.N + idx[k];
    X[k] = a.Xw[3 * o];
    Y[k] = a.Xw[3 * o + 1];
    Z[k] = a.Xw[3 * o + 2];
  }
  float* As = sm;         // (12, 12)
  float* Ms = sm + 144;   // A^T A, lower-packed
  if (lane < 12) {
    const int k = lane < 6 ? lane : lane - 6;
    int n = idx[0];
#pragma unroll
    for (int q = 1; q < 6; ++q) n = k == q ? idx[q] : n;
    const size_t o = static_cast<size_t>(s) * a.N + n;
    const float Xh[4] = {a.Xw[3 * o], a.Xw[3 * o + 1], a.Xw[3 * o + 2], 1.0f};
    // _normalize_pixels, then -xn * Xh
    const float m = lane < 6 ? -dvd(sub(a.uv[2 * o], c.cx), c.fx)
                             : -dvd(sub(a.uv[2 * o + 1], c.cy), c.fy);
    float e[12];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      e[q] = lane < 6 ? Xh[q] : 0.0f;
      e[4 + q] = lane < 6 ? 0.0f : Xh[q];
      e[8 + q] = mul(m, Xh[q]);
    }
    float sq[12];
#pragma unroll
    for (int q = 0; q < 12; ++q) sq[q] = mul(e[q], e[q]);
    const float den = add(sqr(tsum<12>(sq)), 1e-12f);
#pragma unroll
    for (int q = 0; q < 12; ++q) As[12 * lane + q] = dvd(e[q], den);
  }
  __syncwarp();
  for (int q = lane; q < 78; q += 32) {
    int i = 0;
    while (tri(i + 1, 0) <= q) ++i;
    const int j = q - tri(i, 0);
    float acc = mul(As[i], As[j]);
#pragma unroll
    for (int k = 1; k < 12; ++k) acc = fma_(As[12 * k + i], As[12 * k + j], acc);
    Ms[q] = acc;
  }
  __syncwarp();
  // smallest_eigvec_psd: B = A + (1e-6 tr / 12 + 1e-12) I
  float diag[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) diag[q] = Ms[tri(q, q)];
  const float tr = mul(tsum<12>(diag), 1.0f / 12.0f);
  const float shift = add(mul(1e-6f, tr), 1e-12f);
  float L[78];
  chol<12, false>(Ms, shift, mul(shift, 0.0f), L);
  __syncwarp();  // Ms is read; the scratch is free again
  float x[12], y[12], z[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) x[q] = 1.0f;
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    forward<12>(L, x, y);
    backward<12>(L, y, z);
    float sq[12];
#pragma unroll
    for (int q = 0; q < 12; ++q) sq[q] = mul(z[q], z[q]);
    const float den = add(sqr(tsum<12>(sq)), 1e-20f);
#pragma unroll
    for (int q = 0; q < 12; ++q) x[q] = dvd(z[q], den);
  }
  // P = p.reshape(3, 4); cheirality from the sample points' depths
  int sgn = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float xh[4] = {X[k], Y[k], Z[k], 1.0f};
    const float d = dot_halves<4>(xh, x + 8);
    sgn += (0.0f < d) - (d < 0.0f);
  }
  const float flip = sgn < 0 ? -1.0f : 1.0f;
  float P[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) P[q] = mul(x[q], flip);
  float M[9], R[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) M[3 * r + q] = P[4 * r + q];
  }
  polar(M, R);
  float rm[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) rm[q] = mul(R[q], M[q]);
  const float scale = away(mul(tsum<9>(rm), 1.0f / 3.0f), 1e-12f);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) T[4 * r + q] = R[3 * r + q];
    T[4 * r + 3] = dvd(P[4 * r + 3], scale);
  }
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

// a chain's result: its pose, strict inlier count and score, and mask
__device__ void store_chain(const Args& a, const Cam& c, const Pts& p, int s, int at,
                            const float* T, int lane) {
  float score;
  const unsigned in = consensus(c, T, p, a.thr2, a.thr2, a.N, lane, &score);
  const int cnt = warp_count(in);
  const size_t o = static_cast<size_t>(s) * (2 * a.P + 1) + at;
  if (lane == 0) {
    float* dst = a.chain + o * kChain;
#pragma unroll
    for (int k = 0; k < 16; ++k) dst[k] = T[k];
    dst[16] = static_cast<float>(cnt);
    dst[17] = score;
  }
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    const int n = slot(lane, j, p.vec);
    if (n < a.N) a.cmask[o * a.N + n] = (in >> j) & 1u;
  }
}

__global__ void __launch_bounds__(kWarps * 32) pnp_hypotheses_kernel(const Args a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.y;
  const int w = blockIdx.x * kWarps + warp;
  const int n_chain = 2 * a.P;
  if (w >= n_chain + a.H + a.P) return;
  const Cam c = load_cam(a.K);
  Pts p;
  load_pts(a, s, lane, p);
  float* sm = smem + warp * warp_floats(a.N);
  float T[16];
  if (w < n_chain) {  // lo_from(T_init[i], strict or annealed)
    const float* T0 = a.T_init + (static_cast<size_t>(s) * a.P + (w >> 1)) * 16;
#pragma unroll
    for (int k = 0; k < 16; ++k) T[k] = T0[k];
    const bool annealed = w & 1;
    lo_chain(a, c, p, T, annealed ? a.anneal : a.strict, annealed ? a.n_anneal : a.n_strict,
             sm, lane);
    store_chain(a, c, p, s, w, T, lane);
    return;
  }
  const int h = w - n_chain;
  if (h < a.H) {
    int idx[6];
    top6(a.noise + (static_cast<size_t>(s) * a.H + h) * a.N, p, a.N, lane, idx);
    if (lane < 6) {
      int mine = idx[0];
#pragma unroll
      for (int q = 1; q < 6; ++q) mine = lane == q ? idx[q] : mine;
      a.idx[(static_cast<size_t>(s) * a.H + h) * 6 + lane] = mine;
    }
    dlt(a, c, s, idx, sm, lane, T);
  } else {
    const float* T0 = a.T_init + (static_cast<size_t>(s) * a.P + (h - a.H)) * 16;
#pragma unroll
    for (int k = 0; k < 16; ++k) T[k] = T0[k];
  }
  float score;
  consensus(c, T, p, a.thr2, a.thr2, a.N, lane, &score);
  if (lane == 0) {
    float* dst = a.hyp + (static_cast<size_t>(s) * (a.H + a.P) + h) * kHyp;
#pragma unroll
    for (int k = 0; k < 16; ++k) dst[k] = T[k];
    dst[16] = finite16(T) ? score : INFINITY;
  }
}

// ---- launch 2: the winner's chain and the choice -----------------------------

// torch.argmin: does (a, ia) come before (b, ib)?
__device__ __forceinline__ bool less_or_nan(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a < b;
}

__global__ void __launch_bounds__(32) pnp_select_kernel(const Args a) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x;
  const int s = blockIdx.x;
  const int n_hyp = a.H + a.P;
  const Cam c = load_cam(a.K);
  Pts p;
  load_pts(a, s, lane, p);
  const float* hyp = a.hyp + static_cast<size_t>(s) * n_hyp * kHyp;
  // best = argmin(msac)
  float bv = 0.0f;
  int bi = -1;
  for (int h = lane; h < n_hyp; h += 32) {
    const float v = hyp[h * kHyp + 16];
    if (bi < 0 || less_or_nan(v, h, bv, bi)) {
      bv = v;
      bi = h;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (oi >= 0 && (bi < 0 || less_or_nan(ov, oi, bv, bi))) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) a.best[s] = bi;
  float Tb[16], Tw[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) Tb[k] = Tw[k] = hyp[bi * kHyp + k];
  // finals[0]: the winner as it is, with its strict consensus
  float score;
  const unsigned in0 = consensus(c, Tb, p, a.thr2, a.thr2, a.N, lane, &score);
  int count = warp_count(in0);
  // finals[1]: the LO chain from the winner
  lo_chain(a, c, p, Tw, a.strict, a.n_strict, sm, lane);
  float score_w;
  const unsigned in_w = consensus(c, Tw, p, a.thr2, a.thr2, a.N, lane, &score_w);
  const int count_w = warp_count(in_w);
  const size_t base = static_cast<size_t>(s) * (2 * a.P + 1);
  if (lane == 0) {
    float* dst = a.chain + (base + 2 * a.P) * kChain;
#pragma unroll
    for (int k = 0; k < 16; ++k) dst[k] = Tw[k];
    dst[16] = static_cast<float>(count_w);
    dst[17] = score_w;
  }
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    const int n = slot(lane, j, p.vec);
    if (n < a.N) a.cmask[(base + 2 * a.P) * a.N + n] = (in_w >> j) & 1u;
  }
  // the strict consensus decides among finals; -1: the winner as it is
  float Tf[16];
  int from = -1;
  const bool take_w = finite16(Tw) && (count_w > count || (count_w == count && score_w < score));
#pragma unroll
  for (int k = 0; k < 16; ++k) Tf[k] = take_w ? Tw[k] : Tb[k];
  if (take_w) {
    from = 2 * a.P;
    count = count_w;
    score = score_w;
  }
  float Tc[16];
  for (int i = 0; i < 2 * a.P; ++i) {  // the strict chains from the priors, then the rescues
    const bool rescue = i >= a.P;
    const int at = rescue ? 2 * (i - a.P) + 1 : 2 * i;
    const float* r = a.chain + (base + at) * kChain;
    const int cnt = static_cast<int>(r[16]);
#pragma unroll
    for (int k = 0; k < 16; ++k) Tc[k] = r[k];
    const bool better =
        finite16(Tc) &&
        (rescue ? static_cast<float>(cnt) >= add(mul(a.margin, static_cast<float>(count)), 2.0f)
                : cnt > count || (cnt == count && r[17] < score));
    if (better) {
#pragma unroll
      for (int k = 0; k < 16; ++k) Tf[k] = Tc[k];
      from = at;
      count = cnt;
      if (!rescue) score = r[17];
    }
  }
  unsigned in = in0;
  if (from == 2 * a.P) {
    in = in_w;
  } else if (from >= 0) {
    in = 0u;
#pragma unroll
    for (int j = 0; j < kSL; ++j) {
      const int n = slot(lane, j, p.vec);
      if (n < a.N) in |= (a.cmask[(base + from) * a.N + n] ? 1u : 0u) << j;
    }
  }
  const float n_inl = static_cast<float>(warp_count(in));
  const float n_valid = static_cast<float>(warp_count(p.valid));
#pragma unroll
  for (int j = 0; j < kSL; ++j) {
    const int n = slot(lane, j, p.vec);
    if (n < a.N) a.inliers[static_cast<size_t>(s) * a.N + n] = (in >> j) & 1u;
  }
  if (lane == 0) {
    a.ratio[s] = dvd(n_inl, fmaxf(n_valid, 1.0f));
    const float floor_ = fmaxf(mul(0.1f, n_valid), 6.0f);
    a.ok[s] = n_inl >= floor_ && finite16(Tf);
    // se3.inverse: [R^T | -(R^T t)]
    float* out = a.T_wc + static_cast<size_t>(s) * 16;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float col[3] = {Tf[i], Tf[4 + i], Tf[8 + i]};
      const float t[3] = {Tf[3], Tf[7], Tf[11]};
#pragma unroll
      for (int k = 0; k < 3; ++k) out[4 * i + k] = col[k];
      out[4 * i + 3] = -(a.single ? dot_halves<3>(col, t) : dot_chain<0, 3>(col, t));
    }
    out[12] = 0.0f;
    out[13] = 0.0f;
    out[14] = 0.0f;
    out[15] = 1.0f;
  }
}


// ---- the wide path: N > 128 slots ---------------------------------------------
//
// Past 128 slots a lane cannot hold its slots in registers (64 at N =
// 2048), and PyTorch's reductions change their split with N. A point is read
// where it is needed (__ldg: a stream's points, 40 KB at N = 2048, stay in
// L1), a warp's inlier masks are bytes in shared memory, and each sum over
// the points repeats the split that ATen's setReduceConfig picks for the
// plain path's shape (geometry/pnp.py::sum_width, gn_plan):
// - a sum over the N slots (the MSAC score of a hypothesis, bw_h threads;
//   a chain's strict score, bw_s): vectorised by 4, thread t adding the
//   4-vectors t, t + bw, ... into four accumulators, the 0-3 tail elements
//   into thread 0-2's first, then a shared-memory tree of offsets bw / 2 ..
//   32 and the warp tree of offsets 16 .. 1. A lane is threads lane,
//   lane + 32, ..., so a lane's vectors are lane + 32 m.
// - a Gauss-Newton sum (dim -3): bh threads along the points in each of ct
//   blocks, thread q = y + bh c adding points q, q + bh ct, ... into four
//   accumulators; each block's tree over y, then (ct > 1) thread y of the
//   last block adding the blocks' partials c = y, y + bh, ... and a tree
//   over y. A lane computes accumulator (q, i) for items lane + 32 s; four
//   lanes' accumulators are combined by shuffles, the trees run in shared
//   memory, a lane a term.

struct Pt {
  float X, Y, Z, u, v;
  bool valid;
};

__device__ __forceinline__ Pt load_pt(const Args& a, int s, int n) {
  const size_t o = static_cast<size_t>(s) * a.N + n;
  return Pt{__ldg(a.Xw + 3 * o), __ldg(a.Xw + 3 * o + 1), __ldg(a.Xw + 3 * o + 2),
            __ldg(a.uv + 2 * o), __ldg(a.uv + 2 * o + 1), a.valid[o] != 0};
}

// consensus()'s terms of one point: the inlier test at `gate` and the
// MSAC residual (0 on an invalid slot)
__device__ __forceinline__ float point_res(const Cam& c, const float* T, const Pt& p, float gate,
                                           float thr2, bool& in) {
  float Xc[3];
  transform(T, p.X, p.Y, p.Z, Xc);
  const float z = Xc[2];
  const float zs = away(z, 1e-9f);
  const float du = sub(add(dvd(mul(c.fx, Xc[0]), zs), c.cx), p.u);
  const float dv = sub(add(dvd(mul(c.fy, Xc[1]), zs), c.cy), p.v);
  const float e2 = add(mul(du, du), mul(dv, dv));
  in = (e2 < gate) && (z > 0.0f) && p.valid;
  const float r2 = z > 0.0f ? (isnan(e2) ? e2 : fminf(e2, thr2)) : thr2;
  return p.valid ? r2 : 0.0f;
}

__device__ __forceinline__ int warp_add(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// consensus() over N > 128 slots: the inliers at `gate` into mask (bytes,
// if not null), their count into *count (if not null), and the MSAC score
// summed by bw threads (if score is not null), every lane the same bits.
__device__ void wide_consensus(const Args& a, const Cam& c, const float* T, int s, float gate,
                               int bw, uint8_t* mask, int* count, float* score, int lane) {
  const int nvec = a.N >> 2, tail = a.N & 3, per = bw >> 5;
  float part[16];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    part[k] = 0.0f;
    if (k >= per) continue;
    const int t = lane + 32 * k;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int v = t; v < nvec; v += bw) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 4 * v + i;
        bool in;
        acc[i] = add(acc[i], point_res(c, T, load_pt(a, s, n), gate, a.thr2, in));
        if (mask != nullptr) mask[n] = in;
        cnt += in;
      }
    }
    if (t < tail) {
      const int n = 4 * nvec + t;
      bool in;
      acc[0] = add(acc[0], point_res(c, T, load_pt(a, s, n), gate, a.thr2, in));
      if (mask != nullptr) mask[n] = in;
      cnt += in;
    }
    part[k] = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
  }
  if (count != nullptr) *count = warp_add(cnt);
  if (score != nullptr) {
    // the shared-memory tree, offsets bw / 2 .. 32: thread lane + 32 k
    // takes thread lane + 32 (k + o)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      if (2 * o <= per) {
#pragma unroll
        for (int k = 0; k < o; ++k) part[k] = add(part[k], part[k + o]);
      }
    }
    float v = part[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(kFull, v, o));
    *score = v;
  }
  __syncwarp();
}

// gn_step's per-point terms of point n under T: J^T (J w)'s 21 lower
// entries (H) or J^T (r w)'s 6 (g), as the plain path's products round them
template <bool G>
__device__ __forceinline__ void gn_terms(const Cam& c, const float* T, const Pt& p, float w,
                                         float* out) {
  const float nfx = -c.fx, nfy = -c.fy;
  float Xc[3];
  transform(T, p.X, p.Y, p.Z, Xc);
  const float x = Xc[0], y = Xc[1], z = Xc[2];
  const float inv_z = dvd(1.0f, away(z, 1e-9f));
  const float zero = 0.0f;
  const float Jpi[2][3] = {
      {mul(c.fx, inv_z), zero, mul(mul(mul(nfx, x), inv_z), inv_z)},
      {zero, mul(c.fy, inv_z), mul(mul(mul(nfy, y), inv_z), inv_z)}};
  const float Jx[3][6] = {{1.0f, 0.0f, 0.0f, -zero, z, -y},
                          {0.0f, 1.0f, 0.0f, -z, -zero, x},
                          {0.0f, 0.0f, 1.0f, y, -x, -zero}};
  float J[2][6];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      J[r][q] = fma_(Jpi[r][2], Jx[2][q], fma_(Jpi[r][1], Jx[1][q], mul(Jpi[r][0], Jx[0][q])));
    }
  }
  if constexpr (G) {
    const float r0 = sub(add(mul(mul(c.fx, x), inv_z), c.cx), p.u);
    const float r1 = sub(add(mul(mul(c.fy, y), inv_z), c.cy), p.v);
    const float rw0 = mul(r0, w), rw1 = mul(r1, w);
#pragma unroll
    for (int i = 0; i < 6; ++i) out[i] = add(mul(J[0][i], rw0), mul(J[1][i], rw1));
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) {
        out[tri(i, k)] = fma_(J[1][i], mul(J[1][k], w), mul(J[0][i], mul(J[0][k], w)));
      }
    }
  }
}

// One Gauss-Newton sum over the points (21 terms of H, or 6 of g) in the
// plain path's split (bh threads x ct blocks), into tot[0 .. NT).
template <bool G>
__device__ void wide_gn_sum(const Args& a, const Cam& c, int s, const float* T,
                            const uint8_t* sel, int bh, int ct, float* parts, float* tot,
                            int lane) {
  constexpr int NT = G ? 6 : 21;
  const int nq = bh * ct, items = 4 * nq;
  for (int base = 0; base < items; base += 32) {
    const int it = base + lane;
    const int q = it >> 2, i = it & 3;
    float acc[NT];
#pragma unroll
    for (int k = 0; k < NT; ++k) acc[k] = 0.0f;
    if (it < items) {
      for (int n = q + nq * i; n < a.N; n += 4 * nq) {
        float t[NT];
        gn_terms<G>(c, T, load_pt(a, s, n), sel[n] ? 1.0f : 0.0f, t);
#pragma unroll
        for (int k = 0; k < NT; ++k) acc[k] = add(acc[k], t[k]);
      }
    }
    // thread q's four accumulators, ((a0 + a1) + a2) + a3
    const int g0 = lane & ~3;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const float a1 = __shfl_sync(kFull, acc[k], g0 + 1);
      const float a2 = __shfl_sync(kFull, acc[k], g0 + 2);
      const float a3 = __shfl_sync(kFull, acc[k], g0 + 3);
      if (it < items && i == 0) parts[q * NT + k] = add(add(add(acc[k], a1), a2), a3);
    }
  }
  __syncwarp();
  if (lane < NT) {
    float* col = parts + lane;
    for (int b = 0; b < ct; ++b) {  // each block's tree over its bh threads
      float* blk = col + b * bh * NT;
      for (int o = bh >> 1; o > 0; o >>= 1) {
        for (int y = 0; y < o; ++y) blk[y * NT] = add(blk[y * NT], blk[(y + o) * NT]);
      }
    }
    float r = col[0];
    if (ct > 1) {  // the last block: thread y adds blocks y, y + bh, ..., then a tree (bh <= 8)
      float fin[8];
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        fin[y] = 0.0f;
        if (y < bh) {
          for (int b = y; b < ct; b += bh) fin[y] = add(fin[y], col[b * bh * NT]);
        }
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
        if (o < bh) {
#pragma unroll
          for (int y = 0; y < o; ++y) fin[y] = add(fin[y], fin[y + o]);
        }
      }
      r = fin[0];
    }
    tot[lane] = r;
  }
  __syncwarp();
}

// lo_from over N > 128 slots: each round selects the inliers at its gate
// into sel, then refines
__device__ void wide_lo_chain(const Args& a, const Cam& c, int s, float* T, const float* gates,
                              int rounds, uint8_t* sel, float* parts, float* tot, int lane) {
  for (int r = 0; r < rounds; ++r) {
    wide_consensus(a, c, T, s, gates[r], 32, sel, nullptr, nullptr, lane);
    for (int it = 0; it < a.iters; ++it) {
      wide_gn_sum<false>(a, c, s, T, sel, a.bh_H, a.ct_H, parts, tot, lane);
      wide_gn_sum<true>(a, c, s, T, sel, a.bh_g, a.ct_g, parts, tot + 21, lane);
      gn_solve(a, tot, T);
    }
  }
}

// A wide warp's shared memory: the DLT's scratch, or the Gauss-Newton
// partials (kMaxParts x 21), their 27 sums, and a mask of N bytes.
__host__ __device__ constexpr int wide_warp_floats(int N) {
  return (kMaxParts * 21 + 32 > kDltSmem ? kMaxParts * 21 + 32 : kDltSmem) + (N + 3) / 4;
}

// store_chain over N > 128 slots; the strict inliers stay in mask, the
// count and score in every lane
__device__ void wide_store_chain(const Args& a, const Cam& c, int s, int at, const float* T,
                                 uint8_t* mask, int& cnt, float& score, int lane) {
  wide_consensus(a, c, T, s, a.thr2, a.bw_s, mask, &cnt, &score, lane);
  const size_t o = static_cast<size_t>(s) * (2 * a.P + 1) + at;
  if (lane == 0) {
    float* dst = a.chain + o * kChain;
#pragma unroll
    for (int k = 0; k < 16; ++k) dst[k] = T[k];
    dst[16] = static_cast<float>(cnt);
    dst[17] = score;
  }
  for (int n = lane; n < a.N; n += 32) a.cmask[o * a.N + n] = mask[n];
}

// top6 over N > 128 slots: each lane keeps its first 6 in the sort's order,
// then 6 warp arg-max rounds over the lanes' heads
__device__ void wide_top6(const Args& a, const float* noise, int s, int lane, int* idx) {
  float bv[6];
  int bi[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    bv[j] = 0.0f;
    bi[j] = -1;
  }
  for (int n = lane; n < a.N; n += 32) {
    float kv = a.valid[static_cast<size_t>(s) * a.N + n] ? noise[n] : -INFINITY;
    int ki = n;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (ki >= 0 && (bi[j] < 0 || before(kv, ki, bv[j], bi[j]))) {
        const float tv = bv[j];
        const int ti = bi[j];
        bv[j] = kv;
        bi[j] = ki;
        kv = tv;
        ki = ti;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float v = bv[0];
    int i = bi[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, o);
      const int oi = __shfl_xor_sync(kFull, i, o);
      if (oi >= 0 && (i < 0 || before(ov, oi, v, i))) {
        v = ov;
        i = oi;
      }
    }
    idx[r] = i;
    if (bi[0] == i) {
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        bv[j] = bv[j + 1];
        bi[j] = bi[j + 1];
      }
      bi[5] = -1;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32) pnp_hypotheses_wide_kernel(const Args a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.y;
  const int w = blockIdx.x * kWarps + warp;
  const int n_chain = 2 * a.P;
  if (w >= n_chain + a.H + a.P) return;
  const Cam c = load_cam(a.K);
  float* sm = smem + warp * wide_warp_floats(a.N);
  float* tot = sm + kMaxParts * 21;
  uint8_t* mask = reinterpret_cast<uint8_t*>(sm + wide_warp_floats(0));
  float T[16];
  if (w < n_chain) {  // lo_from(T_init[i], strict or annealed)
    const float* T0 = a.T_init + (static_cast<size_t>(s) * a.P + (w >> 1)) * 16;
#pragma unroll
    for (int k = 0; k < 16; ++k) T[k] = T0[k];
    const bool annealed = w & 1;
    wide_lo_chain(a, c, s, T, annealed ? a.anneal : a.strict,
                  annealed ? a.n_anneal : a.n_strict, mask, sm, tot, lane);
    int cnt;
    float score;
    wide_store_chain(a, c, s, w, T, mask, cnt, score, lane);
    return;
  }
  const int h = w - n_chain;
  if (h < a.H) {
    int idx[6];
    wide_top6(a, a.noise + (static_cast<size_t>(s) * a.H + h) * a.N, s, lane, idx);
    if (lane < 6) {
      int mine = idx[0];
#pragma unroll
      for (int q = 1; q < 6; ++q) mine = lane == q ? idx[q] : mine;
      a.idx[(static_cast<size_t>(s) * a.H + h) * 6 + lane] = mine;
    }
    dlt(a, c, s, idx, sm, lane, T);
  } else {
    const float* T0 = a.T_init + (static_cast<size_t>(s) * a.P + (h - a.H)) * 16;
#pragma unroll
    for (int k = 0; k < 16; ++k) T[k] = T0[k];
  }
  float score;
  wide_consensus(a, c, T, s, a.thr2, a.bw_h, nullptr, nullptr, &score, lane);
  if (lane == 0) {
    float* dst = a.hyp + (static_cast<size_t>(s) * (a.H + a.P) + h) * kHyp;
#pragma unroll
    for (int k = 0; k < 16; ++k) dst[k] = T[k];
    dst[16] = finite16(T) ? score : INFINITY;
  }
}

__global__ void __launch_bounds__(32) pnp_select_wide_kernel(const Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int s = blockIdx.x;
  const int n_hyp = a.H + a.P;
  const Cam c = load_cam(a.K);
  float* tot = smem + kMaxParts * 21;
  uint8_t* mask = reinterpret_cast<uint8_t*>(smem + wide_warp_floats(0));
  const float* hyp = a.hyp + static_cast<size_t>(s) * n_hyp * kHyp;
  float bv = 0.0f;
  int bi = -1;
  for (int h = lane; h < n_hyp; h += 32) {
    const float v = hyp[h * kHyp + 16];
    if (bi < 0 || less_or_nan(v, h, bv, bi)) {
      bv = v;
      bi = h;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (oi >= 0 && (bi < 0 || less_or_nan(ov, oi, bv, bi))) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) a.best[s] = bi;
  float Tb[16], Tw[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) Tb[k] = Tw[k] = hyp[bi * kHyp + k];
  uint8_t* inliers = a.inliers + static_cast<size_t>(s) * a.N;
  // finals[0]: the winner as it is; its strict inliers go to the output
  // until a chain beats it
  float score;
  int count;
  wide_consensus(a, c, Tb, s, a.thr2, a.bw_s, mask, &count, &score, lane);
  for (int n = lane; n < a.N; n += 32) inliers[n] = mask[n];
  __syncwarp();  // every lane has read the mask before the chain writes it
  // finals[1]: the LO chain from the winner
  wide_lo_chain(a, c, s, Tw, a.strict, a.n_strict, mask, smem, tot, lane);
  int count_w;
  float score_w;
  wide_store_chain(a, c, s, 2 * a.P, Tw, mask, count_w, score_w, lane);
  const size_t base = static_cast<size_t>(s) * (2 * a.P + 1);
  float Tf[16];
  int from = -1;
  const bool take_w = finite16(Tw) && (count_w > count || (count_w == count && score_w < score));
#pragma unroll
  for (int k = 0; k < 16; ++k) Tf[k] = take_w ? Tw[k] : Tb[k];
  if (take_w) {
    from = 2 * a.P;
    count = count_w;
    score = score_w;
  }
  float Tc[16];
  for (int i = 0; i < 2 * a.P; ++i) {  // the strict chains from the priors, then the rescues
    const bool rescue = i >= a.P;
    const int at = rescue ? 2 * (i - a.P) + 1 : 2 * i;
    const float* r = a.chain + (base + at) * kChain;
    const int cnt = static_cast<int>(r[16]);
#pragma unroll
    for (int k = 0; k < 16; ++k) Tc[k] = r[k];
    const bool better =
        finite16(Tc) &&
        (rescue ? static_cast<float>(cnt) >= add(mul(a.margin, static_cast<float>(count)), 2.0f)
                : cnt > count || (cnt == count && r[17] < score));
    if (better) {
#pragma unroll
      for (int k = 0; k < 16; ++k) Tf[k] = Tc[k];
      from = at;
      count = cnt;
      if (!rescue) score = r[17];
    }
  }
  __syncwarp();
  int n_valid = 0;
  for (int n = lane; n < a.N; n += 32) {
    if (from >= 0) inliers[n] = from == 2 * a.P ? mask[n] : a.cmask[(base + from) * a.N + n];
    n_valid += a.valid[static_cast<size_t>(s) * a.N + n] != 0;
  }
  n_valid = warp_add(n_valid);
  if (lane == 0) {
    const float n_inl = static_cast<float>(count);
    const float nv = static_cast<float>(n_valid);
    a.ratio[s] = dvd(n_inl, fmaxf(nv, 1.0f));
    const float floor_ = fmaxf(mul(0.1f, nv), 6.0f);
    a.ok[s] = n_inl >= floor_ && finite16(Tf);
    float* out = a.T_wc + static_cast<size_t>(s) * 16;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float col[3] = {Tf[i], Tf[4 + i], Tf[8 + i]};
      const float t[3] = {Tf[3], Tf[7], Tf[11]};
#pragma unroll
      for (int k = 0; k < 3; ++k) out[4 * i + k] = col[k];
      out[4 * i + 3] = -(a.single ? dot_halves<3>(col, t) : dot_chain<0, 3>(col, t));
    }
    out[12] = 0.0f;
    out[13] = 0.0f;
    out[14] = 0.0f;
    out[15] = 1.0f;
  }
}

}  // namespace

// Xw (S, N, 3), uv (S, N, 2), valid (S, N) bool, noise (S, H, N) float32
// device buffers; T_init (S, P, 4, 4) or null with P = 0; the LO gates
// (squared px, float32 as the plain path compares them) on the host; the
// split of the Gauss-Newton sums (threads a block: 1, 2, 4 or 8 up to N =
// 128; blocks: 1 up to 128) and, past N = 128, of the sums over the slots
// (geometry/pnp.py::gn_plan, sum_width); the scratch and outputs as Args
// lays them out. Returns cudaGetLastError() after the launches.
extern "C" int svo_ransac_pnp(const void* K, const void* Xw, const void* uv, const void* valid,
                              const void* noise, const void* T_init, int S, int N, int H, int P,
                              int iters, const float* strict, int n_strict, const float* anneal,
                              int n_anneal, float thr2, float margin, int bh_H, int bh_g,
                              int ct_H, int ct_g, int bw_h, int bw_s,
                              void* hyp, void* chain, void* cmask, void* best, void* idx,
                              void* T_wc, void* inliers, void* ratio, void* ok, void* stream) {
  const bool wide = N > kMaxN;
  const auto pow2 = [](int v, int hi) { return v >= 1 && v <= hi && (v & (v - 1)) == 0; };
  // a Gauss-Newton sum's split: narrow, 1-8 threads; wide, at most
  // kMaxParts threads, 8 a block where it spans blocks
  const auto bad_gn = [&](int bh, int ct) {
    if (!wide) return !pow2(bh, 8) || ct != 1;
    return !pow2(bh, kMaxParts) || ct < 1 || bh * ct > kMaxParts || (ct > 1 && bh > 8);
  };
  const auto bad_bw = [&](int bw) { return wide && (!pow2(bw, 512) || bw < 32); };
  if (S < 1 || S > 65535 || N < 6 || N > kMaxWideN || H < 1 || P < 0 ||
      (P > 0) != (T_init != nullptr) || iters < 0 || n_strict < 0 ||
      n_strict > kMaxSchedule || n_anneal < 0 || n_anneal > kMaxSchedule ||
      bad_gn(bh_H, ct_H) || bad_gn(bh_g, ct_g) || bad_bw(bw_h) || bad_bw(bw_s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  a.K = static_cast<const float*>(K);
  a.Xw = static_cast<const float*>(Xw);
  a.uv = static_cast<const float*>(uv);
  a.valid = static_cast<const uint8_t*>(valid);
  a.noise = static_cast<const float*>(noise);
  a.T_init = static_cast<const float*>(T_init);
  a.S = S;
  a.N = N;
  a.H = H;
  a.P = P;
  a.iters = iters;
  a.n_strict = n_strict;
  a.n_anneal = n_anneal;
  a.single = S == 1;
  a.bh_H = bh_H;
  a.bh_g = bh_g;
  a.ct_H = ct_H;
  a.ct_g = ct_g;
  a.bw_h = bw_h;
  a.bw_s = bw_s;
  for (int r = 0; r < n_strict; ++r) a.strict[r] = strict[r];
  for (int r = 0; r < n_anneal; ++r) a.anneal[r] = anneal[r];
  a.thr2 = thr2;
  a.margin = margin;
  a.hyp = static_cast<float*>(hyp);
  a.chain = static_cast<float*>(chain);
  a.cmask = static_cast<uint8_t*>(cmask);
  a.best = static_cast<int*>(best);
  a.idx = static_cast<int*>(idx);
  a.T_wc = static_cast<float*>(T_wc);
  a.inliers = static_cast<uint8_t*>(inliers);
  a.ratio = static_cast<float*>(ratio);
  a.ok = static_cast<uint8_t*>(ok);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tasks = 2 * P + H + P;
  const dim3 grid1((tasks + kWarps - 1) / kWarps, S);
  if (wide) {
    // a warp's scratch: 12.9 KB at N = 2048, two warps under a block's 48 KB
    const int bytes = wide_warp_floats(N) * static_cast<int>(sizeof(float));
    pnp_hypotheses_wide_kernel<<<grid1, kWarps * 32, kWarps * bytes, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    pnp_select_wide_kernel<<<S, 32, bytes, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // a warp's scratch: 13.6 KB at N = 128, two warps under a block's 48 KB
  const int bytes = warp_floats(N) * static_cast<int>(sizeof(float));
  pnp_hypotheses_kernel<<<grid1, kWarps * 32, kWarps * bytes, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pnp_select_kernel<<<S, 32, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
