// One whole pyramidal Lucas-Kanade level per feature, in one launch.
//
// Replaces the TPU kernel svo_tpu/ops/lk_pallas.py::_call (pallas_call,
// kernel body _kernel, entry lk_track_level). For each of N features it
// samples the template window T and its gradients Tx, Ty at the feature's
// fractional position in the previous level, forms the 2x2 normal matrix G
// with its min-eigenvalue/determinant gate, runs max_iters masked LK
// updates against the current level inside a travel box of 2*margin px per
// axis, and writes 8 floats: dx, dy relative to the guess, min_eig,
// solvable, in_patch, 0, 0, 0. The geometry is the TPU kernel's, as
// svo_tpu_torch/ops/lk_fused.py states it; that file's lk_track_level_ref
// is the plain version this kernel is held against.
//
// What bounds it: very little data and very little arithmetic. A temporal
// feature (window 21, margins 6/6) reads three 24x24 template windows and
// one 34x34 current window, ~11.5 KB, and does ~50 kflop over 8
// iterations; a call of N=128 features moves ~1.5 MB. So a call is bound by
// its launch and by the latency of one feature's serial chain (stage,
// template, 8 x (sample, two warp reductions, 2x2 update)), not by memory
// bandwidth or flops.
//
// Design: one warp per feature, up to 4 features per block (the windows of
// 4 temporal features, 46 KB, stay under the 48 KB of shared memory a block
// gets without opting in). The warp stages its windows in shared memory
// once; each lane then owns a fixed set of window pixels and holds T, Tx,
// Ty and the pixels' offsets in registers for all iterations. G, b1 and b2
// are butterfly warp-shuffle sums, so every lane holds the same scalars and
// the update stays in registers with no block synchronisation. There are no
// atomics: two launches on the same inputs give bit-identical outputs. A
// dead slot reads nothing. Corners are clamped after the float->int cast,
// so a non-finite position or guess cannot index out of range.
//
// The stream axis (the TPU kernel's batched form, lk_pallas.py _batched,
// grid (S, N/8) over (S, H, W) images) is part of the same launch: the
// grid covers S*N features, and a warp's feature index n gives its stream
// n / N and so the base of its four images, img + (n / N) * H * W.
// Features of two streams may share a block. One stream is S = 1.
//
// The TPU kernel's row-folded 2-D scratch, selector matmuls, lane rolls and
// (bf, 128) loop carries were constraints of its compiler and have no
// counterpart here. Launches on the caller's stream, allocates nothing,
// does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kPX = 64;             // lk_pallas._PX: corners clip to W - 64
constexpr float kTplMax = 2.0f;     // lk_pallas._TT_T - 2: template offset clip
constexpr int kMaxWarps = 4;        // features per block
constexpr int kSmemBudget = 48 * 1024;

struct LevelArgs {
  const float* prev;      // (S, H, W), like gx, gy, curr
  const float* gx;
  const float* gy;
  const float* curr;
  const float* pos;       // (S*N, 2) x, y in padded level coordinates
  const float* guess;     // (S*N, 2)
  const uint8_t* valid;   // (S*N,) bool
  float* out;             // (S*N, 8)
  int H, W, N, total, w, py, mx, my, max_iters;  // total = S * N
  float eps2, min_eig_threshold;
  int warp_floats;        // shared floats per feature
};

// clip and hat as jnp.clip / jnp.maximum write them: a NaN passes through
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float hat(float d) {
  const float h = 1.0f - fabsf(d);
  return h < 0.0f ? 0.0f : h;
}

// clip(floor(v) - margin, 0, hi); the cast saturates and maps NaN to 0
__device__ __forceinline__ int corner(float v, int margin, int hi) {
  const long long i = static_cast<long long>(__float2int_rd(v)) - margin;
  return static_cast<int>(min(max(i, 0LL), static_cast<long long>(hi)));
}

// The two hat taps with weight at offset o in [0, amax]: floor(o), floor(o)+1.
struct Taps {
  int a;
  float w0, w1;
};

__device__ __forceinline__ Taps taps(float o, int amax) {
  Taps t;
  t.a = min(max(__float2int_rd(o), 0), amax);
  const float fa = static_cast<float>(t.a);
  t.w0 = hat(o - fa);
  t.w1 = hat(o - (fa + 1.0f));
  return t;
}

// x first, then y, as the TPU kernel's separable sample
__device__ __forceinline__ float bilerp(const float* s, int b, int stride, Taps x, Taps y) {
  const float top = x.w0 * s[b] + x.w1 * s[b + 1];
  const float bot = x.w0 * s[b + stride] + x.w1 * s[b + stride + 1];
  return y.w0 * top + y.w1 * bot;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K: window pixels per lane, ceil(w*w / 32) rounded up to an instantiation
template <int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
lk_level_kernel(const LevelArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= a.total) return;
  const size_t img = static_cast<size_t>(n / a.N) * a.H * a.W;  // the stream's image

  const int w = a.w, ww = w * w;
  const int tw = w + 3;                // template window side: 2 + 1 taps
  const int cw = w + 2 * a.mx + 1;     // current window cols
  const int ch = w + 2 * a.my + 1;     // current window rows
  float* s_t = smem + warp * a.warp_floats;
  float* s_gx = s_t + tw * tw;
  float* s_gy = s_gx + tw * tw;
  float* s_c = s_gy + tw * tw;

  const float half = (w - 1) * 0.5f;
  const float Rx = static_cast<float>(2 * a.mx);
  const float Ry = static_cast<float>(2 * a.my);
  const float p_x = a.pos[2 * n], p_y = a.pos[2 * n + 1];
  const float tx = p_x - half, ty = p_y - half;
  const float cx = (p_x + a.guess[2 * n]) - half;
  const float cy = (p_y + a.guess[2 * n + 1]) - half;
  const int t_iy = corner(ty, 0, a.H - a.py), t_ix = corner(tx, 0, a.W - kPX);
  const int c_iy = corner(cy, a.my, a.H - a.py), c_ix = corner(cx, a.mx, a.W - kPX);
  float t_ox = tx - static_cast<float>(t_ix), t_oy = ty - static_cast<float>(t_iy);
  const float o0x = cx - static_cast<float>(c_ix), o0y = cy - static_cast<float>(c_iy);
  const bool t_in = t_ox >= 0.0f && t_ox <= kTplMax && t_oy >= 0.0f && t_oy <= kTplMax;
  t_ox = clip(t_ox, 0.0f, kTplMax);
  t_oy = clip(t_oy, 0.0f, kTplMax);

  float ox = o0x, oy = o0y, min_eig = 0.0f;
  bool solvable = false;
  if (a.valid[n]) {
    // stage the windows; the last row/col of each only ever gets weight 0
    // and is read clamped to the image
    for (int i = lane; i < tw * tw; i += 32) {
      const int r = i / tw, c = i - r * tw;
      const size_t g = static_cast<size_t>(min(t_iy + r, a.H - 1)) * a.W + min(t_ix + c, a.W - 1);
      s_t[i] = a.prev[img + g];
      s_gx[i] = a.gx[img + g];
      s_gy[i] = a.gy[img + g];
    }
    for (int i = lane; i < ch * cw; i += 32) {
      const int r = i / cw, c = i - r * cw;
      s_c[i] = a.curr[img + static_cast<size_t>(min(c_iy + r, a.H - 1)) * a.W + min(c_ix + c, a.W - 1)];
    }
    __syncwarp();

    // template and gradients, once; G from them
    const Taps tX = taps(t_ox, 2), tY = taps(t_oy, 2);
    float T[K], GX[K], GY[K];
    int off[K];
    float a11 = 0.0f, a12 = 0.0f, a22 = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = lane + 32 * k;
      T[k] = GX[k] = GY[k] = 0.0f;
      off[k] = 0;
      if (e < ww) {
        const int r = e / w, c = e - r * w;
        const int b = (tY.a + r) * tw + tX.a + c;
        T[k] = bilerp(s_t, b, tw, tX, tY);
        GX[k] = bilerp(s_gx, b, tw, tX, tY);
        GY[k] = bilerp(s_gy, b, tw, tX, tY);
        off[k] = r * cw + c;
        a11 += GX[k] * GX[k];
        a12 += GX[k] * GY[k];
        a22 += GY[k] * GY[k];
      }
    }
    a11 = warp_sum(a11);
    a12 = warp_sum(a12);
    a22 = warp_sum(a22);
    // the 2x2 algebra rounds each product as the plain version does
    const float tr_half = __fmul_rn(__fadd_rn(a11, a22), 0.5f);
    const float det = __fsub_rn(__fmul_rn(a11, a22), __fmul_rn(a12, a12));
    const float disc = sqrtf(fmaxf(__fsub_rn(__fmul_rn(tr_half, tr_half), det), 0.0f));
    min_eig = __fsub_rn(tr_half, disc) / static_cast<float>(ww);
    const float inv_det = 1.0f / (det > 1e-12f ? det : 1.0f);
    const float i11 = __fmul_rn(a22, inv_det);
    const float i12 = __fmul_rn(-a12, inv_det);
    const float i22 = __fmul_rn(a11, inv_det);

    float conv = 0.0f;
    for (int it = 0; it < a.max_iters; ++it) {
      const float in_patch = (ox >= 0.0f && ox <= Rx && oy >= 0.0f && oy <= Ry) ? 1.0f : 0.0f;
      const Taps cX = taps(clip(ox, 0.0f, Rx), 2 * a.mx);
      const Taps cY = taps(clip(oy, 0.0f, Ry), 2 * a.my);
      const int b = cY.a * cw + cX.a;
      float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lane + 32 * k < ww) {
          const float diff = bilerp(s_c, b + off[k], cw, cX, cY) - T[k];
          b1 += diff * GX[k];
          b2 += diff * GY[k];
        }
      }
      b1 = warp_sum(b1);
      b2 = warp_sum(b2);
      const float du = -__fadd_rn(__fmul_rn(i11, b1), __fmul_rn(i12, b2));
      const float dv = -__fadd_rn(__fmul_rn(i12, b1), __fmul_rn(i22, b2));
      const float active = (1.0f - conv) * in_patch;
      ox = __fadd_rn(ox, __fmul_rn(active, du));
      oy = __fadd_rn(oy, __fmul_rn(active, dv));
      const float small = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) < a.eps2 ? 1.0f : 0.0f;
      conv = fminf(conv + small + (1.0f - in_patch), 1.0f);
    }
    solvable = min_eig > a.min_eig_threshold && det > 1e-12f && t_in;
  }

  const bool in_fin = ox >= -1.0f && ox <= Rx + 1.0f && oy >= -1.0f && oy <= Ry + 1.0f;
  if (lane < 8) {
    float v = 0.0f;
    if (lane == 0) v = ox - o0x;
    else if (lane == 1) v = oy - o0y;
    else if (lane == 2) v = min_eig;
    else if (lane == 3) v = solvable ? 1.0f : 0.0f;
    else if (lane == 4) v = in_fin ? 1.0f : 0.0f;
    a.out[8 * static_cast<size_t>(n) + lane] = v;
  }
}

template <int K>
cudaError_t launch(const LevelArgs& a, cudaStream_t stream) {
  const int bytes = a.warp_floats * static_cast<int>(sizeof(float));
  const int warps = std::max(1, std::min(kMaxWarps, kSmemBudget / bytes));
  const int blocks = (a.total + warps - 1) / warps;
  lk_level_kernel<K><<<blocks, warps * 32, warps * bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int svo_lk_level(
    const void* prev, const void* gx, const void* gy, const void* curr,
    int S, int H, int W, const void* pos, const void* guess,
    const void* valid, int N, int window, int py, int margin_x, int margin_y, int max_iters,
    float eps2, float min_eig_threshold, void* out, void* stream) {
  if (S <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (window < 1 || window > 32 || margin_x < 0 || margin_y < 0 || H < py ||
      W < kPX || window + 2 * margin_x + 1 > kPX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelArgs a;
  a.prev = static_cast<const float*>(prev);
  a.gx = static_cast<const float*>(gx);
  a.gy = static_cast<const float*>(gy);
  a.curr = static_cast<const float*>(curr);
  a.pos = static_cast<const float*>(pos);
  a.guess = static_cast<const float*>(guess);
  a.valid = static_cast<const uint8_t*>(valid);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.W = W;
  a.N = N;
  a.total = S * N;
  a.w = window;
  a.py = py;
  a.mx = margin_x;
  a.my = margin_y;
  a.max_iters = max_iters;
  a.eps2 = eps2;
  a.min_eig_threshold = min_eig_threshold;
  const int tw = window + 3;
  a.warp_floats = 3 * tw * tw + (window + 2 * margin_y + 1) * (window + 2 * margin_x + 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = (window * window + 31) / 32;
  const cudaError_t err = slots <= 4 ? launch<4>(a, s) : slots <= 14 ? launch<14>(a, s) : launch<32>(a, s);
  return static_cast<int>(err);
}
