// The patches engine's tracker call, all pyramid levels in one launch.
//
// Replaces, for the patches engine of svo_tpu_torch/ops/klt.py, the chain
// of per-level tensor ops the tracker ran on the card: per level one
// csrc/klt_patches.cu extraction (the port of svo_tpu/ops/klt_pallas.py
// ::_call), then _patch_level's template blends, 2x2 system and masked LK
// iterations, and between levels _track_impl's glue. That is some 650
// PyTorch launches a level, ~3,250 a tracking step; no TPU kernel does the
// level body (svo_tpu leaves it to XLA), so this kernel has no Pallas
// counterpart beyond the extraction it absorbs.
//
// What one launch covers: every level of one tracker call, coarse to fine,
// for all S*N features of all streams. One warp carries its feature's flow
// and status in registers from the top level to level 0. Per level, as
// ops/klt.py states it:
// - the glue: p_lvl = pos * 2^-level, guess *= 2, a level too small for a
//   patch (py == 0) skipped keeping the guess, p_pad = p_lvl + pad;
// - _corners: integer template and current corners, clamped, y aligned
//   down to 8;
// - the extraction: the template's three windows (image, gx, gy) and the
//   current patch, copied to shared memory; a dead slot's are zeros;
// - the template offset t_off, _in_box, _clip_off and the three _blend
//   samples T, Tx, Ty of the window;
// - the 2x2 normal matrix, min_eig, det, the `solvable` gate;
// - `iters` masked updates with the convergence mask;
// - the final window test and _inside.
// The one-level entry (svo_klt_track_level) runs one level from the
// caller's p_lvl, p_pad and guess with no glue: _patch_level's contract, as
// svo_lk_level is lk_level.cu's.
//
// Bit-equality with the tensor ops. The result equals the plain path's
// (the same ops run eagerly on the card) bit for bit, so every operation
// is the tensor op's rounding:
// - each product and sum is a separate __fmul_rn / __fadd_rn (no
//   contraction); sqrt and the reciprocal are IEEE (__fsqrt_rn,
//   __frcp_rn); a division by a Python number is a product by its float32
//   reciprocal (PyTorch's scalar division); comparisons with Python
//   numbers compare with their float32 values; clamp passes NaN as
//   torch.clamp does; float -> int casts floor then saturate, NaN to 0,
//   and int32 differences wrap, as on the card;
// - torch.sum over a contiguous (S*N, w, w) product reduces each row of
//   w*w floats in the order ATen's reduce kernel gives it
//   (ATen/native/cuda/Reduce.cuh, setReduceConfig: block_width threads
//   along a row, thread t its share into four accumulators, the four
//   added in order, then a shuffle tree). A row of 128 or more floats is
//   read in 4-vectors from its first 16-byte boundary: row b starts at
//   b * w*w floats into a fresh allocation, so the first (b*w*w) mod 4
//   elements ahead of the boundary go to threads (b*w*w mod 4) .. 3 and
//   the 0-3 elements past the last whole vector to threads 0 .. 3
//   (input_vectorized_thread_reduce_impl); a shorter row is read a float
//   at a time, thread t taking t, t + bw, ... (thread_reduce_impl).
//   block_width (bw) is 32 but for fewer than 16 rows; the wrapper reads
//   it (ops/klt_track.py::sum_plan) and hands it in. A lane plays threads
//   lane + 32 j, j < bw / 32; the tree's pairs are those of a butterfly
//   (a + b = b + a), so every lane ends with the row's sum.
//
// What bounds it: very little data and very little arithmetic. A temporal
// feature's level (window 21, 40x40 patches) reads three 22x22 template
// windows and one 40x40 patch, ~12 KB, and does ~40 kflop over 8
// iterations: a 4-level call of S*N = 1,024 features moves ~50 MB at most
// from L2 and does ~0.2 Gflop. The call is bound by the latency of one
// feature's serial chain (per level: stage, template, 8 x (sample, two
// row sums, 2x2 update)), which is why the level loop lives here and not
// on the host.
//
// Design: one warp a feature. Each lane owns the window pixels that its
// threads of the reference reduction would read (its "slots"), computed
// once a call from the row's alignment, and keeps T, Tx, Ty of those
// pixels in registers for all iterations; a slot the reduction does not
// give the lane samples pixel 0 and is masked out of the sums, so the
// loads stay unconditional. The windows are copied with cp.async, 4 bytes
// at a time (window starts are unaligned, and a padded level's row pitch
// is not a multiple of 16 bytes, so neither 16-byte copies nor TMA apply).
// A converged feature leaves the iteration loop (its flow is frozen, as
// the mask freezes it). Warps a block: 1 up to 264 features, 4 above
// (launch(), with the readings that chose it). There are no atomics: two
// launches on the same inputs give the same bits.
//
// The stream axis: images (S, H, W) per level, features (S*N) with
// feature n of stream n / N, reading its images at base + (n / N) * H * W.
// One stream is S = 1. Launches on the caller's stream, allocates nothing,
// does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxWarps = 4;
constexpr int kSmemOptIn = 227 * 1024;
constexpr int kMY = 6;  // ops/klt.py _MY: rows of upward travel before the clamp binds
constexpr unsigned kFull = 0xffffffffu;

struct Level {
  const float* prev;  // (S, H, W), as gx, gy, curr
  const float* gx;
  const float* gy;
  const float* curr;
  int H, W, py, iters;  // py == 0: the level is skipped
  float scale;          // 2^-level
};

struct Args {
  Level lv[kMaxLevels];  // lv[0] is level 0; the kernel runs n_levels-1 .. 0
  int n_levels;
  const float* pos;      // (S*N, 2) x, y: level-0 coordinates; raw: p_lvl
  const float* p_pad;    // raw only: (S*N, 2) padded level coordinates
  const float* guess;    // (S*N, 2): twice the top level's scale; raw: the level's
  const uint8_t* valid;  // (S*N,) bool
  float* out;            // (S*N, 4): dx, dy, min_eig (of level 0), status
  int N, total;          // total = S * N
  int w, px, mx, pad_x, pad_y;
  float eps2, min_eig_threshold, inv_ww;
  int raw;               // one level from the caller's p_lvl, p_pad, guess
  int bw, vec;           // the row sums' threads along a row; read in 4-vectors
  int warp_floats;       // shared floats a warp: 3 template windows, the patch
};

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.clamp(v, min=0.0)
__device__ __forceinline__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// clamp(int32(floor(v)) - sub, 0, hi): the cast saturates, NaN gives 0,
// the difference wraps as int32 tensor arithmetic does
__device__ __forceinline__ int corner(float v, int sub, int hi) {
  const int i = static_cast<int>(static_cast<unsigned>(__float2int_rd(v)) - static_cast<unsigned>(sub));
  return min(max(i, 0), hi);
}

// _blend's tap: torch.floor(o).long().clamp(0, hi) with o clipped to
// [0, hi] or NaN (which casts to 0), and the weights 1 - f, f
struct Tap {
  int i;
  float f, g;  // f = o - i, g = 1 - f
};

__device__ __forceinline__ Tap tap(float o, int hi) {
  Tap t;
  t.i = isnan(o) ? 0 : min(max(__float2int_rd(o), 0), hi);
  t.f = __fsub_rn(o, static_cast<float>(t.i));
  t.g = __fsub_rn(1.0f, t.f);
  return t;
}

// _blend at one window pixel: rows first, then columns
__device__ __forceinline__ float blend(const float* s, int b, int stride, Tap x, Tap y) {
  const float left = __fadd_rn(__fmul_rn(s[b], y.g), __fmul_rn(s[b + stride], y.f));
  const float right = __fadd_rn(__fmul_rn(s[b + 1], y.g), __fmul_rn(s[b + stride + 1], y.f));
  return __fadd_rn(__fmul_rn(left, x.g), __fmul_rn(right, x.f));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy the rows x cols window of img at (y0, x0) to s at row stride
// `stride`: a lane walks down a column, neighbouring lanes reading
// neighbouring addresses of a row.
__device__ __forceinline__ void stage(float* s, int stride, const float* img, int W, int y0,
                                      int x0, int rows, int cols, int lane) {
  for (int c = lane; c < cols; c += 32) {
    const float* g = img + static_cast<size_t>(y0) * W + x0 + c;
    for (int r = 0; r < rows; ++r, g += W) cp_async4(s + r * stride + c, g);
  }
}

__device__ __forceinline__ void zero(float* s, int n, int lane) {
  for (int i = lane; i < n; i += 32) s[i] = 0.0f;
}

// A lane's slots: per thread j of the lane, P = 2 + 4 MV of them, in the
// order the reference thread adds them: the head (accumulator 0), MV
// rounds of four (accumulators 0-3), the tail (accumulator 0).
template <int MV>
struct Slot {
  static constexpr int P = 2 + 4 * MV;
  __host__ __device__ static constexpr int acc(int q) {
    return (q == 0 || q == P - 1) ? 0 : (q - 1) & 3;
  }
};

// The row sum of the lane's per-thread accumulators: the four added in
// order, the threads past 32 folded in (the reduce kernel's shared-memory
// step), then the shuffle tree.
template <int J>
__device__ __forceinline__ float finish(float (&acc)[J][4]) {
  float v[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    v[j] = __fadd_rn(__fadd_rn(__fadd_rn(acc[j][0], acc[j][1]), acc[j][2]), acc[j][3]);
  }
#pragma unroll
  for (int o = J / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < o; ++j) v[j] = __fadd_rn(v[j], v[j + o]);
  }
  float r = v[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r = __fadd_rn(r, __shfl_xor_sync(kFull, r, o));
  return r;
}

template <int J>
__device__ __forceinline__ void clear(float (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// J: threads of the reference reduction a lane plays (bw / 32); MV: rounds
// of four a thread reads at most
template <int J, int MV>
__global__ void __launch_bounds__(kMaxWarps * 32) klt_track_kernel(const __grid_constant__ Args a) {
  constexpr int P = Slot<MV>::P;
  constexpr int K = J * P;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= a.total) return;
  const int stream = n / a.N;
  const int w = a.w, px = a.px, ww = w * w;
  const int tw = w + 1;                // template window side: w + 1 taps
  float* s_t = smem + static_cast<size_t>(warp) * a.warp_floats;
  const int region = tw * px;          // a template window, at row stride px
  float* s_c = s_t + 3 * region;       // the current patch, py x px

  // the slots: window pixel e at r * px + c in the patch or a template
  // window; 0 (masked) where the thread has none
  int off[K];
  uint64_t on = 0;  // slot k holds a pixel
  {
    const int s = a.vec ? static_cast<int>((static_cast<unsigned>(n) & 3u) *
                                           static_cast<unsigned>(ww & 3) & 3u)
                        : 0;
    const int lead = s > 0 ? 4 - s : 0;     // row elements before the first vector
    const int end = s > 0 ? ww + s - 4 : ww;  // elements from there on
    const int tail = end - end % 4;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k / P, q = k % P;
      const int t = lane + 32 * j;
      int e = -1;
      if (a.vec) {
        if (q == 0) {
          if (s > 0 && t >= s && t < 4) e = t - s;
        } else if (q == P - 1) {
          if (tail + t < end) e = lead + tail + t;
        } else {
          const int idx = t + ((q - 1) >> 2) * a.bw;
          if (4 * idx + 3 < end) e = lead + 4 * idx + ((q - 1) & 3);
        }
      } else if (q != 0 && q != P - 1) {
        const int cand = t + ((q - 1) & 3) * a.bw + ((q - 1) >> 2) * 4 * a.bw;
        if (cand < ww) e = cand;
      }
      off[k] = e < 0 ? 0 : (e / w) * px + e % w;
      if (e >= 0) on |= 1ull << k;
    }
  }

  const float half = 0.5f * static_cast<float>(w - 1);
  const int hw = (w - 1) / 2;
  const float pos_x = a.pos[2 * n], pos_y = a.pos[2 * n + 1];
  float g_x = a.guess[2 * n], g_y = a.guess[2 * n + 1];
  bool status = a.valid[n];
  float min_eig0 = 0.0f;

  for (int l = a.n_levels - 1; l >= 0; --l) {
    const Level& L = a.lv[l];
    float pl_x = pos_x, pl_y = pos_y, pp_x, pp_y;
    if (a.raw) {
      pp_x = a.p_pad[2 * n];
      pp_y = a.p_pad[2 * n + 1];
    } else {
      pl_x = __fmul_rn(pos_x, L.scale);
      pl_y = __fmul_rn(pos_y, L.scale);
      g_x = __fmul_rn(g_x, 2.0f);
      g_y = __fmul_rn(g_y, 2.0f);
      if (L.py == 0) continue;
      pp_x = __fadd_rn(pl_x, static_cast<float>(a.pad_x));
      pp_y = __fadd_rn(pl_y, static_cast<float>(a.pad_y));
    }
    const int H = L.H, W = L.W, py = L.py;
    const size_t img = static_cast<size_t>(stream) * H * W;

    // _corners, y aligned down to 8
    const int ty0 = corner(pp_y, hw + kMY, max(H - py, 0)) / 8 * 8;
    const int tx0 = corner(pp_x, hw + a.mx, max(W - px, 0));
    const float c_x = __fadd_rn(pp_x, g_x), c_y = __fadd_rn(pp_y, g_y);
    const int cy0 = corner(c_y, hw + kMY, max(H - py, 0)) / 8 * 8;
    const int cx0 = corner(c_x, hw + a.mx, max(W - px, 0));

    // the template offset in its patch
    const float max_x = static_cast<float>(px - w - 1), max_y = static_cast<float>(py - w - 1);
    const float to_x = __fsub_rn(__fsub_rn(pp_x, half), static_cast<float>(tx0));
    const float to_y = __fsub_rn(__fsub_rn(pp_y, half), static_cast<float>(ty0));
    const bool t_in = to_x >= 0.0f && to_x <= max_x && to_y >= 0.0f && to_y <= max_y;
    const Tap tX = tap(clampf(to_x, 0.0f, max_x), px - w - 1);
    const Tap tY = tap(clampf(to_y, 0.0f, max_y), py - w - 1);

    // the windows: the template's w + 1 rows and columns from its tap on,
    // the whole current patch; zeros for a dead slot, as the extraction
    __syncwarp();  // the level before is done reading
    if (status) {
      const int y0 = ty0 + tY.i, x0 = tx0 + tX.i;
      stage(s_t, px, L.prev + img, W, y0, x0, tw, tw, lane);
      stage(s_t + region, px, L.gx + img, W, y0, x0, tw, tw, lane);
      stage(s_t + 2 * region, px, L.gy + img, W, y0, x0, tw, tw, lane);
      stage(s_c, px, L.curr + img, W, cy0, cx0, py, px, lane);
      cp_async_wait_all();
    } else {
      zero(s_t, 3 * region + py * px, lane);
    }
    __syncwarp();

    // T, Tx, Ty at the lane's pixels, and G
    float T[K], GX[K], GY[K];
    float acc11[J][4], acc12[J][4], acc22[J][4];
    clear(acc11);
    clear(acc12);
    clear(acc22);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T[k] = blend(s_t, off[k], px, tX, tY);
      GX[k] = blend(s_t + region, off[k], px, tX, tY);
      GY[k] = blend(s_t + 2 * region, off[k], px, tX, tY);
      if (on >> k & 1ull) {
        const int j = k / P, i = Slot<MV>::acc(k % P);
        acc11[j][i] = __fadd_rn(acc11[j][i], __fmul_rn(GX[k], GX[k]));
        acc12[j][i] = __fadd_rn(acc12[j][i], __fmul_rn(GX[k], GY[k]));
        acc22[j][i] = __fadd_rn(acc22[j][i], __fmul_rn(GY[k], GY[k]));
      }
    }
    const float a11 = finish(acc11), a12 = finish(acc12), a22 = finish(acc22);
    const float tr_half = __fmul_rn(__fadd_rn(a11, a22), 0.5f);
    const float det = __fsub_rn(__fmul_rn(a11, a22), __fmul_rn(a12, a12));
    const float disc = __fsqrt_rn(clamp_min0(__fsub_rn(__fmul_rn(tr_half, tr_half), det)));
    const float min_eig = __fmul_rn(__fsub_rn(tr_half, disc), a.inv_ww);
    const bool solvable = min_eig > a.min_eig_threshold && det > 1e-12f;
    status = status && t_in && solvable;
    const float inv_det = __fmul_rn(__frcp_rn(det > 1e-12f ? det : 1.0f), 1.0f);
    const float i11 = __fmul_rn(a22, inv_det);
    const float i12 = __fmul_rn(-a12, inv_det);
    const float i22 = __fmul_rn(a11, inv_det);

    // iterate: the current window at p_pad + d; a converged feature is
    // frozen, so it leaves the loop
    const float cb_x = static_cast<float>(cx0), cb_y = static_cast<float>(cy0);
    float d_x = g_x, d_y = g_y;
    bool conv = false;
    for (int it = 0; it < L.iters && !conv; ++it) {
      const float ox = __fsub_rn(__fsub_rn(__fadd_rn(pp_x, d_x), half), cb_x);
      const float oy = __fsub_rn(__fsub_rn(__fadd_rn(pp_y, d_y), half), cb_y);
      const bool in_patch = ox >= 0.0f && ox <= max_x && oy >= 0.0f && oy <= max_y;
      const Tap cX = tap(clampf(ox, 0.0f, max_x), px - w - 1);
      const Tap cY = tap(clampf(oy, 0.0f, max_y), py - w - 1);
      const int base = cY.i * px + cX.i;
      float acc1[J][4], acc2[J][4];
      clear(acc1);
      clear(acc2);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float diff = __fsub_rn(blend(s_c, base + off[k], px, cX, cY), T[k]);
        if (on >> k & 1ull) {
          const int j = k / P, i = Slot<MV>::acc(k % P);
          acc1[j][i] = __fadd_rn(acc1[j][i], __fmul_rn(diff, GX[k]));
          acc2[j][i] = __fadd_rn(acc2[j][i], __fmul_rn(diff, GY[k]));
        }
      }
      const float b1 = finish(acc1), b2 = finish(acc2);
      const float du = -__fadd_rn(__fmul_rn(i11, b1), __fmul_rn(i12, b2));
      const float dv = -__fadd_rn(__fmul_rn(i12, b1), __fmul_rn(i22, b2));
      if (in_patch) {
        d_x = __fadd_rn(d_x, du);
        d_y = __fadd_rn(d_y, dv);
      }
      conv = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) < a.eps2 || !in_patch;
    }

    // lost if the final window left its patch (1 px of slack) or p_lvl + d
    // left the true level image
    const float fo_x = __fsub_rn(__fsub_rn(__fadd_rn(pp_x, d_x), half), cb_x);
    const float fo_y = __fsub_rn(__fsub_rn(__fadd_rn(pp_y, d_y), half), cb_y);
    const bool inside_patch = fo_x >= -1.0f && fo_x <= static_cast<float>(px - w) &&
                              fo_y >= -1.0f && fo_y <= static_cast<float>(py - w);
    const float q_x = __fadd_rn(pl_x, d_x), q_y = __fadd_rn(pl_y, d_y);
    const bool inside = q_x >= 0.0f && q_x < static_cast<float>(W - 2 * a.pad_x) &&
                        q_y >= 0.0f && q_y < static_cast<float>(H - 2 * a.pad_y);
    status = status && inside && inside_patch;
    g_x = d_x;
    g_y = d_y;
    if (l == 0) min_eig0 = min_eig;
  }

  if (lane < 4) {
    const float v = lane == 0 ? g_x : lane == 1 ? g_y : lane == 2 ? min_eig0 : (status ? 1.0f : 0.0f);
    a.out[4 * static_cast<size_t>(n) + lane] = v;
  }
}

// Warps a block by the number of features: 1 up to 264 (two blocks a SM on
// 132 SMs), 4 above, lk_level.cu's rule. Read on an H100 80GB HBM3 at 700 W,
// 8 streams (device us a launch, 1 / 2 / 4 / 8 warps a block above 264
// features): temporal call (4 levels, N = 128) 59.5 / 57.6 / 57.6 / 59.6,
// stereo (N = 192) 26.7 / 31.2 / 31.2 / 35.9, fb 23.2 / 18.7 / 18.4 / 18.6;
// a tracking step runs a temporal and an fb call, the stereo call only a
// keyframe step, so 4 (or 2) is the least a step. One stream's calls sit
// below 264 and take 1.
template <int J, int MV>
cudaError_t launch(Args& a, cudaStream_t stream) {
  const int bytes = a.warp_floats * static_cast<int>(sizeof(float));
  const int warps = a.total <= 264 ? 1 : std::max(1, std::min(kMaxWarps, kSmemOptIn / bytes));
  // the attribute belongs to the current device: set on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      klt_track_kernel<J, MV>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (err != cudaSuccess) return err;
  const int blocks = (a.total + warps - 1) / warps;
  klt_track_kernel<J, MV><<<blocks, warps * 32, warps * bytes, stream>>>(a);
  return cudaGetLastError();
}

// the instantiation whose J is bw / 32 and whose MV holds per_thread
// rounds; cudaErrorInvalidValue for a split it does not have
cudaError_t dispatch(Args& a, int per_thread, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int J = a.bw / 32;
  if (a.bw % 32 == 0 && per_thread >= 1) {
    if (J == 1 && per_thread <= 1) return launch<1, 1>(a, s);
    if (J == 1 && per_thread <= 4) return launch<1, 4>(a, s);
    if (J == 1 && per_thread <= 8) return launch<1, 8>(a, s);
    if (J == 2 && per_thread <= 2) return launch<2, 2>(a, s);
    if (J == 2 && per_thread <= 4) return launch<2, 4>(a, s);
    if (J == 4 && per_thread <= 2) return launch<4, 2>(a, s);
  }
  return cudaErrorInvalidValue;
}

// shared floats a warp: the template's three (w + 1)-row windows and a
// py x px patch, at row stride px; false where they do not fit
bool size_warp(Args& a, int max_py) {
  a.warp_floats = 3 * (a.w + 1) * a.px + max_py * a.px;
  return a.w >= 2 && a.px >= a.w + 2 && a.warp_floats * static_cast<int>(sizeof(float)) <= kSmemOptIn;
}

void common(Args& a, int S, const void* guess, const void* valid, int N, int window, int px,
            int margin_x, int pad_x, int pad_y, float eps2, float min_eig_threshold,
            int block_width, int vectorised, void* out) {
  a.guess = static_cast<const float*>(guess);
  a.valid = static_cast<const uint8_t*>(valid);
  a.out = static_cast<float*>(out);
  a.N = N;
  a.total = S * N;
  a.w = window;
  a.px = px;
  a.mx = margin_x;
  a.pad_x = pad_x;
  a.pad_y = pad_y;
  a.eps2 = eps2;
  a.min_eig_threshold = min_eig_threshold;
  a.inv_ww = 1.0f / static_cast<float>(window * window);
  a.bw = block_width;
  a.vec = vectorised;
}

}  // namespace

// A whole tracker call: n_levels levels, level 0 first. imgs holds
// 4 * n_levels device pointers (prev, gx, gy, curr per level) and dims
// 4 * n_levels ints (H, W, py, iters per level; py 0 skips the level),
// both host arrays. pos in level-0 image coordinates, guess at twice the
// top level's scale, out (S*N, 4). block_width, vectorised, per_thread:
// the row sums' split (ops/klt_track.py::sum_plan).
extern "C" int svo_klt_track(
    const void* const* imgs, const int* dims, int n_levels, int S, const void* pos,
    const void* guess, const void* valid, int N, int window, int px, int margin_x, int pad_x,
    int pad_y, float eps2, float min_eig_threshold, int block_width, int vectorised,
    int per_thread, void* out, void* stream) {
  if (S <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (n_levels < 1 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  int max_py = 0;
  float scale = 1.0f;
  for (int l = 0; l < n_levels; ++l, scale *= 0.5f) {
    Level& L = a.lv[l];
    L.prev = static_cast<const float*>(imgs[4 * l]);
    L.gx = static_cast<const float*>(imgs[4 * l + 1]);
    L.gy = static_cast<const float*>(imgs[4 * l + 2]);
    L.curr = static_cast<const float*>(imgs[4 * l + 3]);
    L.H = dims[4 * l];
    L.W = dims[4 * l + 1];
    L.py = dims[4 * l + 2];
    L.iters = dims[4 * l + 3];
    L.scale = scale;
    if (L.py != 0 && (L.py < window + 2 || L.py > L.H || px > L.W)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    max_py = std::max(max_py, L.py);
  }
  a.n_levels = n_levels;
  a.pos = static_cast<const float*>(pos);
  a.raw = 0;
  common(a, S, guess, valid, N, window, px, margin_x, pad_x, pad_y, eps2, min_eig_threshold,
         block_width, vectorised, out);
  if (!size_warp(a, max_py)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(a, per_thread, stream));
}

// One level (ops/klt.py::_patch_level's contract): images (S, H, W), p_lvl
// and p_pad (S*N, 2), the level's guess, status in; out (S*N, 4) d, the
// level's min_eig, status.
extern "C" int svo_klt_track_level(
    const void* prev, const void* gx, const void* gy, const void* curr, int S, int H, int W,
    const void* p_lvl, const void* p_pad, const void* guess, const void* valid, int N,
    int window, int py, int px, int margin_x, int iters, int pad_x, int pad_y, float eps2,
    float min_eig_threshold, int block_width, int vectorised, int per_thread, void* out,
    void* stream) {
  if (S <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (py < window + 2 || py > H || px > W) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  Level& L = a.lv[0];
  L.prev = static_cast<const float*>(prev);
  L.gx = static_cast<const float*>(gx);
  L.gy = static_cast<const float*>(gy);
  L.curr = static_cast<const float*>(curr);
  L.H = H;
  L.W = W;
  L.py = py;
  L.iters = iters;
  L.scale = 1.0f;
  a.n_levels = 1;
  a.pos = static_cast<const float*>(p_lvl);
  a.p_pad = static_cast<const float*>(p_pad);
  a.raw = 1;
  common(a, S, guess, valid, N, window, px, margin_x, pad_x, pad_y, eps2, min_eig_threshold,
         block_width, vectorised, out);
  if (!size_warp(a, py)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(a, per_thread, stream));
}
