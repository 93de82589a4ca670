// Pyramidal Lucas-Kanade for one tracker call, all levels in one launch.
//
// Replaces the TPU kernel svo_tpu/ops/lk_pallas.py::_call (pallas_call,
// kernel body _kernel, entry lk_track_level). One LEVEL of that kernel, for
// each of N features: sample the template window T and its gradients Tx, Ty
// at the feature's fractional position in the previous level, form the 2x2
// normal matrix G with its min-eigenvalue/determinant gate, run max_iters
// masked LK updates against the current level inside a travel box of
// 2*margin px per axis. The geometry is the TPU kernel's, as
// svo_tpu_torch/ops/lk_fused.py states it.
//
// What one launch covers. The TPU kernel is one level per call because a
// pallas_call has one image shape; the tracker ran it once per pyramid
// level with a dozen small tensor ops between two calls. Those ops couple no
// two features: the level loop is a serial chain per feature. Here the
// kernel takes a by-value table of up to 8 levels (four image pointers, H,
// W, py, max_iters and the scale 1/2^level each) and one warp carries its
// feature's flow and status in registers from the coarsest level of the
// table to level 0: p_lvl = pos * scale, guess *= 2, p_pad = p_lvl + pad,
// the level, d = guess + (o - o0), status &= solvable & inside(p_lvl + d) &
// in_patch, guess = d. A slot whose status fell is a dead slot at the next
// level: it reads nothing and keeps its guess. That glue is written with
// the roundings of the tensor ops it replaces (__fadd_rn, __fmul_rn, no
// contraction; the scalings are by powers of two and exact), so one
// whole-call launch is bit-equal to the chain of per-level launches
// (svo_lk_level, the one-level case of the same kernel: the table holds one
// level, the glue is skipped and the level's 8 raw floats are written).
// lk_fused.py's lk_track_pyramid_ref / lk_track_level_ref are the plain
// versions the two entries are held against.
//
// What bounds it: very little data and very little arithmetic. A temporal
// feature (window 21, margins 6/6) reads per level three 24x24 template
// windows and one 34x34 current window, ~11.5 KB, and does ~50 kflop over 8
// iterations; a 4-level call of N=128 features moves ~6 MB. So a call is
// bound by its launch and by the latency of one feature's serial chain
// (per level: stage, template, 8 x (sample, two warp reductions, 2x2
// update)), not by memory bandwidth or flops.
//
// Design: one warp per feature. The warp stages its windows in shared
// memory; each lane then owns a fixed set of window pixels and holds T, Tx,
// Ty and the pixels' offsets in registers for all iterations. G, b1 and b2
// are butterfly warp-shuffle sums, so every lane holds the same scalars and
// the update stays in registers with no block synchronisation. There are no
// atomics: two launches on the same inputs give bit-identical outputs.
// Corners are clamped after the float->int cast, so a non-finite position
// or guess cannot index out of range. Against the latency of the chain:
// - staging gives a lane one column of a window to walk down (uniform
//   control flow, no integer division per element) and copies with
//   cp.async (4 bytes each: window starts are unaligned), so all of a
//   window's loads are in flight together;
// - the next level's three template windows depend only on pos, not on the
//   flow, so their copy into a second template buffer can be started before
//   the current level iterates and waited on after, whenever the table has
//   more than one level. Two template buffers plus the current window are
//   ~18.4 KB per temporal feature; blocks above 48 KB of shared memory opt
//   in with cudaFuncSetAttribute;
// - window loads from shared memory are unconditional: a lane's slot past
//   the window (only its last one can be) samples pixel 0 and is masked out
//   of the sums. With a branch around each pixel the compiler issued a
//   pixel's four loads only after the pixel before it was done; without it
//   all loads of an iteration are in flight together;
// - warps per block: one stream has 128 features for 132 SMs, so few warps
//   per block spread them over the card: the launcher takes 1 warp a block
//   up to 264 features (two a SM) and 4 above (launch(), with the readings
//   that chose them).
// TMA does not apply to these windows: a tensor map needs a row pitch that
// is a multiple of 16 bytes, and a padded level's is (W_true + 64) * 4
// (5220, 2740, 1500, 876 bytes at 1241 px wide); window starts are unaligned
// too. Tensor cores have nothing to do here (a 2x2 system per feature).
//
// The stream axis (the TPU kernel's batched form, lk_pallas.py _batched,
// grid (S, N/8) over (S, H, W) images) is part of the same launch: the
// grid covers S*N features, and a warp's feature index n gives its stream
// n / N and so the base of its images, img + (n / N) * H * W at each level.
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
constexpr int kMaxWarps = 4;        // features per block, at most
constexpr int kMaxLevels = 8;
constexpr int kSmemOptIn = 227 * 1024;

struct Level {
  const float* prev;      // (S, H, W), like gx, gy, curr
  const float* gx;
  const float* gy;
  const float* curr;
  int H, W, py, max_iters;
  float scale;            // 1 / 2^level
};

struct TrackArgs {
  Level lv[kMaxLevels];   // lv[0] is level 0; the kernel runs n_levels-1 .. 0
  int n_levels;
  const float* pos;       // (S*N, 2) x, y: level-0 image coordinates, or
                          // padded level coordinates when raw
  const float* guess;     // (S*N, 2): flow at twice the top level's scale,
                          // or the level's guess when raw
  const uint8_t* valid;   // (S*N,) bool
  float* out;             // (S*N, 4) dx, dy, min_eig of level 0, status; or
                          // (S*N, 8) dx, dy rel. to the guess, min_eig,
                          // solvable, in_patch, 0, 0, 0 when raw
  int N, total, w, mx, my;  // total = S * N
  float eps2, min_eig_threshold, pad_x, pad_y;
  int raw;                // the per-level entry: one level, no glue
  int tpl_floats;         // shared floats of one template buffer (3 windows)
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for this thread's copy groups: all of them, or all but the newest
__device__ __forceinline__ void cp_async_wait(bool keep_last) {
  if (keep_last) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy the rows x cols window of img at (iy, ix) into s, row-major. The
// last row and column only ever get weight 0 and are read clamped to the
// image. A lane owns a column (two where the window is wider than 32) and
// walks down its rows: the warp's control flow is uniform, one copy is an
// add and a compare away from the next, and neighbouring lanes read
// neighbouring addresses of a row.
__device__ __forceinline__ void stage_window(
    float* s, const float* img, int iy, int ix, int rows, int cols, int H, int W,
    int lane) {
  for (int c = lane; c < cols; c += 32) {
    const float* g = img + static_cast<size_t>(min(iy, H - 1)) * W + min(ix + c, W - 1);
    float* d = s + c;
    for (int r = 0; r < rows; ++r, d += cols) {
      cp_async4(d, g);
      if (iy + r < H - 1) g += W;
    }
  }
}

// where a feature's template windows start at a level, from its position
struct TplCorner {
  int iy, ix;
};

__device__ __forceinline__ TplCorner tpl_corner(const Level& L, float p_x, float p_y, float half) {
  TplCorner t;
  t.iy = corner(p_y - half, 0, L.H - L.py);
  t.ix = corner(p_x - half, 0, L.W - kPX);
  return t;
}

// the three tw x tw template windows (prev, gx, gy) share their addresses
__device__ __forceinline__ void stage_templates(
    float* s_tpl, const Level& L, size_t img, TplCorner t, int tw, int lane) {
  const int n = tw * tw;
  for (int c = lane; c < tw; c += 32) {
    size_t g = img + static_cast<size_t>(min(t.iy, L.H - 1)) * L.W + min(t.ix + c, L.W - 1);
    float* d = s_tpl + c;
    for (int r = 0; r < tw; ++r, d += tw) {
      cp_async4(d, L.prev + g);
      cp_async4(d + n, L.gx + g);
      cp_async4(d + 2 * n, L.gy + g);
      if (t.iy + r < L.H - 1) g += L.W;
    }
  }
}

// a level-0 coordinate at a level: pos * 2^-level, exact like pos / 2^level
__device__ __forceinline__ float to_level(float p, float scale) { return __fmul_rn(p, scale); }

struct LevelResult {
  float dx, dy;       // of - o0: the flow this level added to its guess
  float min_eig;
  bool solvable, in_fin;
};

// K: window pixels per lane, ceil(w*w / 32) rounded up to an instantiation
template <int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
lk_level_kernel(const __grid_constant__ TrackArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= a.total) return;
  const int stream = n / a.N;

  const int w = a.w, ww = w * w;
  const int tw = w + 3;                // template window side: 2 + 1 taps
  const int cw = w + 2 * a.mx + 1;     // current window cols
  const int ch = w + 2 * a.my + 1;     // current window rows
  // the next level's templates are copied ahead where there is a next level
  const bool prefetch = a.n_levels > 1;
  // [template buffer 0][template buffer 1, with prefetch][current window]
  float* s_warp = smem + warp * a.warp_floats;
  float* s_c = s_warp + (prefetch ? 2 : 1) * a.tpl_floats;

  const float half = (w - 1) * 0.5f;
  const float Rx = static_cast<float>(2 * a.mx);
  const float Ry = static_cast<float>(2 * a.my);
  const float pos_x = a.pos[2 * n], pos_y = a.pos[2 * n + 1];
  float guess_x = a.guess[2 * n], guess_y = a.guess[2 * n + 1];
  bool status = a.valid[n];
  float min_eig0 = 0.0f;
  bool ahead = false;                  // this level's templates were prefetched

  for (int l = a.n_levels - 1; l >= 0; --l) {
    const Level& L = a.lv[l];
    const size_t img = static_cast<size_t>(stream) * L.H * L.W;  // the stream's image
    float* s_t = s_warp + (prefetch && (l & 1) ? a.tpl_floats : 0);
    float* s_gx = s_t + tw * tw;
    float* s_gy = s_gx + tw * tw;

    // level coordinates and the doubled guess, as the tensor ops round them
    float pl_x = pos_x, pl_y = pos_y, p_x = pos_x, p_y = pos_y;
    if (!a.raw) {
      pl_x = to_level(pos_x, L.scale);
      pl_y = to_level(pos_y, L.scale);
      p_x = __fadd_rn(pl_x, a.pad_x);
      p_y = __fadd_rn(pl_y, a.pad_y);
      guess_x = __fmul_rn(guess_x, 2.0f);
      guess_y = __fmul_rn(guess_y, 2.0f);
    }

    const float tx = p_x - half, ty = p_y - half;
    const float cx = (p_x + guess_x) - half;
    const float cy = (p_y + guess_y) - half;
    const TplCorner tc = tpl_corner(L, p_x, p_y, half);
    const int t_iy = tc.iy, t_ix = tc.ix;
    const int c_iy = corner(cy, a.my, L.H - L.py), c_ix = corner(cx, a.mx, L.W - kPX);
    float t_ox = tx - static_cast<float>(t_ix), t_oy = ty - static_cast<float>(t_iy);
    const float o0x = cx - static_cast<float>(c_ix), o0y = cy - static_cast<float>(c_iy);
    const bool t_in = t_ox >= 0.0f && t_ox <= kTplMax && t_oy >= 0.0f && t_oy <= kTplMax;
    t_ox = clip(t_ox, 0.0f, kTplMax);
    t_oy = clip(t_oy, 0.0f, kTplMax);

    float ox = o0x, oy = o0y, min_eig = 0.0f;
    bool solvable = false;
    // the windows of the level before are read no more
    __syncwarp();
    if (status) {
      if (!ahead) stage_templates(s_t, L, img, tc, tw, lane);
      stage_window(s_c, L.curr + img, c_iy, c_ix, ch, cw, L.H, L.W, lane);
      cp_async_commit();
      ahead = l > 0;
      if (ahead) {
        // the next level's templates: they depend on pos alone
        const Level& Ln = a.lv[l - 1];
        const float q_x = __fadd_rn(to_level(pos_x, Ln.scale), a.pad_x);
        const float q_y = __fadd_rn(to_level(pos_y, Ln.scale), a.pad_y);
        stage_templates(s_warp + ((l - 1) & 1 ? a.tpl_floats : 0), Ln,
                        static_cast<size_t>(stream) * Ln.H * Ln.W,
                        tpl_corner(Ln, q_x, q_y, half), tw, lane);
        cp_async_commit();
      }
      cp_async_wait(ahead);
      __syncwarp();

      // template and gradients, once; G from them
      const Taps tX = taps(t_ox, 2), tY = taps(t_oy, 2);
      float T[K], GX[K], GY[K];
      int off[K];  // the pixel's offset in the current window
      float a11 = 0.0f, a12 = 0.0f, a22 = 0.0f;
      // Lane l owns pixels e = l + 32 k of the window, row-major. A slot past
      // the window (only the last k has any) samples pixel 0 and is masked
      // out: the loads stay unconditional, so the compiler issues all of
      // them before the first use instead of branching around each pixel.
      int tb[K];   // the pixel's offset in a template window
      int r = 0, c = lane;
      while (c >= w) { c -= w; ++r; }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool on = lane + 32 * k < ww;
        tb[k] = on ? r * tw + c : 0;
        off[k] = on ? r * cw + c : 0;
        c += 32;
        while (c >= w) { c -= w; ++r; }
      }
      const int tb0 = tY.a * tw + tX.a;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool on = lane + 32 * k < ww;
        const float t = bilerp(s_t, tb0 + tb[k], tw, tX, tY);
        const float tgx = bilerp(s_gx, tb0 + tb[k], tw, tX, tY);
        const float tgy = bilerp(s_gy, tb0 + tb[k], tw, tX, tY);
        T[k] = on ? t : 0.0f;
        GX[k] = on ? tgx : 0.0f;
        GY[k] = on ? tgy : 0.0f;
        if (on) {
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
      for (int it = 0; it < L.max_iters; ++it) {
        const float in_patch = (ox >= 0.0f && ox <= Rx && oy >= 0.0f && oy <= Ry) ? 1.0f : 0.0f;
        const Taps cX = taps(clip(ox, 0.0f, Rx), 2 * a.mx);
        const Taps cY = taps(clip(oy, 0.0f, Ry), 2 * a.my);
        const int b = cY.a * cw + cX.a;
        float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float diff = bilerp(s_c, b + off[k], cw, cX, cY) - T[k];
          if (lane + 32 * k < ww) {
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
    const float out_x = __fsub_rn(ox, o0x), out_y = __fsub_rn(oy, o0y);
    if (a.raw) {
      if (lane < 8) {
        float v = 0.0f;
        if (lane == 0) v = out_x;
        else if (lane == 1) v = out_y;
        else if (lane == 2) v = min_eig;
        else if (lane == 3) v = solvable ? 1.0f : 0.0f;
        else if (lane == 4) v = in_fin ? 1.0f : 0.0f;
        a.out[8 * static_cast<size_t>(n) + lane] = v;
      }
    } else {
      // d = guess + out; lost if not solvable, if the window left its travel
      // box, or if p_lvl + d left the TRUE level image; the flow carries on
      guess_x = __fadd_rn(guess_x, out_x);
      guess_y = __fadd_rn(guess_y, out_y);
      const float q_x = __fadd_rn(pl_x, guess_x), q_y = __fadd_rn(pl_y, guess_y);
      const float Wt = static_cast<float>(L.W) - 2.0f * a.pad_x;
      const float Ht = static_cast<float>(L.H) - 2.0f * a.pad_y;
      const bool inside = q_x >= 0.0f && q_x < Wt && q_y >= 0.0f && q_y < Ht;
      status = status && solvable && inside && in_fin;
      if (l == 0) min_eig0 = min_eig;
    }
  }
  cp_async_wait(false);  // a prefetch for a slot that fell since

  if (!a.raw && lane < 4) {
    const float v = lane == 0 ? guess_x : lane == 1 ? guess_y : lane == 2 ? min_eig0
                                                                           : (status ? 1.0f : 0.0f);
    a.out[4 * static_cast<size_t>(n) + lane] = v;
  }
}

// Warps per block by the number of features: 1 up to 264 (two blocks a SM
// on 132 SMs), 4 above. Read on an H100 80GB HBM3 at 700 W, temporal call (4
// levels, window 21): 1, 2 and 4 warps a block lie within 5% of each other
// for 128 and for 1024 features, 1 ahead for 128 and 4 for 1024; 8 warps a
// block cost up to 30% for 128. cp.async staging took 20-25% off a launch's
// device time against plain loads, the templates copied ahead another 2-6%.
template <int K>
cudaError_t launch(TrackArgs& a, cudaStream_t stream) {
  const int tw = a.w + 3;
  a.tpl_floats = 3 * tw * tw;
  a.warp_floats = (a.n_levels > 1 ? 2 : 1) * a.tpl_floats +
                  (a.w + 2 * a.my + 1) * (a.w + 2 * a.mx + 1);
  const int bytes = a.warp_floats * static_cast<int>(sizeof(float));
  const int warps = a.total <= 264 ? 1 : std::max(1, std::min(kMaxWarps, kSmemOptIn / bytes));
  // the attribute belongs to the current device: set on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      lk_level_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (err != cudaSuccess) return err;
  const int blocks = (a.total + warps - 1) / warps;
  lk_level_kernel<K><<<blocks, warps * 32, warps * bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(TrackArgs& a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = (a.w * a.w + 31) / 32;
  return slots <= 4 ? launch<4>(a, s) : slots <= 14 ? launch<14>(a, s) : launch<32>(a, s);
}

bool bad_geometry(int window, int margin_x, int margin_y) {
  return window < 1 || window > 32 || margin_x < 0 || margin_y < 0 ||
         window + 2 * margin_x + 1 > kPX;
}

}  // namespace

// One level (the counterpart of lk_pallas.lk_track_level): pos in padded
// level coordinates, out (S*N, 8).
extern "C" int svo_lk_level(
    const void* prev, const void* gx, const void* gy, const void* curr,
    int S, int H, int W, const void* pos, const void* guess,
    const void* valid, int N, int window, int py, int margin_x, int margin_y, int max_iters,
    float eps2, float min_eig_threshold, void* out, void* stream) {
  if (S <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (bad_geometry(window, margin_x, margin_y) || H < py || W < kPX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TrackArgs a = {};
  a.lv[0].prev = static_cast<const float*>(prev);
  a.lv[0].gx = static_cast<const float*>(gx);
  a.lv[0].gy = static_cast<const float*>(gy);
  a.lv[0].curr = static_cast<const float*>(curr);
  a.lv[0].H = H;
  a.lv[0].W = W;
  a.lv[0].py = py;
  a.lv[0].max_iters = max_iters;
  a.lv[0].scale = 1.0f;
  a.n_levels = 1;
  a.pos = static_cast<const float*>(pos);
  a.guess = static_cast<const float*>(guess);
  a.valid = static_cast<const uint8_t*>(valid);
  a.out = static_cast<float*>(out);
  a.N = N;
  a.total = S * N;
  a.w = window;
  a.mx = margin_x;
  a.my = margin_y;
  a.eps2 = eps2;
  a.min_eig_threshold = min_eig_threshold;
  a.raw = 1;
  return static_cast<int>(dispatch(a, stream));
}

// A whole tracker call: n_levels levels, level 0 first. imgs holds
// 4 * n_levels device pointers (prev, gx, gy, curr per level) and dims
// 4 * n_levels ints (H, W, py, max_iters per level), both host arrays. pos
// in level-0 image coordinates, guess at twice the top level's scale, out
// (S*N, 4).
extern "C" int svo_lk_track(
    const void* const* imgs, const int* dims, int n_levels, int S,
    const void* pos, const void* guess, const void* valid, int N, int window,
    int margin_x, int margin_y, float pad_x, float pad_y, float eps2,
    float min_eig_threshold, void* out, void* stream) {
  if (S <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (bad_geometry(window, margin_x, margin_y) || n_levels < 1 || n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TrackArgs a = {};
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
    L.max_iters = dims[4 * l + 3];
    L.scale = scale;
    if (L.H < L.py || L.W < kPX) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_levels = n_levels;
  a.pos = static_cast<const float*>(pos);
  a.guess = static_cast<const float*>(guess);
  a.valid = static_cast<const uint8_t*>(valid);
  a.out = static_cast<float*>(out);
  a.N = N;
  a.total = S * N;
  a.w = window;
  a.mx = margin_x;
  a.my = margin_y;
  a.pad_x = pad_x;
  a.pad_y = pad_y;
  a.eps2 = eps2;
  a.min_eig_threshold = min_eig_threshold;
  a.raw = 0;
  return static_cast<int>(dispatch(a, stream));
}
