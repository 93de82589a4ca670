// FAST-9/16 score, 3x3 non-maximum suppression and the suppression mask in
// one launch for every stream: what
// torch.where(suppress, 0, nms3x3(fast_score(img, thr))) gives
// (ops/fast.py::fast_nms_ref), bit for bit.
//
// Not a Pallas kernel: svo_tpu/ops/fast.py and svo_tpu/ops/nms.py are plain
// jnp, which XLA fuses on the TPU. The port's plain PyTorch version builds
// 16 rolled copies of the image, stacks them into a 24-deep array and runs
// 16 windows of two amin passes over 9 planes each: ~130 launches and ~876
// whole-image reads and writes a call (~1.6 GB at 376x1241), then 6 more
// launches for the NMS and the mask. On the fleet's keyframe steps that was
// the largest share of `replenish` (30-40 ms of a 57 ms keyframe step at 64
// streams on an H100).
//
// What bounds it: bytes. One read of the image and the mask and one write of
// the score: 9 bytes a pixel, ~4.2 MB for a 376x1241 image. A pixel costs
// ~200 min/max/sub operations where it is scored in full, and ~10 where the
// compass test below rejects it, which is most pixels of a natural image.
//
// The design: one block per (output tile of kTileH x kTileW, stream). The
// block stages its tile plus a 4-pixel halo of the image in shared memory
// with coalesced loads (3 pixels for the Bresenham ring, 1 for the NMS),
// scores the tile plus a 1-pixel ring into shared memory, then applies the
// NMS and the mask and stores the tile with coalesced writes. Nothing but
// the score is written to device memory.
//
// Bit-equality with the plain path: every step rounds once or not at all.
// d = ring - centre is one __fsub_rn (torch.roll copies, then one
// subtraction). The bright arc is the max over the 16 circular starts of
// the min over 9 of d; the dark arc the same over -d, computed as
// -(min over starts of the max over 9 of d), since min(-w) == -max(w)
// exactly; min and max are exact in any order, so the 9-wide windows are
// built from pairwise, 4-wide and 8-wide ones. score = max(max(bright,
// dark) - thr, 0), the subtraction one __fsub_rn. A pixel with fewer than
// 2 of the 4 compass ring points (0, 4, 8, 12) above thr and fewer than 2
// below -thr scores exactly 0 without the windows: any 9 contiguous ring
// points hold at least 2 compass points, so its arcs are <= thr, and x - thr
// <= 0 for x <= thr in round-to-nearest. The 3-pixel border scores exactly 0
// (the plain path's `interior` mask; its roll wraps around the image, the
// halo here does not, and no interior pixel's ring leaves the image). The
// NMS keeps a score that is >= every in-image 3x3 neighbour and > 0, ties
// all kept; an interior pixel's neighbours all lie in the image, and a
// border pixel scores 0, so max_pool2d's -inf padding never decides.
//
// Launches on the caller's stream, allocates nothing, does not synchronise,
// so a CUDA graph captures it.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kThreads = 256;
constexpr int kHalo = 4;                   // 3 for the ring, 1 for the NMS
constexpr int kImgW = kTileW + 2 * kHalo;  // staged image
constexpr int kImgH = kTileH + 2 * kHalo;
constexpr int kScoreW = kTileW + 2;        // scored: the tile and a 1-pixel ring
constexpr int kScoreH = kTileH + 2;

// The FAST-9 score of the pixel at (cy, cx) of the staged image.
__device__ __forceinline__ float fast_score(const float (*img)[kImgW], int cy, int cx,
                                            float thr) {
  const float c = img[cy][cx];
  // ring minus centre: OpenCV's 16-point Bresenham circle of radius 3,
  // clockwise from 12 o'clock (ops/fast.py::RING), offsets as immediates
  const float d[16] = {
      __fsub_rn(img[cy - 3][cx + 0], c), __fsub_rn(img[cy - 3][cx + 1], c),
      __fsub_rn(img[cy - 2][cx + 2], c), __fsub_rn(img[cy - 1][cx + 3], c),
      __fsub_rn(img[cy + 0][cx + 3], c), __fsub_rn(img[cy + 1][cx + 3], c),
      __fsub_rn(img[cy + 2][cx + 2], c), __fsub_rn(img[cy + 3][cx + 1], c),
      __fsub_rn(img[cy + 3][cx + 0], c), __fsub_rn(img[cy + 3][cx - 1], c),
      __fsub_rn(img[cy + 2][cx - 2], c), __fsub_rn(img[cy + 1][cx - 3], c),
      __fsub_rn(img[cy + 0][cx - 3], c), __fsub_rn(img[cy - 1][cx - 3], c),
      __fsub_rn(img[cy - 2][cx - 2], c), __fsub_rn(img[cy - 3][cx - 1], c),
  };
  const float nthr = -thr;
  const int n_bright = (d[0] > thr) + (d[4] > thr) + (d[8] > thr) + (d[12] > thr);
  const int n_dark = (d[0] < nthr) + (d[4] < nthr) + (d[8] < nthr) + (d[12] < nthr);
  if (n_bright < 2 && n_dark < 2) return 0.0f;
  // sliding windows over the circular ring: lo[i] = min of d[i .. i+w-1],
  // hi[i] = max, for w = 2, 4, 8, then 9
  float lo2[16], hi2[16], lo4[16], hi4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo2[i] = fminf(d[i], d[(i + 1) & 15]);
    hi2[i] = fmaxf(d[i], d[(i + 1) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo4[i] = fminf(lo2[i], lo2[(i + 2) & 15]);
    hi4[i] = fmaxf(hi2[i], hi2[(i + 2) & 15]);
  }
  float bright = -CUDART_INF_F, dark_neg = CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float lo9 = fminf(fminf(lo4[i], lo4[(i + 4) & 15]), d[(i + 8) & 15]);
    const float hi9 = fmaxf(fmaxf(hi4[i], hi4[(i + 4) & 15]), d[(i + 8) & 15]);
    bright = fmaxf(bright, lo9);
    dark_neg = fminf(dark_neg, hi9);
  }
  const float s = __fsub_rn(fmaxf(bright, -dark_neg), thr);
  return s > 0.0f ? s : 0.0f;
}

__global__ void __launch_bounds__(kThreads) fast_nms_kernel(
    const float* __restrict__ img,        // (S, H, W)
    const uint8_t* __restrict__ suppress,  // (S, H, W) bool, or null
    float* __restrict__ out,              // (S, H, W)
    int H, int W, float thr) {
  __shared__ float s_img[kImgH][kImgW];
  __shared__ float s_score[kScoreH][kScoreW];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const size_t base = static_cast<size_t>(blockIdx.z) * H * W;
  const float* im = img + base;

  // 1. the tile and its halo; outside the image nothing reads what is staged
  for (int i = threadIdx.x; i < kImgH * kImgW; i += kThreads) {
    const int r = i / kImgW, c = i - r * kImgW;
    const int gy = y0 - kHalo + r, gx = x0 - kHalo + c;
    s_img[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                      ? im[static_cast<size_t>(gy) * W + gx] : 0.0f;
  }
  __syncthreads();

  // 2. the score of the tile and a 1-pixel ring; 0 on the 3-pixel border
  for (int i = threadIdx.x; i < kScoreH * kScoreW; i += kThreads) {
    const int r = i / kScoreW, c = i - r * kScoreW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    const bool interior = gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3;
    s_score[r][c] = interior ? fast_score(s_img, r + kHalo - 1, c + kHalo - 1, thr) : 0.0f;
  }
  __syncthreads();

  // 3. NMS over the 3x3 neighbourhood, then the mask
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i - r * kTileW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    const float s = s_score[r + 1][c + 1];
    float m = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, s_score[r + dy][c + dx]);
    }
    const size_t at = base + static_cast<size_t>(gy) * W + gx;
    const bool keep = s >= m && s > 0.0f && (suppress == nullptr || suppress[at] == 0);
    out[at] = keep ? s : 0.0f;
  }
}

}  // namespace

// img, out: (S, H, W) float32 contiguous device buffers; suppress: (S, H, W)
// bool or null. Returns cudaGetLastError() after the launch.
extern "C" int svo_fast_nms(const void* img, const void* suppress, void* out, int S, int H,
                            int W, float thr, void* stream) {
  if (S < 1 || S > 65535 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, S);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  fast_nms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const uint8_t*>(suppress),
      static_cast<float*>(out), H, W, thr);
  return static_cast<int>(cudaGetLastError());
}
