// KLT patch extraction for the pyramidal Lucas-Kanade tracker.
//
// Replaces the TPU kernel svo_tpu/ops/klt_pallas.py::_call (pallas_call,
// entry extract_klt_patches). For each of N features it copies the
// (py, px) windows of prev, gx and gy at the template corner (ty0, tx0) and
// of curr at the current corner (cy0, cx0) into four (N, py, px) outputs;
// dead slots (valid == 0) come back zeroed. Each corner is clamped to
// [0, H-py] x [0, W-px], as jax.lax.dynamic_slice clamps its start.
//
// What bounds it: it is a pure copy. A temporal level-0 call (N=128,
// 40x40 windows, 4 images) writes 128*40*40*4 images*4 B ~= 3.3 MB and reads
// as much, so it is bound by memory traffic and by its launch. The TPU
// kernel's sublane alignment and lane rolls were Mosaic's constraints and
// have no counterpart here.
//
// Design: a grid of (S*N, 4) blocks, one per feature and image; each block
// reads its own corner and walks its window in row-major order, so
// neighbouring threads read and write neighbouring addresses along x.
// Launches on the caller's stream, allocates nothing, does not synchronise.
//
// The stream axis (the TPU kernel's batched form, klt_pallas.py
// _extract_batched, grid (S, N/8)) is part of the same launch: the images
// are (S, H, W), corners and valid (S, N), and block b serves feature
// b % N of stream b / N, reading its images at base + (b / N) * H * W. One
// stream is S = 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void klt_patches_kernel(
    const float* __restrict__ prev, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ curr,
    int H, int W, int N,                  // images (S, H, W), N features each
    const int32_t* __restrict__ corners,  // (S*N, 4): ty0, tx0, cy0, cx0
    const uint8_t* __restrict__ valid,    // (S*N,)
    int py, int px,
    float* __restrict__ t_out, float* __restrict__ gx_out,
    float* __restrict__ gy_out, float* __restrict__ c_out) {
  const int n = blockIdx.x;  // feature index over all streams
  const int which = blockIdx.y;  // 0 prev, 1 gx, 2 gy, 3 curr
  const float* src = which == 0 ? prev : which == 1 ? gx : which == 2 ? gy : curr;
  float* dst = which == 0 ? t_out : which == 1 ? gx_out : which == 2 ? gy_out : c_out;
  const int k = which == 3 ? 2 : 0;
  const int y0 = min(max(corners[4 * n + k], 0), H - py);
  const int x0 = min(max(corners[4 * n + k + 1], 0), W - px);
  const int area = py * px;
  dst += static_cast<size_t>(n) * area;
  if (!valid[n]) {
    for (int i = threadIdx.x; i < area; i += blockDim.x) dst[i] = 0.0f;
    return;
  }
  src += static_cast<size_t>(n / N) * H * W + static_cast<size_t>(y0) * W + x0;
  for (int i = threadIdx.x; i < area; i += blockDim.x) {
    const int r = i / px;
    const int c = i - r * px;
    dst[i] = src[static_cast<size_t>(r) * W + c];
  }
}

}  // namespace

extern "C" int svo_klt_patches(
    const void* prev, const void* gx, const void* gy, const void* curr,
    int S, int H, int W, const void* corners, const void* valid, int N,
    int py, int px, void* t_out, void* gx_out, void* gy_out, void* c_out,
    void* stream) {
  if (S > 0 && N > 0) {
    klt_patches_kernel<<<dim3(S * N, 4), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(prev), static_cast<const float*>(gx),
        static_cast<const float*>(gy), static_cast<const float*>(curr), H, W, N,
        static_cast<const int32_t*>(corners),
        static_cast<const uint8_t*>(valid), py, px,
        static_cast<float*>(t_out), static_cast<float*>(gx_out),
        static_cast<float*>(gy_out), static_cast<float*>(c_out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* svo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
