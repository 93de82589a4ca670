// KLT patch extraction for the pyramidal Lucas-Kanade tracker.
//
// Replaces the TPU kernel svo_tpu/ops/klt_pallas.py::_call (pallas_call,
// entry extract_klt_patches). For each of N features it copies the
// (py, px) windows of prev, gx and gy at the template corner (ty0, tx0) and
// of curr at the current corner (cy0, cx0) into one (4, N, py, px) output
// (template, its two gradients, current); dead slots (valid == 0) come back
// zeroed. Each corner is clamped to [0, H-py] x [0, W-px], as
// jax.lax.dynamic_slice clamps its start.
//
// What one launch covers: one extraction, all four images, all features of
// all streams. Levels cannot share a launch: the current corner of a level
// depends on the flow of the level above, which the tracker computes in
// tensor ops between two extractions (the kernels that take the whole level
// loop are csrc/lk_level.cu and, for the patches engine, csrc/klt_track.cu,
// which copies these windows itself: this kernel is off the tracker's path
// on the card and serves the self-test and the tools).
//
// What bounds it: it is a pure copy. A temporal level-0 call (N=128,
// 40x40 windows, 4 images) writes 128*40*40*4 images*4 B ~= 3.3 MB and reads
// as much, a few microseconds of memory traffic: the call is bound by its
// launch and by what its wrapper does on the host before it. The TPU
// kernel's sublane alignment and lane rolls were its compiler's constraints
// and have no counterpart here.
//
// Design: a grid of (S*N, 4) blocks, one per feature and image, of
// (px/4, rows) threads. A thread owns four neighbouring columns: it stores
// them as one float4 (px is a multiple of 4 and every window starts 16-byte
// aligned in the output), zeros for dead slots too, and walks down the rows
// by the block's row count, so row and column come from the thread's own
// indices with no division. Loads stay 4 bytes wide, the threads of a row
// reading one contiguous run of the source row: a source row starts at any
// x0 and the level's pitch is not a multiple of 16 bytes, so neither
// 16-byte loads nor TMA (whose tensor map needs such a pitch) apply. The
// corners come as four int32 arrays and valid as the bool tensor's own
// bytes, so the wrapper stacks, casts and copies nothing.
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

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads) klt_patches_kernel(
    const float* __restrict__ prev, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ curr,
    int H, int W, int N,                  // images (S, H, W), N features each
    const int32_t* __restrict__ ty0, const int32_t* __restrict__ tx0,
    const int32_t* __restrict__ cy0, const int32_t* __restrict__ cx0,  // (S*N,)
    const uint8_t* __restrict__ valid,    // (S*N,)
    int py, int px,
    float* __restrict__ out) {            // (4, S*N, py, px)
  const int n = blockIdx.x;      // feature index over all streams
  const int which = blockIdx.y;  // 0 prev, 1 gx, 2 gy, 3 curr
  const float* src = which == 0 ? prev : which == 1 ? gx : which == 2 ? gy : curr;
  const int y0 = min(max(which == 3 ? cy0[n] : ty0[n], 0), H - py);
  const int x0 = min(max(which == 3 ? cx0[n] : tx0[n], 0), W - px);
  const int c = 4 * threadIdx.x;
  float4* dst = reinterpret_cast<float4*>(
      out + (static_cast<size_t>(which) * gridDim.x + n) * py * px + c);
  const int pitch4 = px >> 2;
  if (!valid[n]) {
    for (int r = threadIdx.y; r < py; r += blockDim.y) {
      dst[r * pitch4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    return;
  }
  src += static_cast<size_t>(n / N) * H * W + static_cast<size_t>(y0) * W + x0 + c;
  for (int r = threadIdx.y; r < py; r += blockDim.y) {
    const float* s = src + static_cast<size_t>(r) * W;
    dst[r * pitch4] = make_float4(s[0], s[1], s[2], s[3]);
  }
}

}  // namespace

extern "C" int svo_klt_patches(
    const void* prev, const void* gx, const void* gy, const void* curr,
    int S, int H, int W, const void* ty0, const void* tx0, const void* cy0,
    const void* cx0, const void* valid, int N, int py, int px, void* out,
    void* stream) {
  if (px <= 0 || px % 4 || px / 4 > kMaxThreads || py <= 0 || py > H || px > W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S > 0 && N > 0) {
    // rows per block: as few passes as 256 threads allow, rows spread evenly
    const int tx = px / 4;
    const int passes = (py + kMaxThreads / tx - 1) / (kMaxThreads / tx);
    const int rows = (py + passes - 1) / passes;
    klt_patches_kernel<<<dim3(S * N, 4), dim3(tx, rows), 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(prev), static_cast<const float*>(gx),
        static_cast<const float*>(gy), static_cast<const float*>(curr), H, W, N,
        static_cast<const int32_t*>(ty0), static_cast<const int32_t*>(tx0),
        static_cast<const int32_t*>(cy0), static_cast<const int32_t*>(cx0),
        static_cast<const uint8_t*>(valid), py, px, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* svo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
