// Capability probes of the card: the Hopper counterpart of
// scripts/probe_mosaic.py::run (pallas_call), which asks the TPU's Mosaic
// compiler what it accepts. Each probe is a tiny kernel on the Mosaic
// probe's inputs, x (32, 48, 64) and o (32, 8) f32, writing (32, 1), and
// asks this card for something the port's kernels rely on or will need:
//
//   0 window_sum     an unaligned 3-D window x[:, 0:34, 3:24] summed
//                    straight from global memory (the Mosaic probe's slices;
//                    klt_patches.cu and lk_level.cu read such windows)
//   1 warp_butterfly a full-warp __shfl_xor_sync butterfly sum that every
//                    lane must hold equal (lk_level.cu's reduction); a lane
//                    that disagrees turns the row into NaN
//   2 float2int      __float2int_rd of NaN, +inf, -inf and finite values,
//                    then the clamp of lk_level.cu's corner()
//   3 dyn_smem       `param` bytes of dynamic shared memory, above 48 KB
//                    after cudaFuncSetAttribute; a refused request comes
//                    back as an error code, not a crash
//   4 wide_grid      a grid of (param, 4) blocks with param past 65,535 in
//                    x (the stream-batched klt_patches grid, S*N by 4)
//
// What bounds them: nothing worth a number; each moves a few hundred KB at
// most and is bound by its launch. One C entry, svo_probe, launches on the
// caller's stream, allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32, kD1 = 48, kD2 = 64, kO = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one warp per row: out[i] = sum x[i, 0:34, 3:24]
__global__ void window_sum_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int i = blockIdx.x, lane = threadIdx.x;
  const float* row = x + static_cast<size_t>(i) * kD1 * kD2;
  float acc = 0.0f;
  for (int e = lane; e < 34 * 21; e += 32) {
    const int r = e / 21, c = e - r * 21;
    acc += row[r * kD2 + 3 + c];
  }
  acc = warp_sum(acc);
  if (lane == 0) out[i] = acc;
}

// one warp per row: out[i] = sum x[i, 0, 0:32], NaN unless all lanes agree
__global__ void warp_butterfly_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int i = blockIdx.x, lane = threadIdx.x;
  const float v = warp_sum(x[static_cast<size_t>(i) * kD1 * kD2 + lane]);
  const float v0 = __shfl_sync(0xffffffffu, v, 0);
  const bool same = __all_sync(0xffffffffu, __float_as_uint(v) == __float_as_uint(v0));
  if (lane == 0) out[i] = same ? v : __int_as_float(0x7fc00000);
}

// out[i] = clip(floor(o[i, 0] * 300 - 100) - 6, 0, 1177) as lk_level.cu's
// corner(); the scale spreads o's [0, 5) over both ends of the clamp
__global__ void float2int_kernel(const float* __restrict__ o, float* __restrict__ out) {
  const int i = threadIdx.x;
  const float p = __fsub_rn(__fmul_rn(o[i * kO], 300.0f), 100.0f);
  const long long v = static_cast<long long>(__float2int_rd(p)) - 6;
  out[i] = static_cast<float>(min(max(v, 0LL), 1177LL));
}

// one block per row: fill n floats of dynamic shared memory with the row,
// wrapped; out[i] = first + middle + last
__global__ void dyn_smem_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  const int i = blockIdx.x;
  const float* row = x + static_cast<size_t>(i) * kD1 * kD2;
  for (int j = threadIdx.x; j < n; j += blockDim.x) smem[j] = row[j % (kD1 * kD2)];
  __syncthreads();
  if (threadIdx.x == 0) out[i] = smem[0] + smem[n / 2] + smem[n - 1];
}

// grid (gx, 4): the last 32 blocks in x of row y == 3 write
// out[i] = o[i, 3] + blockIdx.x
__global__ void wide_grid_kernel(const float* __restrict__ o, float* __restrict__ out) {
  const int i = static_cast<int>(blockIdx.x) - (static_cast<int>(gridDim.x) - kRows);
  if (i >= 0 && blockIdx.y == 3 && threadIdx.x == 0) {
    out[i] = o[i * kO + 3] + static_cast<float>(blockIdx.x);
  }
}

}  // namespace

extern "C" int svo_probe(int which, const void* x, const void* o, void* out,
                         int param, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* of = static_cast<const float*>(o);
  float* outf = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0:
      window_sum_kernel<<<kRows, 32, 0, s>>>(xf, outf);
      break;
    case 1:
      warp_butterfly_kernel<<<kRows, 32, 0, s>>>(xf, outf);
      break;
    case 2:
      float2int_kernel<<<1, kRows, 0, s>>>(of, outf);
      break;
    case 3: {
      if (param < static_cast<int>(sizeof(float))) return static_cast<int>(cudaErrorInvalidValue);
      const cudaError_t err = cudaFuncSetAttribute(
          dyn_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, param);
      if (err != cudaSuccess) {
        cudaGetLastError();  // the refusal is the answer; leave no error behind
        return static_cast<int>(err);
      }
      dyn_smem_kernel<<<kRows, 256, param, s>>>(xf, outf, param / static_cast<int>(sizeof(float)));
      break;
    }
    case 4:
      if (param < kRows) return static_cast<int>(cudaErrorInvalidValue);
      wide_grid_kernel<<<dim3(param, 4), 32, 0, s>>>(of, outf);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
