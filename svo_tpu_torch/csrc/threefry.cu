// Threefry-2x32 PnP noise: svo_tpu's key split and Gumbel draw, one launch
// per frame step for every stream.
//
// Not a Pallas kernel. It replaces what svo_tpu's frame step takes from
// jax.random: `rng, sub = jax.random.split(state.rng)`
// (svo_tpu/pipeline/frontend.py:317) and `jax.random.gumbel(sub, (H, N))`
// (svo_tpu/geometry/pnp.py:168), both under jax's default threefry-2x32
// (20 rounds) with jax_threefry_partitionable: split(key) is
// (hash(key, (0, 0)), hash(key, (0, 1))), the 32-bit word of element i
// is hi ^ lo of hash(sub, (0, i)), the uniform is
// bitcast((word >> 9) | 0x3F800000) - 1 scaled into [tiny, 1) as
// jax.random.uniform does, and the Gumbel value is -log(-log(u)) (jax's
// mode "low"). So the keys and the uniform bits are svo_tpu's bit for bit,
// and the noise is within the rounding of log.
//
// What one launch covers: S streams, each key (2,) uint32 (held as int32
// bits in the port's VoState), n = H * N values a stream. Grid (ceil(n /
// 256), S), 256 threads. Every thread recomputes its stream's subkey (two
// hashes of 20 rounds, cheaper than a barrier and a shared-memory
// broadcast); thread 0 of block (0, s) writes stream s's new key once;
// each thread then hashes counter (0, i) for its values and writes the
// Gumbel float (and, where the caller asks for them to check the kernel,
// the 32-bit words). new_keys must not alias keys: other blocks of the
// stream still read the old key.
//
// What bounds it: operations. A value costs one hash (20 rounds of add,
// rotate, xor plus 17 adds of key injection: 77 integer ops) and ~10 more
// (xor, shift, or, sub, add, max, two logf, two negations), and writes 4
// bytes; at S = 1 and 128x128 that is ~1.4 M operations against 64 KiB
// written, so the integer pipes, not memory, bound it, and both are far
// below the launch's own cost. logf (not __logf) keeps the result within
// an ulp of the plain version, which computes the same float ops with
// torch.log. Launches on the caller's stream, allocates nothing, does not
// synchronise.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py::_threefry2x32_lowering):
// hashes the counter (x0, x1) in place under the key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__global__ void __launch_bounds__(kThreads) threefry_split_gumbel_kernel(
    const uint32_t* __restrict__ keys,  // (S, 2)
    int n,                              // values a stream
    uint32_t* __restrict__ new_keys,    // (S, 2)
    float* __restrict__ noise,          // (S, n)
    uint32_t* __restrict__ bits) {      // (S, n) or null
  const int s = blockIdx.y;
  const uint32_t k0 = keys[2 * s], k1 = keys[2 * s + 1];
  uint32_t sub0 = 0u, sub1 = 1u;  // split's second key: hash(key, (0, 1))
  threefry2x32(k0, k1, sub0, sub1);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    uint32_t r0 = 0u, r1 = 0u;  // split's first key: hash(key, (0, 0))
    threefry2x32(k0, k1, r0, r1);
    new_keys[2 * s] = r0;
    new_keys[2 * s + 1] = r1;
  }
  const size_t base = static_cast<size_t>(s) * n;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(i);
    threefry2x32(sub0, sub1, x0, x1);
    const uint32_t word = x0 ^ x1;
    if (bits != nullptr) bits[base + i] = word;
    // jax.random.uniform(minval=tiny, maxval=1): floats * (1 - tiny) + tiny,
    // max'ed with tiny; 1 - tiny is 1 in float32
    const float f = __uint_as_float((word >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(FLT_MIN, f * 1.0f + FLT_MIN);
    noise[base + i] = -logf(-logf(u));
  }
}

}  // namespace

// keys, new_keys: (S, 2) int32 device buffers holding uint32 bits; noise:
// (S, n) float32; bits: (S, n) 32-bit words or null. Returns
// cudaGetLastError() after the launch.
extern "C" int svo_threefry_split_gumbel(const void* keys, int S, int n, void* new_keys,
                                         void* noise, void* bits, void* stream) {
  if (S < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  threefry_split_gumbel_kernel<<<dim3(blocks, S), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), n, static_cast<uint32_t*>(new_keys),
      static_cast<float*>(noise), static_cast<uint32_t*>(bits));
  return static_cast<int>(cudaGetLastError());
}
