// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every entry point has a plain C signature, launches on the stream it is
// given (PyTorch's current stream) and returns cudaGetLastError() so the
// ctypes wrapper can raise when a launch was refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define OSDM_EXPORT extern "C" __attribute__((visibility("default")))

namespace osdm {

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Philox4x32-10 (Salmon et al., SC'11): ten rounds of the 4x32 bijection.
// Replaces the TPU kernel's pltpu.prng_random_bits stream; the sampler
// keys it by (seed, step) and counts by the global element index, so the
// stream does not depend on how the grid tiles the batch.
static __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

}  // namespace osdm
