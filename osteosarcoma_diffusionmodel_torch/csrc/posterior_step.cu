// K3 x0_posterior_step: output epilogue + reverse transition, fused over (B, D).
//
//   out = acc + b_out + g_s·x;  x0 = clip(out, ±clip);
//   x  <- c0·x0 + c1·x + sv·z   (stored as the bf16 carry, in place)
//
// Replaces: the `st_out`/`st_post` stages of the whole-loop TPU sampler,
// osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py `_build_kernel`
// ("prng", "buffer" and "none" noise modes, mut_dim = 0). z is
// U(-sqrt3, sqrt3): in "philox" mode from an in-kernel Philox4x32-10
// keyed by (seed, step) with counter = row·D + col (24-bit uniforms),
// replacing the TPU's prng_random_bits and its 16-bit lane halving; in
// "buffer" mode read from a (steps, B, D) f32 tensor; in "none" mode
// (eta = 0 DDIM) sv·z is skipped. g_s, c0, c1 and sv are read from the
// device coefficient table at row `step`, so the loop can later be
// captured in one CUDA graph.
//
// What bounds it on the card: bytes (f32 acc in, bf16 carry in and out,
// plus the noise slab in "buffer" mode). Philox costs ten multiply rounds
// per element, well under the memory time.
//
// What the design does about it: one grid-stride elementwise pass; the
// carry is updated in place, so no second state buffer exists.

#include "common.cuh"

namespace {

enum NoiseMode { kNone = 0, kBuffer = 1, kPhilox = 2 };

__global__ void __launch_bounds__(256) x0_posterior_step_kernel(
    const float* __restrict__ acc, __nv_bfloat16* x, int M, int D,
    const float* __restrict__ b_out, const float* __restrict__ coeffs, int step, int mode,
    const float* __restrict__ noise, uint32_t seed, float clip) {
  const float* cf = coeffs + (size_t)step * 6;
  const float c0 = cf[0], c1 = cf[1], sv = cf[2], gain = cf[3];
  const size_t n = (size_t)M * D;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int col = (int)(i % (size_t)D);
    const float xf = __bfloat162float(x[i]);
    const float out = acc[i] + b_out[col] + gain * xf;
    const float x0 = fminf(fmaxf(out, -clip), clip);
    float xn = c0 * x0 + c1 * xf;
    if (mode == kBuffer) {
      xn += sv * noise[(size_t)step * n + i];
    } else if (mode == kPhilox) {
      const uint4 r = osdm::philox4x32_10(
          make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u), make_uint2(seed, (uint32_t)step));
      const float u = (float)(r.x >> 8) * (1.0f / 16777216.0f);
      xn += sv * ((u - 0.5f) * 3.4641016151377544f);
    }
    x[i] = __float2bfloat16(xn);
  }
}

}  // namespace

OSDM_EXPORT int osdm_x0_posterior_step(const void* acc, void* x, int M, int D, const void* b_out,
                                       const void* coeffs, int step, int mode, const void* noise,
                                       uint32_t seed, float clip, void* stream) {
  if (mode < kNone || mode > kPhilox) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)M * D;
  const int threads = 256;
  size_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks == 0) blocks = 1;
  x0_posterior_step_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(x), M, D,
      static_cast<const float*>(b_out), static_cast<const float*>(coeffs), step, mode,
      static_cast<const float*>(noise), seed, clip);
  return static_cast<int>(cudaGetLastError());
}
