// K3 x0_posterior_step: output epilogue + reverse transition, fused over (B, D).
//
//   out = acc + b_out + g_s·x;  x0 = clip(out, ±clip);
//   x  <- c0·x0 + c1·x + sv·z   (stored as the bf16 carry, in place)
//
// Replaces: the `st_out`/`st_post` stages of the whole-loop TPU sampler,
// osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py `_build_kernel`
// ("prng", "buffer" and "none" noise modes, mut_dim >= 0). z is
// U(-sqrt3, sqrt3): in "philox" mode from an in-kernel Philox4x32-10
// keyed by (seed, step) with counter = row·D + col (24-bit uniforms),
// replacing the TPU's prng_random_bits and its 16-bit lane halving; in
// "buffer" mode read from a (steps, B, D) f32 tensor; in "none" mode
// (eta = 0 DDIM) sv·z is skipped. g_s, c0, c1, sv, beta and acp_prev are
// read from the device coefficient table at row `step`, so the loop can
// later be captured in one CUDA graph.
//
// D3PM head (mut_dim = M > 0, TPU :449-527): columns < M hold bits b.
// There the gain term is g·(2b - 1), p1 = sigmoid(out) of the unclipped
// logits, p_prev = posterior_prob_one(b, p1, beta, acp_prev)
// (ops/discrete.py) and the stored bit is exactly (u < p_prev), with u
// the step's uniform on that element: the same Philox value the
// continuous columns turn into noise ("philox"), drawn on the mutation
// columns alone ("none": eta = 0 DDIM still draws bits), or
// z/(2sqrt3) + 1/2 ("buffer"). The element's arithmetic is posterior.cuh's,
// which the output product's fused epilogue (gemm_sm90.cuh, kPosterior)
// shares: the sampler's main paths run that epilogue, and this kernel
// stays as its unfused reference.
//
// What bounds it on the card: bytes (f32 acc in, bf16 carry in and out,
// plus the noise slab in "buffer" mode). Philox costs ten multiply rounds
// per element, well under the memory time.
//
// What the design does about it: one grid-stride elementwise pass; the
// carry is updated in place, so no second state buffer exists. acc and the
// carry are row-strided views (the sampler pads their rows to 5152 columns
// so K1 can read and write them through TMA); the noise slab and the
// Philox counter stay indexed by row·D + col.

#include "posterior.cuh"

namespace {

__global__ void __launch_bounds__(256) x0_posterior_step_kernel(
    const float* __restrict__ acc, int lda, __nv_bfloat16* x, int ldx, int M, int D, int mut_dim,
    const float* __restrict__ b_out, const float* __restrict__ coeffs, int step, int mode,
    const float* __restrict__ noise, uint32_t seed, float clip) {
  const osdm::StepCoeffs cf = osdm::step_coeffs(coeffs, step);
  const size_t n = (size_t)M * D;
  const float* noise_step = mode == osdm::kNoiseBuffer ? noise + (size_t)step * n : nullptr;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int col = (int)(i % (size_t)D);
    const size_t row = i / (size_t)D;
    const bool bit = col < mut_dim;
    const float u = mode == osdm::kNoisePhilox || (bit && mode == osdm::kNoiseNone)
                        ? osdm::philox_uniform(i, seed, step)
                        : 0.0f;
    const float z = mode == osdm::kNoiseBuffer ? noise_step[i] : 0.0f;
    __nv_bfloat16* xp = x + row * ldx + col;
    const float v = acc[row * lda + col], xf = __bfloat162float(*xp);
    *xp = __float2bfloat16(
        bit ? osdm::posterior_bit(v, b_out[col], xf, u, z, cf, mode,
                                  osdm::bit_posteriors(xf, cf.beta, cf.acp_prev))
            : osdm::posterior_continuous(v, b_out[col], xf, u, z, cf, mode, clip));
  }
}

}  // namespace

OSDM_EXPORT int osdm_x0_posterior_step(const void* acc, int lda, void* x, int ldx, int M, int D,
                                       int mut_dim,
                                       const void* b_out, const void* coeffs, int step, int mode,
                                       const void* noise, uint32_t seed, float clip,
                                       void* stream) {
  if (mode < osdm::kNoiseNone || mode > osdm::kNoisePhilox || mut_dim < 0 || mut_dim > D)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)M * D;
  const int threads = 256;
  size_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks == 0) blocks = 1;
  x0_posterior_step_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), lda, static_cast<__nv_bfloat16*>(x), ldx, M, D, mut_dim,
      static_cast<const float*>(b_out), static_cast<const float*>(coeffs), step, mode,
      static_cast<const float*>(noise), seed, clip);
  return static_cast<int>(cudaGetLastError());
}
