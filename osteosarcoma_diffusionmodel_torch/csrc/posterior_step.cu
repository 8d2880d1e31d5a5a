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
// z/(2sqrt3) + 1/2 ("buffer"). Every operation is written with the _rn
// intrinsics in the plain version's order, so no multiply-add is
// contracted and a threshold u < p_prev sees the plain version's p_prev.
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

constexpr float kUniformScale = 3.4641016151377544f;                 // 2 sqrt3
constexpr float kInvUniformScale = (float)(1.0 / 3.4641016151377544);  // as the host rounds it

__device__ __forceinline__ float philox_uniform(size_t i, uint32_t seed, int step) {
  const uint4 r = osdm::philox4x32_10(make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u),
                                      make_uint2(seed, (uint32_t)step));
  return (float)(r.x >> 8) * (1.0f / 16777216.0f);
}

// ops/discrete.py posterior_prob_one, operation for operation.
__device__ __forceinline__ float posterior_prob_one(float xm, float p1, float beta, float acp) {
  const float half_beta = __fmul_rn(0.5f, beta);
  const float omb = __fsub_rn(1.0f, beta);
  const float f1 = __fadd_rn(__fmul_rn(omb, xm), half_beta);
  const float f0 = __fadd_rn(__fmul_rn(omb, __fsub_rn(1.0f, xm)), half_beta);
  const float half_om = __fmul_rn(0.5f, __fsub_rn(1.0f, acp));
  const float g_same = __fadd_rn(acp, half_om);
  const float a1_i1 = __fmul_rn(f1, g_same);
  const float a0_i1 = __fmul_rn(f0, half_om);
  const float a1_i0 = __fmul_rn(f1, half_om);
  const float a0_i0 = __fmul_rn(f0, g_same);
  const float post1_i1 = __fdiv_rn(a1_i1, __fadd_rn(a1_i1, a0_i1));
  const float post1_i0 = __fdiv_rn(a1_i0, __fadd_rn(a1_i0, a0_i0));
  return __fadd_rn(__fmul_rn(p1, post1_i1), __fmul_rn(__fsub_rn(1.0f, p1), post1_i0));
}

__global__ void __launch_bounds__(256) x0_posterior_step_kernel(
    const float* __restrict__ acc, __nv_bfloat16* x, int M, int D, int mut_dim,
    const float* __restrict__ b_out, const float* __restrict__ coeffs, int step, int mode,
    const float* __restrict__ noise, uint32_t seed, float clip) {
  const float* cf = coeffs + (size_t)step * 6;
  const float c0 = cf[0], c1 = cf[1], sv = cf[2], gain = cf[3], beta = cf[4], acp_prev = cf[5];
  const size_t n = (size_t)M * D;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int col = (int)(i % (size_t)D);
    const bool bit = col < mut_dim;
    const float xf = __bfloat162float(x[i]);
    const float xt = bit ? __fsub_rn(2.0f * xf, 1.0f) : xf;
    const float out = __fadd_rn(__fadd_rn(acc[i], b_out[col]), __fmul_rn(gain, xt));
    float u = 0.0f;
    float xn = 0.0f;
    if (!bit) {
      const float x0 = fminf(fmaxf(out, -clip), clip);
      xn = __fadd_rn(__fmul_rn(c0, x0), __fmul_rn(c1, xf));
    }
    if (mode == kBuffer) {
      const float z = noise[(size_t)step * n + i];
      if (bit)
        u = __fadd_rn(__fmul_rn(z, kInvUniformScale), 0.5f);
      else
        xn = __fadd_rn(xn, __fmul_rn(sv, z));
    } else if (mode == kPhilox || bit) {
      u = philox_uniform(i, seed, step);
      if (!bit && mode == kPhilox)
        xn = __fadd_rn(xn, __fmul_rn(sv, __fmul_rn(__fsub_rn(u, 0.5f), kUniformScale)));
    }
    if (bit) {
      const float p1 = 1.0f / (1.0f + expf(-out));
      xn = (u < posterior_prob_one(xf, p1, beta, acp_prev)) ? 1.0f : 0.0f;
    }
    x[i] = __float2bfloat16(xn);
  }
}

}  // namespace

OSDM_EXPORT int osdm_x0_posterior_step(const void* acc, void* x, int M, int D, int mut_dim,
                                       const void* b_out, const void* coeffs, int step, int mode,
                                       const void* noise, uint32_t seed, float clip,
                                       void* stream) {
  if (mode < kNone || mode > kPhilox || mut_dim < 0 || mut_dim > D)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)M * D;
  const int threads = 256;
  size_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks == 0) blocks = 1;
  x0_posterior_step_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(x), M, D, mut_dim,
      static_cast<const float*>(b_out), static_cast<const float*>(coeffs), step, mode,
      static_cast<const float*>(noise), seed, clip);
  return static_cast<int>(cudaGetLastError());
}
