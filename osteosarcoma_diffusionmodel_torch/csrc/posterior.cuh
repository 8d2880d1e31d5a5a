// K3's per-element reverse transition, shared by the standalone kernel
// (posterior_step.cu) and the output product's fused epilogue
// (gemm_sm90.cuh, kPosterior): the same functions, so both give the same
// bits from the same f32 value of the output product. Each is pure and
// branch-free given the block-uniform mode, so the epilogue can compute a
// whole tile's elements side by side. The caller draws the randomness: u,
// the element's Philox uniform ("philox" mode, and the bits in "none"
// mode), or z, its value of the step's noise slab ("buffer" mode).
//
// Every operation but the sigmoid's divide is an _rn intrinsic in the plain
// version's order (sampler_kernels.x0_posterior_step_plain), so nothing is
// contracted into a multiply-add.
#pragma once

#include "common.cuh"

namespace osdm {

enum NoiseMode { kNoiseNone = 0, kNoiseBuffer = 1, kNoisePhilox = 2 };

constexpr float kUniformScale = 3.4641016151377544f;                 // 2 sqrt3
constexpr float kInvUniformScale = (float)(1.0 / 3.4641016151377544);  // as the host rounds it

// Row `step` of the (n_loop, 6) device table.
struct StepCoeffs {
  float c0, c1, sv, gain, beta, acp_prev;
};

__device__ __forceinline__ StepCoeffs step_coeffs(const float* table, int step) {
  const float* cf = table + (size_t)step * 6;
  return {cf[0], cf[1], cf[2], cf[3], cf[4], cf[5]};
}

// The step's uniform at element i: Philox keyed by (seed, step), 24 bits.
__device__ __forceinline__ float philox_uniform(size_t i, uint32_t seed, int step) {
  const uint4 r = philox4x32_10(make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u),
                                make_uint2(seed, (uint32_t)step));
  return (float)(r.x >> 8) * (1.0f / 16777216.0f);
}

// ops/discrete.py posterior_prob_one, operation for operation, in two
// parts: the posteriors of a one given x0 = 1 and given x0 = 0, which
// depend on the bit b and the step only (so a block whose bits are all 0
// or 1 computes them twice, not once an element), then their mixture by
// p1 = sigmoid(logits).
struct BitPosteriors {
  float given_one, given_zero;
};

__device__ __forceinline__ BitPosteriors bit_posteriors(float xm, float beta, float acp) {
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
  return {__fdiv_rn(a1_i1, __fadd_rn(a1_i1, a0_i1)), __fdiv_rn(a1_i0, __fadd_rn(a1_i0, a0_i0))};
}

__device__ __forceinline__ float posterior_prob_one(float p1, const BitPosteriors& bp) {
  return __fadd_rn(__fmul_rn(p1, bp.given_one), __fmul_rn(__fsub_rn(1.0f, p1), bp.given_zero));
}

// The new carry value of one element: out = acc + b_out + g·x, then
// c0·clip(out) + c1·x, + sv·z in "buffer" (z the slab's value) and
// "philox" mode (z = (u - 1/2)·2sqrt3 from the element's uniform u).
__device__ __forceinline__ float posterior_continuous(float acc, float b_out, float xf, float u,
                                                     float z, const StepCoeffs& cf, int mode,
                                                     float clip) {
  const float out = __fadd_rn(__fadd_rn(acc, b_out), __fmul_rn(cf.gain, xf));
  const float x0 = fminf(fmaxf(out, -clip), clip);
  const float xn = __fadd_rn(__fmul_rn(cf.c0, x0), __fmul_rn(cf.c1, xf));
  const float noise = mode == kNoiseBuffer ? z : __fmul_rn(__fsub_rn(u, 0.5f), kUniformScale);
  return mode == kNoiseNone ? xn : __fadd_rn(xn, __fmul_rn(cf.sv, noise));
}

// A D3PM bit's new value: out = acc + b_out + g·(2b - 1) are the logits,
// and the bit is u < posterior_prob_one(b, sigmoid(out), beta, acp_prev),
// with u the element's Philox uniform, or z/(2sqrt3) + 1/2 in "buffer"
// mode, and `bp` = bit_posteriors(b, beta, acp_prev). sigmoid takes the
// fast divide (within 2 ulp, no slow-path branch, so a block's bits run
// side by side); both kernels share it, so they keep the same bits, and a
// threshold moves only where u lies within a few ulp of p_prev.
__device__ __forceinline__ float posterior_bit(float acc, float b_out, float xf, float u, float z,
                                              const StepCoeffs& cf, int mode,
                                              const BitPosteriors& bp) {
  const float out = __fadd_rn(__fadd_rn(acc, b_out), __fmul_rn(cf.gain, __fsub_rn(2.0f * xf, 1.0f)));
  const float ub = mode == kNoiseBuffer ? __fadd_rn(__fmul_rn(z, kInvUniformScale), 0.5f) : u;
  const float p1 = __fdividef(1.0f, __fadd_rn(1.0f, expf(-out)));
  return ub < posterior_prob_one(p1, bp) ? 1.0f : 0.0f;
}

}  // namespace osdm
