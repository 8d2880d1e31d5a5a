// K8 posterior_update: one ancestral step with Gaussian noise, fused over (n, d).
//
//   x0  = clip(x0_pred, ±clip)
//   out = c0·x0 + c1·x + sv·z      (add_noise > 0)
//   out = x0                       (add_noise <= 0)
//
// Replaces: osteosarcoma_diffusionmodel_tpu/ops/pallas_kernels.py
// `_posterior_update_block` via `posterior_update` (static coefficients,
// 1-D grid) and `_posterior_step_kernel` via `posterior_update_traced`
// (coefficients [c0, c1, sv, add_noise, clip] read from SMEM, 2-D grid).
// One kernel serves both: the static wrapper passes the five values as
// arguments, the traced one a pointer to a device (5,) f32 tensor, read
// by every thread (so a loop over steps can be captured in a CUDA graph).
//
// z is Box-Muller, sqrt(-2 log u1)·cos(2π u2), from two 24-bit uniforms
// (u1 floored at 1e-12, as the TPU kernel does): words 0 and 1 of one
// Philox4x32-10 call keyed by (seed, 0) with counter = row·d + col. The
// TPU kernel reseeds its hardware generator per tile (seed + tile index);
// here the counter is the global element index, so the noise does not
// depend on how the grid tiles the array. The affine part is written with
// the _rn intrinsics in the plain version's order (no contracted
// multiply-add); logf, sqrtf and cosf are the accurate CUDA functions
// (within an ulp or two of the plain version's).
//
// What bounds it on the card: bytes. With noise, x and x0_pred are read
// and out written, 12 bytes per element; without, x is not read, 8 bytes.
// Philox and the three transcendental functions cost well under the
// memory time at the sampler's shapes.
//
// What the design does about it: one grid-stride pass over the flat
// array, masking nothing but the end of the array: any (n, d) runs without
// the padding copies the TPU wrapper makes.

#include "common.cuh"

namespace {

constexpr float kTwoPi = 6.28318530717958647692f;

struct Coefs {
  float c0, c1, sv, add_noise, clip;
};

__global__ void __launch_bounds__(256) posterior_update_kernel(
    const float* __restrict__ x, const float* __restrict__ pred, float* __restrict__ out, size_t n,
    const float* __restrict__ coefs, Coefs fixed, uint32_t seed) {
  const Coefs c = coefs == nullptr
                      ? fixed
                      : Coefs{coefs[0], coefs[1], coefs[2], coefs[3], coefs[4]};
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float x0 = fminf(fmaxf(pred[i], -c.clip), c.clip);
    if (c.add_noise > 0.0f) {
      const uint4 r = osdm::philox4x32_10(make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u),
                                          make_uint2(seed, 0u));
      const float u1 = fmaxf((float)(r.x >> 8) * (1.0f / 16777216.0f), 1e-12f);
      const float u2 = (float)(r.y >> 8) * (1.0f / 16777216.0f);
      const float z = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(kTwoPi, u2)));
      out[i] = __fadd_rn(__fadd_rn(__fmul_rn(c.c0, x0), __fmul_rn(c.c1, x[i])),
                         __fmul_rn(c.sv, z));
    } else {
      out[i] = x0;
    }
  }
}

}  // namespace

OSDM_EXPORT int osdm_posterior_update(const void* x, const void* pred, void* out, int n_rows,
                                      int n_cols, const void* coefs, float c0, float c1, float sv,
                                      float add_noise, float clip, uint32_t seed, void* stream) {
  if (n_rows < 0 || n_cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)n_rows * n_cols;
  const int threads = 256;
  size_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks == 0) blocks = 1;
  posterior_update_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(pred), static_cast<float*>(out), n,
      static_cast<const float*>(coefs), Coefs{c0, c1, sv, add_noise, clip}, seed);
  return static_cast<int>(cudaGetLastError());
}
