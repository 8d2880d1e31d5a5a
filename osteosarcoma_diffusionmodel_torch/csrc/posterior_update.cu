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
// The noise: one Philox4x32-10 call keyed by (seed, 0) at counter j gives
// the four elements 4j .. 4j+3 of the flat array. Words (0, 1) and (2, 3)
// are two pairs of 24-bit uniforms (u1 floored at 1e-12, as the TPU kernel
// does), and each pair gives both Box-Muller outputs: element 4j+q takes
// pair q/2, sqrt(-2 log u1)·cos(2π u2) for even q and ·sin(2π u2) for odd
// q. The counter is the global quad index, so the noise does not depend
// on how the grid tiles the array. The TPU kernel reseeds its hardware
// generator per tile; its bits cannot be reproduced, so the two are
// compared by statistics. logf and sqrtf are the accurate CUDA functions;
// the angle is sincospif(2·u2), accurate and without the large-argument
// path of sinf/cosf. The affine part is written with the _rn intrinsics in
// the plain version's order (no contracted multiply-add).
//
// What bounds it on the card: bytes. With noise, x and x0_pred are read
// and out written, 12 bytes per element; without, x is not read, 8 bytes.
// Drawn one Philox call and three transcendental functions an element, the
// first design was bound by issue instead (10 rounds of 32x32 multiplies
// an element, of whose four words it used two, and scalar accesses).
//
// What the design does about it: one thread a quad of elements, so a
// Philox call, a log and a sqrt serve four, two and two elements; 16-byte
// loads and stores where the three arrays' bases allow them (the flat
// array of a contiguous tensor: a 5142-float row is not a multiple of 16
// bytes, so rows are not aligned, but quads of the flat index are), one
// grid covering every quad in a single pass, and a scalar tail for the
// last n % 4 elements. The no-noise case reads no x and draws nothing.

#include "common.cuh"

namespace {

struct Coefs {
  float c0, c1, sv, add_noise, clip;
};

constexpr float kInv24 = 1.0f / 16777216.0f;
constexpr int kThreads = 256;

// The two Box-Muller outputs of one pair of Philox words.
__device__ __forceinline__ float2 box_muller(uint32_t w1, uint32_t w2) {
  const float u1 = fmaxf((float)(w1 >> 8) * kInv24, 1e-12f);
  const float u2 = (float)(w2 >> 8) * kInv24;
  const float radius = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  float s, c;
  sincospif(__fmul_rn(2.0f, u2), &s, &c);
  return make_float2(__fmul_rn(radius, c), __fmul_rn(radius, s));
}

__device__ __forceinline__ float step_value(float x, float pred, float z, const Coefs& c,
                                            bool noise) {
  const float x0 = fminf(fmaxf(pred, -c.clip), c.clip);
  return noise ? __fadd_rn(__fadd_rn(__fmul_rn(c.c0, x0), __fmul_rn(c.c1, x)), __fmul_rn(c.sv, z))
               : x0;
}

__global__ void __launch_bounds__(kThreads) posterior_update_kernel(
    const float* __restrict__ x, const float* __restrict__ pred, float* __restrict__ out, size_t n,
    const float* __restrict__ coefs, Coefs fixed, uint32_t seed, int vec) {
  const Coefs c = coefs == nullptr
                      ? fixed
                      : Coefs{coefs[0], coefs[1], coefs[2], coefs[3], coefs[4]};
  const size_t j = (size_t)blockIdx.x * kThreads + threadIdx.x;  // the quad
  const size_t i0 = 4 * j;
  if (i0 >= n) return;
  const bool noise = c.add_noise > 0.0f;
  const bool whole = i0 + 4 <= n;
  float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (whole && vec) {
    const float4 p4 = __ldg(reinterpret_cast<const float4*>(pred) + j);
    pv[0] = p4.x, pv[1] = p4.y, pv[2] = p4.z, pv[3] = p4.w;
    if (noise) {
      const float4 x4 = __ldg(reinterpret_cast<const float4*>(x) + j);
      xv[0] = x4.x, xv[1] = x4.y, xv[2] = x4.z, xv[3] = x4.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (i0 + q < n) {
        pv[q] = __ldg(pred + i0 + q);
        if (noise) xv[q] = __ldg(x + i0 + q);
      }
    }
  }
  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (noise) {
    const uint4 r = osdm::philox4x32_10(make_uint4((uint32_t)j, (uint32_t)(j >> 32), 0u, 0u),
                                        make_uint2(seed, 0u));
    const float2 a = box_muller(r.x, r.y), b = box_muller(r.z, r.w);
    z[0] = a.x, z[1] = a.y, z[2] = b.x, z[3] = b.y;
  }
  float o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = step_value(xv[q], pv[q], z[q], c, noise);
  if (whole && vec) {
    reinterpret_cast<float4*>(out)[j] = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (i0 + q < n) out[i0 + q] = o[q];
  }
}

}  // namespace

OSDM_EXPORT int osdm_posterior_update(const void* x, const void* pred, void* out, int n_rows,
                                      int n_cols, const void* coefs, float c0, float c1, float sv,
                                      float add_noise, float clip, uint32_t seed, void* stream) {
  if (n_rows < 0 || n_cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)n_rows * n_cols;
  const size_t quads = n == 0 ? 1 : (n + 3) / 4;  // an empty array still launches (and returns)
  const int vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(pred) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  posterior_update_kernel<<<(unsigned)((quads + kThreads - 1) / kThreads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(pred), static_cast<float*>(out), n,
      static_cast<const float*>(coefs), Coefs{c0, c1, sv, add_noise, clip}, seed, vec);
  return static_cast<int>(cudaGetLastError());
}
