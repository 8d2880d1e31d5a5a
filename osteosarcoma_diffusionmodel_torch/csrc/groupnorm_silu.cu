// K2 groupnorm8_silu: GroupNorm(8 groups, f32 statistics, eps) -> scale/bias -> SiLU.
//
// Replaces: the GroupNorm of the whole-loop TPU sampler,
// osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py `_groupnorm`, which
// computes group statistics through group-membership matmuls (a TPU
// workaround). Here the statistics are a plain f32 reduction per
// (row, group): mean and E[x^2], var = max(E[x^2] - mean^2, 0) exactly as
// the "f32" gn_mode, then per-feature scale/bias and SiLU.
//
// What bounds it on the card: bytes. Each row of 256 or 512 f32 features
// is read twice and written once; the arithmetic is negligible.
//
// What the design does about it: one block per row, one warp per group
// (groups are 32 or 64 contiguous features), warp shuffles for the two
// sums, so the second read hits L1. The output is stored in bf16: every
// consumer casts to bf16 before its product (fused_sampler.py `mm`), so
// storing bf16 here changes no number the sampler computes. The output
// may be a strided view (the decoder's [h | skip] concatenation buffers).

#include "common.cuh"

namespace {

constexpr int kGroups = 8;

__global__ void __launch_bounds__(kGroups * 32) groupnorm8_silu_kernel(
    const float* __restrict__ h, int ldh, __nv_bfloat16* __restrict__ out, int ldo,
    const float* __restrict__ scale, const float* __restrict__ bias, int M, int F, float eps) {
  const int row = blockIdx.x;
  if (row >= M) return;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gs = F / kGroups;
  const float* hr = h + (size_t)row * ldh + g * gs;

  float s = 0.0f, sq = 0.0f;
  for (int c = lane; c < gs; c += 32) {
    const float v = hr[c];
    s += v;
    sq += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mean = s / gs;
  // E[x^2] - E[x]^2 can dip below zero when |mean| >> std; clamp it.
  const float var = fmaxf(sq / gs - mean * mean, 0.0f);
  const float inv = rsqrtf(var + eps);

  __nv_bfloat16* orow = out + (size_t)row * ldo + g * gs;
  for (int c = lane; c < gs; c += 32) {
    const int f = g * gs + c;
    const float y = (hr[c] - mean) * inv * scale[f] + bias[f];
    orow[c] = __float2bfloat16(y / (1.0f + expf(-y)));
  }
}

}  // namespace

OSDM_EXPORT int osdm_groupnorm8_silu(const void* h, int ldh, void* out, int ldo,
                                     const void* scale, const void* bias, int M, int F,
                                     float eps, void* stream) {
  if (F % kGroups != 0) return static_cast<int>(cudaErrorInvalidValue);
  groupnorm8_silu_kernel<<<M, kGroups * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), ldh, static_cast<__nv_bfloat16*>(out), ldo,
      static_cast<const float*>(scale), static_cast<const float*>(bias), M, F, eps);
  return static_cast<int>(cudaGetLastError());
}
