// K5 rowquant_s8: per-row dynamic int8 quantization of an activation matrix.
//
//   v = x (2x - 1 on columns < mut_cols);  amax = max(max_row |v|, 1e-6)
//   q = rint(v · (127 / amax)) as int8;     scale = amax · (1/127)
//
// Replaces: the activation half of the TPU sampler's int8 `mm`
// (osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py `_build_kernel`,
// :336-339), which quantizes each product's f32 input per row before the
// s8·s8 -> s32 dot. The D3PM transform is the TPU's `st_pre`: the input
// product quantizes the denoiser's view 2b - 1 of the bits. rint rounds
// half to even, as jnp.round and torch.round do (never roundf), and the
// multiplies and the division are the _rn intrinsics in the plain
// version's order, so the codes and scales equal the plain version's.
// The output row is zero-padded to `ldq` (a multiple of 16) so K6 loads
// 16-byte vectors without a mask on K.
//
// What bounds it on the card: bytes. Each row is read twice (the max,
// then the codes) and written once at a quarter of its bf16 size; the
// second read hits L1/L2 at the sampler's row widths (<= 10 KB).
//
// What the design does about it: one block per row, a warp-shuffle max
// reduction, no atomics.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ float view(const T* a, int c, int mut_cols) {
  const float v = to_float(a[c]);
  return c < mut_cols ? __fsub_rn(2.0f * v, 1.0f) : v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rowquant_s8_kernel(
    const T* __restrict__ A, int lda, int K, int mut_cols, int8_t* __restrict__ Q, int ldq,
    float* __restrict__ scale) {
  __shared__ float red[kThreads / 32];
  const int row = blockIdx.x;
  const T* a = A + (size_t)row * lda;
  float m = 0.0f;
  for (int c = threadIdx.x; c < K; c += kThreads) m = fmaxf(m, fabsf(view(a, c, mut_cols)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const float amax = fmaxf(red[0], 1e-6f);
  const float inv = __fdiv_rn(127.0f, amax);
  int8_t* q = Q + (size_t)row * ldq;
  for (int c = threadIdx.x; c < ldq; c += kThreads)
    q[c] = c < K ? (int8_t)__float2int_rn(__fmul_rn(view(a, c, mut_cols), inv)) : (int8_t)0;
  if (threadIdx.x == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
}

}  // namespace

OSDM_EXPORT int osdm_rowquant_s8(const void* A, int lda, int in_bf16, int M, int K, int mut_cols,
                                 void* Q, int ldq, void* scale, void* stream) {
  if (M <= 0 || K <= 0 || ldq < K || mut_cols < 0 || mut_cols > K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    rowquant_s8_kernel<__nv_bfloat16><<<M, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), lda, K, mut_cols, static_cast<int8_t*>(Q), ldq,
        static_cast<float*>(scale));
  else
    rowquant_s8_kernel<float><<<M, kThreads, 0, s>>>(
        static_cast<const float*>(A), lda, K, mut_cols, static_cast<int8_t*>(Q), ldq,
        static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}
