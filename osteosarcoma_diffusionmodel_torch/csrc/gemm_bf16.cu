// K1 gemm_bf16_f32acc: C = A·B + bias (+ row_add), bf16 inputs, f32 accumulation.
//
// Replaces: the matrix products inside the whole-loop TPU sampler,
// osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py `_build_kernel`
// (`mm`, bf16 dots with preferred_element_type=f32): x·W_in, the ten
// DenoiserBlock products and h·W_out of every reverse step.
//
// What bounds it on the card: at the sampler's shapes (333 rows, K up to
// 5142, N up to 5142) the products are small; the input projection
// (333x5142 · 5142x256) has few output tiles and a long K loop, so it is
// bound by latency and by how many SMs get a tile, the output projection
// (333x256 · 256x5142) by the bytes of W_out and of the f32 result.
//
// What the design does about it: tensor-core tiles through WMMA
// (16x16x16 bf16 -> f32, compiled to mma.sync), staged through shared
// memory with masked scalar loads so ragged rows, the 5142-wide rows that
// are not 16-byte aligned, and strided views (the decoder's [h | skip]
// buffers) need no padding in device memory. The wrapper picks 32x32 tiles
// when 64x64 tiles would leave most SMs idle. No cp.async, TMA or wgmma
// yet: that is later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kBK = 32;
constexpr int kThreads = 128;  // 4 warps in a 2x2 layout over the tile

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads) gemm_bf16_f32acc_kernel(
    const __nv_bfloat16* __restrict__ A, int lda,
    const __nv_bfloat16* __restrict__ B, int ldb,
    void* __restrict__ C, int ldc, int out_bf16,
    int M, int N, int K,
    const float* __restrict__ bias,
    const float* __restrict__ row_add, int ldr) {
  constexpr int FM = BM / 32;  // 16-row fragments per warp
  constexpr int FN = BN / 32;  // 16-col fragments per warp
  constexpr int LDA_S = kBK + 8;  // bf16 ldm: multiple of 8
  constexpr int LDB_S = BN + 8;
  constexpr int LDC_S = BN + 4;  // f32 ldm: multiple of 4

  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA_S];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBK * LDB_S];
  __shared__ __align__(128) float Cs[BM * LDC_S];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = row0 + r, gc = k0 + c;
      As[r * LDA_S + c] = (gr < M && gc < K) ? A[(size_t)gr * lda + gc] : zero;
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r * LDB_S + c] = (gr < K && gc < N) ? B[(size_t)gr * ldb + gc] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * (BM / 2) + i * 16) * LDA_S + kk, LDA_S);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * LDB_S + wn * (BN / 2) + j * 16, LDB_S);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * (BM / 2) + i * 16) * LDC_S + wn * (BN / 2) + j * 16,
                              acc[i][j], LDC_S, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: bias, then the per-row add, in the order the TPU kernel adds them.
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= M || gc >= N) continue;
    float v = Cs[r * LDC_S + c];
    if (bias != nullptr) v += bias[gc];
    if (row_add != nullptr) v += row_add[(size_t)gr * ldr + gc];
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(C)[(size_t)gr * ldc + gc] = __float2bfloat16(v);
    else
      reinterpret_cast<float*>(C)[(size_t)gr * ldc + gc] = v;
  }
}

template <int BM, int BN>
void launch(const void* A, int lda, const void* B, int ldb, void* C, int ldc, int out_bf16,
            int M, int N, int K, const void* bias, const void* row_add, int ldr,
            cudaStream_t stream) {
  const dim3 grid(osdm::cdiv(N, BN), osdm::cdiv(M, BM));
  gemm_bf16_f32acc_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(A), lda, static_cast<const __nv_bfloat16*>(B), ldb,
      C, ldc, out_bf16, M, N, K, static_cast<const float*>(bias),
      static_cast<const float*>(row_add), ldr);
}

}  // namespace

OSDM_EXPORT int osdm_gemm_bf16_f32acc(const void* A, int lda, const void* B, int ldb,
                                      void* C, int ldc, int out_bf16, int M, int N, int K,
                                      const void* bias, const void* row_add, int ldr,
                                      int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64)
    launch<64, 64>(A, lda, B, ldb, C, ldc, out_bf16, M, N, K, bias, row_add, ldr, s);
  else if (tile == 32)
    launch<32, 32>(A, lda, B, ldb, C, ldc, out_bf16, M, N, K, bias, row_add, ldr, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
