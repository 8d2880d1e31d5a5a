// K6 gemm_s8: C (+)= (A·B)·row_scale·col_scale + bias (+ row_add), A and B int8,
// exact int32 accumulation, dequantized in f32.
//
// Replaces: the s8·s8 -> s32 dot and its dequantization in the TPU
// sampler's int8 `mm` (osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py
// `_build_kernel`, :340-346) for the products that the `quantize` modes
// mark: the output product ("out"), the input product too ("io"), and
// every block product ("all"). A comes from K5 (per-row codes and scales),
// B from the host packing (per-column codes and scales, `_pack_mat`).
//
// Epilogue, in this order and in f32 with the _rn intrinsics (so it equals
// the plain version): v = float(acc)·row_scale·col_scale; v = C + v when
// accumulating (the decoder's fc1 over [h | skip] is two products with
// their own activation and weight scales, summed as the TPU sums them);
// then + bias, + row_add; stored as f32 or rounded to bf16. The int32 sum
// is exact: |sum| <= K·127^2 < 2^31 for K <= 133,000.
//
// What bounds it on the card: at the sampler's shapes (333 rows; K and N
// up to 5152 and 5142) latency and the bytes of B, as for K1.
//
// What the design does about it: tensor-core tiles through WMMA
// (16x16x16 s8 -> s32, compiled to mma.sync). A's rows are K5's output and
// B is packed with both dimensions zero-padded to multiples of 16, so tiles
// are staged with 16-byte vector loads and a mask on rows (A) and on
// 16-column groups (B) only. Shared tiles are kept as 16-wide slabs so
// every fragment starts 256-bit aligned. The same 64x64 / 32x32 tile
// choice as K1. No cp.async, TMA or wgmma yet: that is later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kBK = 32;        // k depth of a staged tile (bytes)
constexpr int kThreads = 128;  // 4 warps in a 2x2 layout over the tile

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads) gemm_s8_kernel(
    const int8_t* __restrict__ A, int lda, const int8_t* __restrict__ B, int ldb,
    void* __restrict__ C, int ldc, int out_bf16, int M, int N, int K,
    const float* __restrict__ row_scale, const float* __restrict__ col_scale, int accumulate,
    const float* __restrict__ bias, const float* __restrict__ row_add, int ldr) {
  constexpr int FM = BM / 32;  // 16-row fragments per warp
  constexpr int FN = BN / 32;  // 16-col fragments per warp
  constexpr int LDC_S = BN + 4;
  // As[ks][r][16]: k-slab ks of tile row r; Bs[ns][k][16]: n-slab ns of tile row k.
  __shared__ __align__(128) int8_t As[(kBK / 16) * BM * 16];
  __shared__ __align__(128) int8_t Bs[(BN / 16) * kBK * 16];
  __shared__ __align__(128) int Cs[BM * LDC_S];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int4 zero = make_int4(0, 0, 0, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < BM * (kBK / 16); e += kThreads) {
      const int r = e / (kBK / 16), ks = e % (kBK / 16);
      const int gr = row0 + r, gk = k0 + ks * 16;
      const int4 v = (gr < M && gk < K)
                         ? *reinterpret_cast<const int4*>(A + (size_t)gr * lda + gk) : zero;
      *reinterpret_cast<int4*>(As + (ks * BM + r) * 16) = v;
    }
    for (int e = tid; e < kBK * (BN / 16); e += kThreads) {
      const int r = e / (BN / 16), ns = e % (BN / 16);
      const int gk = k0 + r, gc = col0 + ns * 16;
      const int4 v = (gk < K && gc < ldb)
                         ? *reinterpret_cast<const int4*>(B + (size_t)gk * ldb + gc) : zero;
      *reinterpret_cast<int4*>(Bs + (ns * kBK + r) * 16) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(
            af[i], reinterpret_cast<const signed char*>(As) + (ks * BM + wm * (BM / 2) + i * 16) * 16,
            16);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int ns = (wn * (BN / 2) + j * 16) / 16;
        wmma::load_matrix_sync(
            bf[j], reinterpret_cast<const signed char*>(Bs) + (ns * kBK + ks * 16) * 16, 16);
      }
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

  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= M || gc >= N) continue;
    float v = __fmul_rn(__fmul_rn(__int2float_rn(Cs[r * LDC_S + c]), row_scale[gr]),
                        col_scale[gc]);
    const size_t at = (size_t)gr * ldc + gc;
    if (accumulate) v = __fadd_rn(reinterpret_cast<const float*>(C)[at], v);
    if (bias != nullptr) v = __fadd_rn(v, bias[gc]);
    if (row_add != nullptr) v = __fadd_rn(v, row_add[(size_t)gr * ldr + gc]);
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(C)[at] = __float2bfloat16(v);
    else
      reinterpret_cast<float*>(C)[at] = v;
  }
}

template <int BM, int BN>
void launch(const void* A, int lda, const void* B, int ldb, void* C, int ldc, int out_bf16,
            int M, int N, int K, const void* row_scale, const void* col_scale, int accumulate,
            const void* bias, const void* row_add, int ldr, cudaStream_t stream) {
  const dim3 grid(osdm::cdiv(N, BN), osdm::cdiv(M, BM));
  gemm_s8_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(A), lda, static_cast<const int8_t*>(B), ldb, C, ldc, out_bf16,
      M, N, K, static_cast<const float*>(row_scale), static_cast<const float*>(col_scale),
      accumulate, static_cast<const float*>(bias), static_cast<const float*>(row_add), ldr);
}

}  // namespace

OSDM_EXPORT int osdm_gemm_s8(const void* A, int lda, const void* B, int ldb, void* C, int ldc,
                             int out_bf16, int M, int N, int K, const void* row_scale,
                             const void* col_scale, int accumulate, const void* bias,
                             const void* row_add, int ldr, int tile, void* stream) {
  // 16-byte vector loads: K, lda and ldb multiples of 16, N within ldb.
  if (K % 16 || lda % 16 || ldb % 16 || N > ldb || (accumulate && out_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64)
    launch<64, 64>(A, lda, B, ldb, C, ldc, out_bf16, M, N, K, row_scale, col_scale, accumulate,
                   bias, row_add, ldr, s);
  else if (tile == 32)
    launch<32, 32>(A, lda, B, ldb, C, ldc, out_bf16, M, N, K, row_scale, col_scale, accumulate,
                   bias, row_add, ldr, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
