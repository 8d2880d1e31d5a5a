// K6 gemm_s8: C (+)= (A·B)·row_scale·col_scale + bias (+ row_add), A and B int8,
// exact int32 accumulation, dequantized in f32.
//
// Replaces: the s8·s8 -> s32 dot and its dequantization in the TPU
// sampler's int8 `mm` (osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py
// `_build_kernel`, :336-346) for the products that the `quantize` modes
// mark: the output product ("out"), the input product too ("io"), and
// every block product ("all"). A comes from K5 (per-row codes and scales,
// (M, Kp)); B is the weight's per-column codes stored K-major, (Np, Kp),
// made once from `pack_int8`'s output. osdm_gemm_s8q takes the bf16
// activations instead and quantizes them itself (K5's arithmetic,
// rowquant.cuh, in the block's prologue): the sampler's products whose K
// is at most 1024, so K5 launches only before the input product.
//
// Epilogue, in this order and in f32 with the _rn intrinsics (so it equals
// the plain version): v = float(acc)·row_scale·col_scale; v = C + v when
// accumulating (the decoder's fc1 over [h | skip] is two products with
// their own activation and weight scales, summed as the TPU sums them);
// then + bias, + row_add; stored as f32 or rounded to bf16. The int32 sum
// is exact: |sum| <= K·127^2 < 2^31 for K <= 133,000.
//
// What bounds it on the card: at the sampler's shapes (333 rows; K and N
// up to 5152 and 5142) bytes and latency, as for K1.
//
// What the design does about it: K1's mainloop (gemm_sm90.cuh) with
// wgmma.mma_async m64nNk32 s8 -> s32. An 8-bit wgmma reads both operands
// K-major from shared memory, hence the (Np, Kp) codes; TMA fills the
// ring (5-12 stages) with 128 k-bytes per stage. The same host plan splits K;
// the partial sums stay int32, so a split product is exact and equals the
// unsplit one bit for bit.

#include "gemm_sm90.cuh"

OSDM_EXPORT int osdm_gemm_s8(const void* A, int lda, const void* B, int ldb, int b_rows, void* C,
                             int ldc, int out_bf16, int M, int N, int K, const void* row_scale,
                             const void* col_scale, int accumulate, const void* bias,
                             const void* row_add, int ldr, int bn, int splits, void* partials,
                             void* tickets, void* stream) {
  using namespace osdm::sm90;
  // TMA: 16-byte rows (K, lda, ldb multiples of 16); N within the packed rows.
  if (K % 16 || lda % 16 || ldb % 16 || N > b_rows || (accumulate && out_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.k_tiles = osdm::cdiv(K, Traits<int8_t>::kTileK);
  a.splits = splits;
  a.C = C;
  a.ldc = ldc;
  a.out_bf16 = out_bf16;
  a.bias = static_cast<const float*>(bias);
  a.row_add = static_cast<const float*>(row_add);
  a.ldr = ldr;
  a.row_scale = static_cast<const float*>(row_scale);
  a.col_scale = static_cast<const float*>(col_scale);
  a.accumulate = accumulate;
  a.partials = partials;
  a.tickets = static_cast<int*>(tickets);
  CUtensorMap ma{}, mb{};
  const cudaError_t err = s8_maps(&ma, &mb, A, lda, B, ldb, b_rows, M, K, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<int8_t, true, kPlain, false, 64, 128, 256>(
      bn, ma, mb, a, static_cast<cudaStream_t>(stream)));
}

// K6 with its quantizing prologue (gemm_sm90.cuh, kQuantA): A is the bf16
// (M, K) activations (a row-strided view; K <= 1024), quantized per row in
// the block, in place of K5's codes and row scales; the rest is
// osdm_gemm_s8's. Built at width 64, the plan's pick for the products it
// serves (K6's plain epilogue: the decoders' first fc1 parts, 333 x 256 .
// 256 x 512 and 333 x 512 . 512 x 256).
OSDM_EXPORT int osdm_gemm_s8q(const void* A, int lda, const void* B, int ldb, int b_rows, void* C,
                              int ldc, int out_bf16, int M, int N, int K, const void* col_scale,
                              int accumulate, const void* bias, const void* row_add, int ldr,
                              int bn, int splits, void* partials, void* tickets, void* stream) {
  using namespace osdm::sm90;
  if (!s8q_operands_fit(A, lda, K, ldb, N, b_rows) || (accumulate && out_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.k_tiles = osdm::cdiv(K, Traits<int8_t>::kTileK);
  a.splits = splits;
  a.C = C;
  a.ldc = ldc;
  a.out_bf16 = out_bf16;
  a.bias = static_cast<const float*>(bias);
  a.row_add = static_cast<const float*>(row_add);
  a.ldr = ldr;
  a.col_scale = static_cast<const float*>(col_scale);
  a.accumulate = accumulate;
  a.partials = partials;
  a.tickets = static_cast<int*>(tickets);
  CUtensorMap ma{}, mb{};
  const cudaError_t err = s8q_maps(&ma, &mb, A, lda, B, ldb, b_rows, M, K, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<int8_t, true, kPlain, true, 64>(
      bn, ma, mb, a, static_cast<cudaStream_t>(stream)));
}
