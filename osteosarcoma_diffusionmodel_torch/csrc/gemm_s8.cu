// K6 gemm_s8: C (+)= (A·B)·row_scale·col_scale + bias (+ row_add), A and B int8,
// exact int32 accumulation, dequantized in f32.
//
// Replaces: the s8·s8 -> s32 dot and its dequantization in the TPU
// sampler's int8 `mm` (osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py
// `_build_kernel`, :336-346) for the products that the `quantize` modes
// mark: the output product ("out"), the input product too ("io"), and
// every block product ("all"). A comes from K5 (per-row codes and scales,
// (M, Kp)); B is the weight's per-column codes stored K-major, (Np, Kp),
// made once from `pack_int8`'s output.
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
  cudaError_t err = tensor_map(&ma, A, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, lda, kStageK, kBM);
  if (err == cudaSuccess)
    err = tensor_map(&mb, B, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b_rows, K, ldb, kStageK, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      dispatch<int8_t, true>(bn, ma, mb, a, static_cast<cudaStream_t>(stream)));
}
