// K1 gemm_bf16_f32acc: C = A·B + bias (+ row_add), bf16 inputs, f32 accumulation.
//
// Replaces: the matrix products inside the whole-loop TPU sampler,
// osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py `_build_kernel`
// (`mm`, :327-350, bf16 dots with preferred_element_type=f32): x·W_in, the
// ten DenoiserBlock products and h·W_out of every reverse step, and the
// latent step's two 256-wide products.
//
// What bounds it on the card: at the sampler's shapes (333 rows, K up to
// 5142, N up to 5142) every product is far below the tensor cores' rate;
// the bound is bytes (the weight read once, A once, C written once, a few
// microseconds at most) and, in practice, latency: the input projection
// (333x5142 · 5142x256) has few output tiles and a long K loop, the block
// products are a handful of tiles each.
//
// What the design does about it (gemm_sm90.cuh): wgmma.mma_async
// m64nNk16 from shared memory, one warpgroup per 64-row tile with N = 64,
// 128 or 256; TMA fills a ring of 5-12 stages of 128-byte-swizzled tiles, so
// global latency is paid once per launch, not once per k-tile; where the
// output tiles leave SMs idle the host's plan (sampler_kernels.gemm_plan)
// splits K, and the last split of each tile sums the f32 partials in a
// fixed order and applies the epilogue once, so the result is the same
// bits from run to run. B is the (K, N) row-major weight, read MN-major
// (wgmma's transposed B). TMA needs 16-byte-aligned bases and row strides:
// the sampler pads its 5142-wide carry, acc and W_out to 5152 columns;
// other operands take the general path (masked loads into the same
// layout), which the wrapper counts as mode "unaligned".
//
// D3PM prologue (the TPU's `st_pre`, :371-385): with a_mut_cols = M > 0,
// A's first M columns (the mutation bits b of the carry) are read as
// 2b - 1. They fall in k-tile 0, so only the split that owns it transforms
// its landed A stage in place and fences it to the async proxy before the
// wgmmas read it; the bf16 carry itself is never copied.

#include "gemm_sm90.cuh"

OSDM_EXPORT int osdm_gemm_bf16_f32acc(const void* A, int lda, int a_mut_cols, const void* B,
                                      int ldb, void* C, int ldc, int out_bf16, int M, int N,
                                      int K, const void* bias, const void* row_add, int ldr,
                                      int bn, int splits, int tma, void* partials, void* tickets,
                                      void* stream) {
  using namespace osdm::sm90;
  Args a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.k_tiles = osdm::cdiv(K, Traits<__nv_bfloat16>::kTileK);
  a.splits = splits;
  a.C = C;
  a.ldc = ldc;
  a.out_bf16 = out_bf16;
  a.bias = static_cast<const float*>(bias);
  a.row_add = static_cast<const float*>(row_add);
  a.ldr = ldr;
  a.a_mut_cols = a_mut_cols;
  a.A = A;
  a.lda = lda;
  a.B = B;
  a.ldb = ldb;
  a.partials = partials;
  a.tickets = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap ma{}, mb{};
  if (!tma) return static_cast<int>(dispatch<__nv_bfloat16, false>(bn, ma, mb, a, s));
  cudaError_t err = tensor_map(&ma, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, lda, 64, kBM);
  if (err == cudaSuccess)
    err = tensor_map(&mb, B, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, ldb, 64, 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<__nv_bfloat16, true>(bn, ma, mb, a, s));
}
