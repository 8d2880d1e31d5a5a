// K1's product with K2's or K3's work as its epilogue: the block products
// and the output product of the sampler's step, one launch each.
//
// Replaces: in the whole-loop TPU sampler,
// osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py `_build_kernel`,
// the GroupNorm stages that follow each block product (`st_gn1`/`st_gn2`,
// :421-445, `_groupnorm` :167) and the output and posterior stages that
// follow the output product (`st_out`/`st_post`, :449-529). The TPU kernel
// applies them to values its product has just left on chip; so do these.
//
// What bounds them on the card: at the sampler's shapes (333 rows) the
// bytes of A, B and the bf16 output (GN), or of A, B and the bf16 carry
// read and written (posterior): a few microseconds at most, and in
// practice the mainloop's latency, as for K1. Apart, K1 wrote the f32
// pre-activation (or the f32 output product, 6.9 MB at 333 x 5152) to
// device memory and K2 (K3) read it back in a launch of its own.
//
// What the design does about it: the mainloop of gemm_sm90.cuh, unchanged
// (TMA ring, wgmma, deterministic split-K), then an epilogue on the
// accumulator registers of the tile's last split:
// - osdm_gemm_bf16_gn_silu: v = acc + bias, then GroupNorm(8) with f32
//   statistics and SiLU, stored as bf16 into `out` (may be a row-strided
//   view, the decoder's [h | skip] halves). A group of `group` = N/8
//   columns must be a multiple of 8 dividing the block width (the host's
//   plan picks only such widths), so its statistics never leave the tile:
//   per-lane sums, two quad shuffles, shared memory within the warp.
// - osdm_gemm_bf16_posterior: K3's element step (posterior.cuh) on the
//   f32 product in registers, the carry x updated in place; no product
//   is stored. The value is the one K1 would have stored and K3 read back,
//   so with the same plan the carry gets the same bits as the K1 -> K3 pair.
// - Every input of an epilogue other than the accumulators (bias and the
//   GN vectors; b_out, the tile's Philox uniforms and carry values) is
//   loaded in one batch, before the mainloop at width 64: one warpgroup per
//   tile does the epilogue alone, and loads that wait one after another
//   would serialise it.
// Both run on the TMA path only. The GN epilogue is built at widths 64
// (every block product of the paths) and 128; at 256 its inputs and
// accumulators do not fit in registers. The posterior epilogue is built at
// 64 only, the fastest width for the output product at 333 and 999 rows
// (scripts/sweep_gemm_plans.py), with a ring of two stages and four blocks
// to an SM, so the 492 tiles at 333 rows run in one wave.

#include "gemm_sm90.cuh"

using namespace osdm::sm90;

namespace {

Args bf16_args(int M, int N, int K, int splits, void* partials, void* tickets) {
  Args a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.k_tiles = osdm::cdiv(K, Traits<__nv_bfloat16>::kTileK);
  a.splits = splits;
  a.partials = partials;
  a.tickets = static_cast<int*>(tickets);
  return a;
}

}  // namespace

OSDM_EXPORT int osdm_gemm_bf16_gn_silu(const void* A, int lda, const void* B, int ldb, void* out,
                                       int ldo, int M, int N, int K, const void* bias,
                                       const void* gn_scale, const void* gn_bias, int group,
                                       float eps, int bn, int splits, void* partials,
                                       void* tickets, void* stream) {
  if (!groupnorm_fits(group, bn, N)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = bf16_args(M, N, K, splits, partials, tickets);
  a.bias = static_cast<const float*>(bias);
  a.gn_out = static_cast<__nv_bfloat16*>(out);
  a.ldo = ldo;
  a.group = group;
  a.gn_scale = static_cast<const float*>(gn_scale);
  a.gn_bias = static_cast<const float*>(gn_bias);
  a.eps = eps;
  CUtensorMap ma{}, mb{};
  const cudaError_t err = bf16_maps(&ma, &mb, A, lda, B, ldb, M, N, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<__nv_bfloat16, true, kGroupNormSilu, false, 64, 128>(
      bn, ma, mb, a, static_cast<cudaStream_t>(stream)));
}

OSDM_EXPORT int osdm_gemm_bf16_posterior(const void* A, int lda, const void* B, int ldb, int M,
                                         int N, int K, void* x, int ldx, int mut_dim,
                                         const void* b_out, const void* coeffs, int step, int mode,
                                         const void* noise, uint32_t seed, float clip, int bn,
                                         int splits, void* partials, void* tickets, void* stream) {
  if (mode < osdm::kNoiseNone || mode > osdm::kNoisePhilox || mut_dim < 0 || mut_dim > N)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = bf16_args(M, N, K, splits, partials, tickets);
  a.x = static_cast<__nv_bfloat16*>(x);
  a.ldx = ldx;
  a.mut_dim = mut_dim;
  a.b_out = static_cast<const float*>(b_out);
  a.coeffs = static_cast<const float*>(coeffs);
  a.step = step;
  a.noise_mode = mode;
  a.noise = static_cast<const float*>(noise);
  a.seed = seed;
  a.clip = clip;
  CUtensorMap ma{}, mb{};
  const cudaError_t err = bf16_maps(&ma, &mb, A, lda, B, ldb, M, N, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<__nv_bfloat16, true, kPosterior, false, 64>(
      bn, ma, mb, a, static_cast<cudaStream_t>(stream)));
}
