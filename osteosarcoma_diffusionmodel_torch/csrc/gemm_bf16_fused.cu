// K1's product with K2's, K3's or K7's work as its epilogue: the block
// products and the output product of the sampler's step, and the latent
// tail's step, one launch each.
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
//
// osdm_gemm_bf16_latent_step: one step of the latent-tail sampler, K7's
// work on K1's mainloop. Replaces, in the TPU's latent-segment kernel
// (osteosarcoma_diffusionmodel_tpu/ops/latent_sampler.py
// `_build_latent_kernel`, step `body` :442-457), the two 256-wide products
// and the step's elementwise work. Apart, a latent step launched K1 twice
// (o_lat = h·M2 + m_b, n_inj = bf16(zeta_k)·Lᵀ, f32 to device memory) and
// K7 twice (draw, update): four launches of a few microseconds each around
// a 1-10 MB step, which no kernel of that size brings near its bytes bound
// (latent_step.cu). One launch now walks both products of its tile, each
// into its own accumulator (kLatent, gemm_sm90.cuh), then applies K7's
// update to the sums in registers; the draw of the next step's zeta and
// the H_acc, xi sums run beside the mainloop on the tile's own slice of
// the state (H = N = K, so output tile and state slice coincide). zeta_0
// comes from one standalone draw before the loop. Two zeta buffers
// alternate by step parity: every block of a launch loads the full K-strip
// of zeta_k as the second product's A, so a block that wrote zeta_{k+1}
// over its slice of the same buffer would race the blocks still loading
// it. s is updated in place (each element belongs to one tile; under
// split-K only the tile's last split runs the epilogue, on the summed
// products, and the side work's rows are dealt out among the splits);
// h_in is not read in the launch. Built at width 64: two 32-register
// accumulators and the epilogue's preloaded inputs; at 999 rows, 64 tiles.
// With the same plan, the state gets the bits of K1 -> K7 -> K1 -> K7.
// What bounds it: bytes, about 9.5 MB at 999 x 256 in "philox" mode (h,
// M2, Lᵀ, s read and written, c_proj, h_in, H_acc and xi read and written,
// zeta written and read as bf16), 2.8 us at 3.35 TB/s, against 0.26 GFLOP;
// in practice the launch's and one block's latency, as for K1.

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

OSDM_EXPORT int osdm_gemm_bf16_latent_step(
    const void* h, int ldh, const void* m2, int ldm, const void* m_b, const void* zeta_cur,
    const void* l_t, int ldl, void* s, const void* c_proj, const void* t_add, const void* coeffs,
    int n_lat, int step, void* h_in, void* hacc, void* xi, void* zeta_next, int mode,
    const void* zeta, uint32_t seed, int M, int H, int bn, int splits, void* partials,
    void* tickets, void* stream) {
  if ((mode != osdm::kNoisePhilox && mode != osdm::kNoiseBuffer) ||
      (mode == osdm::kNoiseBuffer && zeta == nullptr) || M < 1 || H < 8 || H % 8 != 0 ||
      step < 0 || step >= n_lat || m_b == nullptr || zeta_cur == zeta_next)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = bf16_args(M, H, H, splits, partials, tickets);
  a.bias = static_cast<const float*>(m_b);
  a.coeffs = static_cast<const float*>(coeffs);
  a.step = step;
  a.noise_mode = mode;
  a.noise = static_cast<const float*>(zeta);
  a.seed = seed;
  a.s = static_cast<float*>(s);
  a.c_proj = static_cast<const float*>(c_proj);
  a.t_add = static_cast<const float*>(t_add);
  a.h_in = static_cast<__nv_bfloat16*>(h_in);
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.ldh = ldh;
  a.n_lat = n_lat;
  a.hacc = static_cast<float*>(hacc);
  a.xi = static_cast<float*>(xi);
  a.zeta_next = static_cast<__nv_bfloat16*>(zeta_next);
  CUtensorMap ma{}, mb{}, ma2{}, mb2{};
  cudaError_t err = bf16_maps(&ma, &mb, h, ldh, m2, ldm, M, H, H);
  if (err == cudaSuccess) err = bf16_maps(&ma2, &mb2, zeta_cur, H, l_t, ldl, M, H, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<__nv_bfloat16, true, kLatent, false, 64>(
      bn, ma, mb, a, static_cast<cudaStream_t>(stream), &ma2, &mb2));
}
