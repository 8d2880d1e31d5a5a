// K6's int8 product with K2's or K3's work as its epilogue: the block
// products and the output product of the `quantize` modes' step.
//
// Replaces: the int8 `mm` (osteosarcoma_diffusionmodel_tpu/ops/
// fused_sampler.py `_build_kernel`, :336-346) together with the stages
// that follow it on chip: GroupNorm+SiLU after a block product (`st_gn1`/
// `st_gn2`, :421-445) and the output and posterior stages after the output
// product (`st_out`/`st_post`, :449-529).
//
// What bounds them on the card, and what the design does about it: as for
// gemm_bf16_fused.cu, on K6's mainloop (s8·s8 -> s32 wgmma, exact int32
// sums). The epilogue value is K6's: float(acc)·row_scale·col_scale, + C
// when accumulating (the decoder's fc1 over [h | skip] is two products:
// the first writes its f32 result to C, the last reads it back here), then
// + bias; each rounded once, as the plain version computes it.
// - osdm_gemm_s8_gn_silu: GroupNorm(8)+SiLU on that value, bf16 into `out`.
//   Its output is the next product's A: that product's block finds each
//   row's amax over the whole K itself (osdm_gemm_s8q_*), so no K5 runs
//   between the two.
// - osdm_gemm_s8_posterior: K3's element step (posterior.cuh) on that
//   value; with the same plan the carry gets the same bits as K6 -> K3.
// TMA path only, at the widths and with the batched input loads of K1's
// (gemm_bf16_fused.cu); K6 also loads its row and column scales, and the
// first part's f32 sum where it accumulates, in that batch.
// osdm_gemm_s8q_gn_silu and osdm_gemm_s8q_posterior take the bf16
// activations in place of K5's codes and row scales and quantize them in
// the block's prologue (gemm_sm90.cuh, kQuantA; rowquant.cuh's
// arithmetic), the epilogue using the scales the block computed: the
// codes, scales and int32 sums are K5 -> K6's, so the results are too.

#include "gemm_sm90.cuh"

using namespace osdm::sm90;

namespace {

Args s8_args(int M, int N, int K, const void* row_scale, const void* col_scale, int splits,
             void* partials, void* tickets) {
  Args a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.k_tiles = osdm::cdiv(K, Traits<int8_t>::kTileK);
  a.splits = splits;
  a.row_scale = static_cast<const float*>(row_scale);
  a.col_scale = static_cast<const float*>(col_scale);
  a.partials = partials;
  a.tickets = static_cast<int*>(tickets);
  return a;
}

// TMA: 16-byte rows (K, lda, ldb multiples of 16); N within the packed rows.
bool s8_operands_fit(int K, int lda, int ldb, int N, int b_rows) {
  return K % 16 == 0 && lda % 16 == 0 && ldb % 16 == 0 && N <= b_rows;
}

// The operands of either route: K5's codes (A int8, K = kp), or the bf16
// activations that the prologue quantizes (kQuantA).
template <bool kQuantA>
bool fits(const void* A, int lda, int K, int ldb, int N, int b_rows) {
  return kQuantA ? s8q_operands_fit(A, lda, K, ldb, N, b_rows)
                 : s8_operands_fit(K, lda, ldb, N, b_rows);
}

template <bool kQuantA>
cudaError_t maps(CUtensorMap* ma, CUtensorMap* mb, const void* A, int lda, const void* B, int ldb,
                 int b_rows, int M, int K, int bn) {
  return kQuantA ? s8q_maps(ma, mb, A, lda, B, ldb, b_rows, M, K, bn)
                 : s8_maps(ma, mb, A, lda, B, ldb, b_rows, M, K, bn);
}

template <bool kQuantA>
int gn_silu(const void* A, int lda, const void* B, int ldb, int b_rows, const void* C, int ldc,
            void* out, int ldo, int M, int N, int K, const void* row_scale, const void* col_scale,
            int accumulate, const void* bias, const void* gn_scale, const void* gn_bias, int group,
            float eps, int bn, int splits, void* partials, void* tickets, void* stream) {
  if (!fits<kQuantA>(A, lda, K, ldb, N, b_rows) || !groupnorm_fits(group, bn, N) ||
      (accumulate && C == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = s8_args(M, N, K, row_scale, col_scale, splits, partials, tickets);
  a.C = const_cast<void*>(C);
  a.ldc = ldc;
  a.accumulate = accumulate;
  a.bias = static_cast<const float*>(bias);
  a.gn_out = static_cast<__nv_bfloat16*>(out);
  a.ldo = ldo;
  a.group = group;
  a.gn_scale = static_cast<const float*>(gn_scale);
  a.gn_bias = static_cast<const float*>(gn_bias);
  a.eps = eps;
  CUtensorMap ma{}, mb{};
  const cudaError_t err = maps<kQuantA>(&ma, &mb, A, lda, B, ldb, b_rows, M, K, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<int8_t, true, kGroupNormSilu, kQuantA, 64, 128>(
      bn, ma, mb, a, static_cast<cudaStream_t>(stream)));
}

template <bool kQuantA>
int posterior(const void* A, int lda, const void* B, int ldb, int b_rows, int M, int N, int K,
              const void* row_scale, const void* col_scale, void* x, int ldx, int mut_dim,
              const void* b_out, const void* coeffs, int step, int mode, const void* noise,
              uint32_t seed, float clip, int bn, int splits, void* partials, void* tickets,
              void* stream) {
  if (!fits<kQuantA>(A, lda, K, ldb, N, b_rows) || mode < osdm::kNoiseNone ||
      mode > osdm::kNoisePhilox || mut_dim < 0 || mut_dim > N)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = s8_args(M, N, K, row_scale, col_scale, splits, partials, tickets);
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
  const cudaError_t err = maps<kQuantA>(&ma, &mb, A, lda, B, ldb, b_rows, M, K, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<int8_t, true, kPosterior, kQuantA, 64>(
      bn, ma, mb, a, static_cast<cudaStream_t>(stream)));
}

}  // namespace

OSDM_EXPORT int osdm_gemm_s8_gn_silu(const void* A, int lda, const void* B, int ldb, int b_rows,
                                     const void* C, int ldc, void* out, int ldo, int M, int N,
                                     int K, const void* row_scale, const void* col_scale,
                                     int accumulate, const void* bias, const void* gn_scale,
                                     const void* gn_bias, int group, float eps, int bn, int splits,
                                     void* partials, void* tickets, void* stream) {
  return gn_silu<false>(A, lda, B, ldb, b_rows, C, ldc, out, ldo, M, N, K, row_scale, col_scale,
                        accumulate, bias, gn_scale, gn_bias, group, eps, bn, splits, partials,
                        tickets, stream);
}

OSDM_EXPORT int osdm_gemm_s8q_gn_silu(const void* A, int lda, const void* B, int ldb, int b_rows,
                                      const void* C, int ldc, void* out, int ldo, int M, int N,
                                      int K, const void* col_scale, int accumulate,
                                      const void* bias, const void* gn_scale, const void* gn_bias,
                                      int group, float eps, int bn, int splits, void* partials,
                                      void* tickets, void* stream) {
  return gn_silu<true>(A, lda, B, ldb, b_rows, C, ldc, out, ldo, M, N, K, nullptr, col_scale,
                       accumulate, bias, gn_scale, gn_bias, group, eps, bn, splits, partials,
                       tickets, stream);
}

OSDM_EXPORT int osdm_gemm_s8_posterior(const void* A, int lda, const void* B, int ldb, int b_rows,
                                       int M, int N, int K, const void* row_scale,
                                       const void* col_scale, void* x, int ldx, int mut_dim,
                                       const void* b_out, const void* coeffs, int step, int mode,
                                       const void* noise, uint32_t seed, float clip, int bn,
                                       int splits, void* partials, void* tickets, void* stream) {
  return posterior<false>(A, lda, B, ldb, b_rows, M, N, K, row_scale, col_scale, x, ldx, mut_dim,
                          b_out, coeffs, step, mode, noise, seed, clip, bn, splits, partials,
                          tickets, stream);
}

OSDM_EXPORT int osdm_gemm_s8q_posterior(const void* A, int lda, const void* B, int ldb, int b_rows,
                                        int M, int N, int K, const void* col_scale, void* x,
                                        int ldx, int mut_dim, const void* b_out,
                                        const void* coeffs, int step, int mode, const void* noise,
                                        uint32_t seed, float clip, int bn, int splits,
                                        void* partials, void* tickets, void* stream) {
  return posterior<true>(A, lda, B, ldb, b_rows, M, N, K, nullptr, col_scale, x, ldx, mut_dim,
                         b_out, coeffs, step, mode, noise, seed, clip, bn, splits, partials,
                         tickets, stream);
}
