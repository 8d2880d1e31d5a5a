// K7 latent_step: the per-step elementwise work of the latent-tail sampler.
//
// Replaces: the elementwise part of `body` in the TPU's latent-segment
// kernel, osteosarcoma_diffusionmodel_tpu/ops/latent_sampler.py
// `_build_latent_kernel` (:442-457), "prng" and "buffer" noise modes. Per
// latent step k, with (A, c0, sv, w, v) from row k of the device (n_lat, 5)
// table:
//
//   draw:    zeta_k  (philox: U(-sqrt3, sqrt3) from Philox4x32-10 keyed by
//            (seed, k), counter = row·H + col, top 24 bits, as K3 draws its
//            noise; buffer: read from a (n_lat, M, H) f32 tensor)
//            zeta_bf <- bf16(zeta_k)      (the input of n_inj = zeta·Lᵀ)
//            xi      <- xi + v·zeta_k
//            H_acc   <- H_acc + w·h       (h: the step's hidden stack output;
//                                          skipped when h is null)
//   update:  s       <- A·s + c0·o_lat + sv·n_inj   (o_lat = h·M2 + m_b)
//            h_in    <- bf16(s + t_add[k+1] + c_proj)   (next stack input)
//
// Division of work. A latent step runs the five-block hidden stack (K1
// with the GroupNorm epilogue, ten launches) and then one launch of K1's
// mainloop with K7's work as its epilogue (osdm_gemm_bf16_latent_step,
// gemm_bf16_fused.cu): both 256-wide products, the update above on their
// sums, H_acc += w_k·h, and the draw of zeta_{k+1} for the next step. So
// the sampler launches this file's draw once per call, with h null, to
// prime zeta_0 and xi += v_0·zeta_0 before the loop; the update has no
// caller on the sampler's path. Both stay as the plain composition that
// the fused launch is held to (K1 -> draw -> K1 -> update, the same bits)
// and as the unfused reference. The TPU kernel adds its f32 h to H_acc;
// here h is the bf16 activation the stack stores (the port keeps
// activations in bf16 between kernels).
//
// Every operation is written with the _rn intrinsics in the plain
// version's order, so nothing is contracted into a multiply-add and the
// results equal the plain version's f32 operations.
//
// What bounds it on the card: bytes. Draw moves ~22 bytes per element
// (h, H_acc and xi read and written, zeta_bf written), update ~22 (s read
// and written, o_lat, n_inj, c_proj read, h_in written); Philox costs ten
// multiply rounds per element, well under the memory time. At 333-999 rows
// (0.5-1.8 us of bytes) a launch takes 2.7-3.7 us: launch and single-wave
// latency, which only folding the work into the product's launch removes.
//
// What the design does about it: one grid-stride pass per entry point; the
// state and both accumulators are updated in place, so no second buffer
// exists, and the next stack input is written in the same pass as s.

#include "common.cuh"

namespace {

enum DrawMode { kBuffer = 1, kPhilox = 2 };
constexpr int kCols = 5;  // A, c0, sv, w, v
constexpr float kUniformScale = 3.4641016151377544f;  // 2 sqrt3

unsigned grid_for(size_t n, int threads) {
  size_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks == 0 ? 1u : (unsigned)blocks;
}

__global__ void __launch_bounds__(256) latent_draw_kernel(
    const __nv_bfloat16* __restrict__ h, float* hacc, float* xi, __nv_bfloat16* zeta_bf, int M,
    int H, const float* __restrict__ coeffs, int step, int mode, const float* __restrict__ zeta,
    uint32_t seed) {
  const float w = coeffs[(size_t)step * kCols + 3];
  const float v = coeffs[(size_t)step * kCols + 4];
  const size_t n = (size_t)M * H;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float z;
    if (mode == kBuffer) {
      z = zeta[(size_t)step * n + i];
    } else {
      const uint4 r = osdm::philox4x32_10(make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u),
                                          make_uint2(seed, (uint32_t)step));
      const float u = (float)(r.x >> 8) * (1.0f / 16777216.0f);
      z = __fmul_rn(__fsub_rn(u, 0.5f), kUniformScale);
    }
    zeta_bf[i] = __float2bfloat16(z);
    xi[i] = __fadd_rn(xi[i], __fmul_rn(v, z));
    if (h != nullptr) hacc[i] = __fadd_rn(hacc[i], __fmul_rn(w, __bfloat162float(h[i])));
  }
}

__global__ void __launch_bounds__(256) latent_update_kernel(
    float* s, const float* __restrict__ o_lat, const float* __restrict__ n_inj,
    const float* __restrict__ c_proj, const float* __restrict__ t_add,
    const float* __restrict__ coeffs, int step, __nv_bfloat16* h_in, int M, int H) {
  const float a = coeffs[(size_t)step * kCols + 0];
  const float c0 = coeffs[(size_t)step * kCols + 1];
  const float sv = coeffs[(size_t)step * kCols + 2];
  const float* trow = t_add + (size_t)(step + 1) * H;
  const size_t n = (size_t)M * H;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int col = (int)(i % (size_t)H);
    const float sn = __fadd_rn(__fadd_rn(__fmul_rn(a, s[i]), __fmul_rn(c0, o_lat[i])),
                               __fmul_rn(sv, n_inj[i]));
    s[i] = sn;
    h_in[i] = __float2bfloat16(__fadd_rn(__fadd_rn(sn, trow[col]), c_proj[i]));
  }
}

}  // namespace

OSDM_EXPORT int osdm_latent_draw(const void* h, void* hacc, void* xi, void* zeta_bf, int M, int H,
                                 const void* coeffs, int step, int mode, const void* zeta,
                                 uint32_t seed, void* stream) {
  if ((mode != kBuffer && mode != kPhilox) || (mode == kBuffer && zeta == nullptr) || M < 0 ||
      H <= 0 || step < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  latent_draw_kernel<<<grid_for((size_t)M * H, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<float*>(hacc), static_cast<float*>(xi),
      static_cast<__nv_bfloat16*>(zeta_bf), M, H, static_cast<const float*>(coeffs), step, mode,
      static_cast<const float*>(zeta), seed);
  return static_cast<int>(cudaGetLastError());
}

OSDM_EXPORT int osdm_latent_update(void* s, const void* o_lat, const void* n_inj,
                                   const void* c_proj, const void* t_add, const void* coeffs,
                                   int step, void* h_in, int M, int H, void* stream) {
  if (M < 0 || H <= 0 || step < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  latent_update_kernel<<<grid_for((size_t)M * H, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(s), static_cast<const float*>(o_lat), static_cast<const float*>(n_inj),
      static_cast<const float*>(c_proj), static_cast<const float*>(t_add),
      static_cast<const float*>(coeffs), step, static_cast<__nv_bfloat16*>(h_in), M, H);
  return static_cast<int>(cudaGetLastError());
}
