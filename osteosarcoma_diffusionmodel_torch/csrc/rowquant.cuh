// K5's per-row int8 quantization arithmetic, shared by the standalone
// kernel (rowquant_s8.cu) and K6's quantizing prologue (gemm_sm90.cuh,
// kQuantA): the same functions, so both routes give the same codes and
// scales, bit for bit.
//
//   amax = max(max_row |v|, 1e-6);  inv = 127 / amax (one rounding)
//   q = rint(v · inv) as int8 (half to even);  scale = amax · (1/127)
//
// Each is an _rn intrinsic in the plain version's order
// (sampler_kernels.rowquant_s8_plain), so nothing is contracted.
#pragma once

#include "common.cuh"

namespace osdm {

struct RowQuant {
  float inv, scale;
};

__device__ __forceinline__ RowQuant row_quant(float max_abs) {
  const float amax = fmaxf(max_abs, 1e-6f);
  return {__fdiv_rn(127.0f, amax), __fmul_rn(amax, 1.0f / 127.0f)};
}

// The D3PM input view: 2v - 1 on the mutation columns.
__device__ __forceinline__ float quant_view(float v, bool mut) {
  return mut ? __fsub_rn(2.0f * v, 1.0f) : v;
}

// rint(v · inv) in the low byte of the word: adding 1.5·2^23 rounds the
// product to an integer, half to even (the add's own rounding), and leaves
// it in the low mantissa bits for |v · inv| < 2^22, here <= 127 -- the
// bits of __float2int_rn without its quarter-rate conversion.
constexpr float kRoundMagic = 12582912.0f;  // 1.5 · 2^23
__device__ __forceinline__ uint32_t quant_code(float v, float inv) {
  return __float_as_uint(__fadd_rn(__fmul_rn(v, inv), kRoundMagic));
}

// Four codes packed into a word, low byte first.
__device__ __forceinline__ uint32_t quant_pack4(float v0, float v1, float v2, float v3,
                                                float inv) {
  const uint32_t lo = __byte_perm(quant_code(v0, inv), quant_code(v1, inv), 0x0040);
  const uint32_t hi = __byte_perm(quant_code(v2, inv), quant_code(v3, inv), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// max |v| over the bf16 pairs of `n` words, folded into m: the sign bits
// cleared, then packed bf16 maxima (a selection, so exact), widened once.
template <int n>
__device__ __forceinline__ float bf16_words_max_abs(const uint32_t* w, float m) {
  uint32_t a = w[0] & 0x7FFF7FFFu;
  __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 1; i < n; ++i) {
    const uint32_t b = w[i] & 0x7FFF7FFFu;
    h = __hmax2(h, *reinterpret_cast<const __nv_bfloat162*>(&b));
  }
  return fmaxf(m, fmaxf(__low2float(h), __high2float(h)));
}

// max |v| over the eight bf16 of a 16-byte vector.
__device__ __forceinline__ float bf16x8_max_abs(uint4 v, float m) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return bf16_words_max_abs<4>(w, m);
}

// The codes of eight bf16 (one 16-byte vector) as two words.
__device__ __forceinline__ uint2 bf16x8_codes(uint4 v, float inv) {
  return make_uint2(quant_pack4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y), inv),
                    quant_pack4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w), bf16_hi(v.w), inv));
}

}  // namespace osdm
