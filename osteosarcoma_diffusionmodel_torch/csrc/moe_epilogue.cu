// The routed experts' epilogues (models/dit.py MoEFeedForward, ops/moe.py):
// the passes that follow the two grouped products (torch._grouped_mm).
//
//   moe_silu_mul_kernel: gu (R, 2I) bf16 = [g | u]  ->  out (R, I) bf16,
//     out = bf16(SiLU(f32 g) · f32 u), SiLU(x) = x / (1 + exp(-x)) in f32;
//   moe_combine_kernel: y (R, N) bf16, src (T·k,) int64, scale (R,) f32
//     ->  out (T, N) f32, out[t] = Σ_{j<k} scale[src[t·k+j]] · f32(y[src[t·k+j]]),
//     summed in the order j = 0 … k−1; a copy with src = −1 (its expert held
//     on another card of an expert-parallel layer) adds 0·0, so a token sums
//     0 to k rows (R = T·k and src a permutation where every expert is here).
//
// Replaces no TPU kernel: the JAX package has no transformer denoiser. They
// take the place of PyTorch's eager chains after the grouped products: the
// f32 cast of g, an in-place SiLU and a mixed-dtype multiply (SiLU·up,
// ≈ 1.45 GB moved at the transformer cell's shape); the inverse
// permutation's row gather, the weights' gather, a mixed-dtype multiply into
// an f32 (T·k, N) copy and a strided sum over k (the combine, ≈ 0.9 GB).
//
// What bounds them on the card: bytes. SiLU·up reads 4I and writes 2I bytes
// a row (394 MB at 46,656 × 1,408), the combine reads y once and writes the
// f32 sum (255 MB at 7,776 tokens × 6 × 2,048); the arithmetic, an expf and
// an IEEE division an element of SiLU·up, stays under the bytes' time.
//
// What the design does about it: every intermediate stays in registers, so
// each input byte is read once and each output byte written once. One
// thread takes 8 consecutive columns of one row (SiLU·up) or of one token
// (the combine), with 16-byte bf16 loads and stores where the width is a
// multiple of 8 and the bases are 16-byte aligned, scalar accesses
// otherwise; the grid strides over those items. A combine thread issues the
// loads of its token's k rows before it sums them, and writes its token's
// columns alone: no atomics, so the sum is the same on every run.
//
// Numerics: SiLU·up computes what PyTorch's eager SiLU and multiply do
// (x / (1 + expf(-x)), IEEE division, no fast math, one rounding to bf16 at
// the store), so its bits equal the eager chain's. The combine's products
// and sums are written with the _rn intrinsics (no contracted multiply-add),
// so its bits equal the plain version's left-to-right sum over k; the eager
// chain's reduction over k sums in another order.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;          // bf16 values in 16 bytes
constexpr int kRowsInFlight = 8; // combine: rows of a token loaded before they are summed
constexpr unsigned kMaxBlocks = 1u << 16;

__device__ __forceinline__ float silu_up(float g, float u) {
  return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))), u);
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 x = __bfloat1622float2(p[q]);
    f[2 * q] = x.x;
    f[2 * q + 1] = x.y;
  }
}

__global__ void __launch_bounds__(kThreads) moe_silu_mul_kernel(
    const __nv_bfloat16* __restrict__ gu, __nv_bfloat16* __restrict__ out, uint32_t items,
    uint32_t per_row, int inter, int vec) {
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < items; i += gridDim.x * kThreads) {
    const uint32_t row = i / per_row, c = i - row * per_row;
    const __nv_bfloat16* g = gu + (size_t)row * 2 * inter;
    __nv_bfloat16* o = out + (size_t)row * inter;
    if (vec) {
      const uint32_t col = c * kVec;
      const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g + col));
      const uint4 uv = __ldg(reinterpret_cast<const uint4*>(g + inter + col));
      float gf[kVec], uf[kVec];
      unpack8(gv, gf);
      unpack8(uv, uf);
      uint4 ov;
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        op[q] = __floats2bfloat162_rn(silu_up(gf[2 * q], uf[2 * q]),
                                      silu_up(gf[2 * q + 1], uf[2 * q + 1]));
      *reinterpret_cast<uint4*>(o + col) = ov;
    } else {
      o[c] = __float2bfloat16_rn(silu_up(__bfloat162float(g[c]), __bfloat162float(g[inter + c])));
    }
  }
}

__global__ void __launch_bounds__(kThreads) moe_combine_kernel(
    const __nv_bfloat16* __restrict__ y, const int64_t* __restrict__ src,
    const float* __restrict__ scale, float* __restrict__ out, uint32_t items, uint32_t per_token,
    int k, int n, int vec) {
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < items; i += gridDim.x * kThreads) {
    const uint32_t t = i / per_token, c = i - t * per_token;
    const int64_t* rows = src + (size_t)t * k;
    float* o = out + (size_t)t * n;
    if (vec) {
      const uint32_t col = c * kVec;
      float acc[kVec] = {};
      for (int j0 = 0; j0 < k; j0 += kRowsInFlight) {
        uint4 v[kRowsInFlight];
        float w[kRowsInFlight];
#pragma unroll
        for (int j = 0; j < kRowsInFlight; ++j) {
          if (j0 + j < k) {
            const int64_t r = __ldg(rows + j0 + j);
            w[j] = r < 0 ? 0.0f : __ldg(scale + r);
            v[j] = r < 0 ? make_uint4(0, 0, 0, 0)
                         : __ldg(reinterpret_cast<const uint4*>(y + (size_t)r * n + col));
          }
        }
#pragma unroll
        for (int j = 0; j < kRowsInFlight; ++j) {
          if (j0 + j < k) {
            float f[kVec];
            unpack8(v[j], f);
#pragma unroll
            for (int q = 0; q < kVec; ++q) {
              const float p = __fmul_rn(w[j], f[q]);
              acc[q] = j0 + j == 0 ? p : __fadd_rn(acc[q], p);
            }
          }
        }
      }
      float4* o4 = reinterpret_cast<float4*>(o + col);
      o4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      o4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
      float acc = 0.0f;
      for (int j = 0; j < k; ++j) {
        const int64_t r = __ldg(rows + j);
        const float p = r < 0 ? __fmul_rn(0.0f, 0.0f)
                              : __fmul_rn(__ldg(scale + r), __bfloat162float(y[(size_t)r * n + c]));
        acc = j == 0 ? p : __fadd_rn(acc, p);
      }
      o[c] = acc;
    }
  }
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

unsigned blocks_for(uint32_t items) {
  const unsigned b = (unsigned)((items + kThreads - 1) / kThreads);
  return b == 0 ? 1 : (b < kMaxBlocks ? b : kMaxBlocks);  // an empty array still launches
}

}  // namespace

// gu (rows, 2·inter) and out (rows, inter), both contiguous bf16; the caller
// keeps rows · inter below 2^31.
OSDM_EXPORT int osdm_moe_silu_mul(const void* gu, void* out, int rows, int inter, void* stream) {
  if (rows < 0 || inter <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = inter % kVec == 0 && aligned16(gu, out);
  const uint32_t per_row = vec ? inter / kVec : inter;
  const uint32_t items = (uint32_t)rows * per_row;
  moe_silu_mul_kernel<<<blocks_for(items), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(gu), static_cast<__nv_bfloat16*>(out), items, per_row,
      inter, vec);
  return static_cast<int>(cudaGetLastError());
}

// y (R, n) contiguous bf16, src (tokens·k,) int64 naming each of the R rows
// once and −1 elsewhere, scale (R,) f32, out (tokens, n) contiguous f32; the
// caller keeps tokens · n below 2^31.
OSDM_EXPORT int osdm_moe_combine(const void* y, const void* src, const void* scale, void* out,
                                 int tokens, int k, int n, void* stream) {
  if (tokens < 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = n % kVec == 0 && aligned16(y, out);
  const uint32_t per_token = vec ? n / kVec : n;
  const uint32_t items = (uint32_t)tokens * per_token;
  moe_combine_kernel<<<blocks_for(items), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const int64_t*>(src),
      static_cast<const float*>(scale), static_cast<float*>(out), items, per_token, k, n, vec);
  return static_cast<int>(cudaGetLastError());
}
