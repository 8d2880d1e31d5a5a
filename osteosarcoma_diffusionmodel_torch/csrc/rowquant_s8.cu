// K5 rowquant_s8: per-row dynamic int8 quantization of an activation matrix.
//
//   v = x (2x - 1 on columns < mut_cols);  amax = max(max_row |v|, 1e-6)
//   q = rint(v · (127 / amax)) as int8;     scale = amax · (1/127)
//
// Replaces: the activation half of the TPU sampler's int8 `mm`
// (osteosarcoma_diffusionmodel_tpu/ops/fused_sampler.py `_build_kernel`,
// :336-339), which quantizes each product's f32 input per row before the
// s8·s8 -> s32 dot. The D3PM transform is the TPU's `st_pre`: the input
// product quantizes the denoiser's view 2b - 1 of the bits. The arithmetic
// is rowquant.cuh's, shared with K6's quantizing prologue, so the codes and
// scales equal the plain version's on both routes. The output row is
// zero-padded to `ldq` (a multiple of 16) so K6 loads 16-byte vectors
// without a mask on K.
//
// Since K6 quantizes its own A wherever K <= 1024 (gemm_sm90.cuh, kQuantA),
// the sampler launches this kernel only for the input product: the
// 5142-wide carry, 2b - 1 on the 62 bit columns under the D3PM head.
//
// What bounds it on the card: bytes. Each row is read once and written
// once at a quarter of its bf16 size (at 32,768 x 5142: 505 MB, 0.151 ms at
// 3.35 TB/s); at 333 rows, the latency of one pass over a 10 KB row.
//
// What the design does about it: one warp per row, four rows a block, or,
// up to 2048 rows (the sampler's 333), the block's four warps on one row,
// so that each thread keeps a few groups rather than ten. A
// thread owns groups of 16 columns (g = lane + 32t, or + 128t): it loads them with
// 16-byte loads (two for bf16, four for f32) and keeps them in registers
// between the row max and the codes, so the row is read once; every code
// group leaves as one 16-byte store. The max is a warp shuffle (and one
// barrier where four warps share the row); bf16 groups outside the D3PM
// columns take it as packed bf16 maxima. Groups past the register cache
// (K > 6144 bf16, 3072 f32), a row that is not 16-byte aligned and the
// row's ragged end take element loads of the same layout.

#include "rowquant.cuh"

namespace {

constexpr int kWarps = 4;  // a block
constexpr int kThreads = 32 * kWarps;
constexpr int kWideRows = 2048;  // up to this many rows, four warps share a row

template <typename T>
struct Group;  // 16 columns of a row as raw words
template <>
struct Group<__nv_bfloat16> {
  static constexpr int kWords = 8;
  static constexpr int kCache = 12;  // groups a lane keeps: 96 registers
  static __device__ __forceinline__ float elem(const uint32_t (&w)[kWords], int i) {
    return (i & 1) ? osdm::bf16_hi(w[i >> 1]) : osdm::bf16_lo(w[i >> 1]);
  }
  static __device__ __forceinline__ uint32_t bits(const __nv_bfloat16* p) {
    return __bfloat16_as_ushort(*p);
  }
};
template <>
struct Group<float> {
  static constexpr int kWords = 16;
  static constexpr int kCache = 6;
  static __device__ __forceinline__ float elem(const uint32_t (&w)[kWords], int i) {
    return __uint_as_float(w[i]);
  }
  static __device__ __forceinline__ uint32_t bits(const float* p) { return __float_as_uint(*p); }
};

template <typename T>
__device__ __forceinline__ void load_group(const T* a, int c0, int K, bool vec,
                                           uint32_t (&w)[Group<T>::kWords]) {
  constexpr int kW = Group<T>::kWords;
  if (vec && c0 + 16 <= K) {
    const uint4* p = reinterpret_cast<const uint4*>(a + c0);
#pragma unroll
    for (int u = 0; u < kW / 4; ++u) {
      const uint4 v = __ldg(p + u);
      w[4 * u] = v.x;
      w[4 * u + 1] = v.y;
      w[4 * u + 2] = v.z;
      w[4 * u + 3] = v.w;
    }
    return;
  }
  // Element loads, zeros past K, in the same word layout.
#pragma unroll
  for (int i = 0; i < kW; ++i) w[i] = 0u;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (c0 + i >= K) break;
    const uint32_t b = Group<T>::bits(a + c0 + i);
    if constexpr (kW == 16)
      w[i] = b;
    else
      w[i >> 1] |= (i & 1) ? b << 16 : b;
  }
}

template <typename T>
__device__ __forceinline__ float group_max(const uint32_t (&w)[Group<T>::kWords], int c0, int mut,
                                           float m) {
  if constexpr (Group<T>::kWords == 8) {
    if (c0 >= mut) return osdm::bf16_words_max_abs<8>(w, m);  // no D3PM view in the group
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    m = fmaxf(m, fabsf(osdm::quant_view(Group<T>::elem(w, i), c0 + i < mut)));
  return m;
}

template <typename T>
__device__ __forceinline__ void store_codes(const uint32_t (&w)[Group<T>::kWords], int c0, int mut,
                                            float inv, int8_t* q) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = osdm::quant_view(Group<T>::elem(w, i), c0 + i < mut);
  uint4 out;
  out.x = osdm::quant_pack4(v[0], v[1], v[2], v[3], inv);
  out.y = osdm::quant_pack4(v[4], v[5], v[6], v[7], inv);
  out.z = osdm::quant_pack4(v[8], v[9], v[10], v[11], inv);
  out.w = osdm::quant_pack4(v[12], v[13], v[14], v[15], inv);
  *reinterpret_cast<uint4*>(q + c0) = out;
}

// kShare warps per row: 1 (a row a warp, four a block) or kWarps (one row
// a block: few rows, so more threads each take fewer groups).
template <typename T, int kShare>
__global__ void __launch_bounds__(kThreads) rowquant_s8_kernel(
    const T* __restrict__ A, int lda, int M, int K, int mut_cols, int8_t* __restrict__ Q, int ldq,
    float* __restrict__ scale, int vec) {
  constexpr int kW = Group<T>::kWords;
  constexpr int kCache = Group<T>::kCache / kShare > 0 ? Group<T>::kCache / kShare : 1;
  constexpr int kStride = 32 * kShare;  // groups between a thread's groups
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kWarps / kShare) + warp / kShare;
  const int first = (warp % kShare) * 32 + lane;
  if (row >= M) return;  // the whole warp; with kShare = kWarps, the whole block
  const T* a = A + (size_t)row * lda;
  const int groups = ldq / 16;
  uint32_t cache[kCache][kW];
  float m = 0.0f;
#pragma unroll
  for (int t = 0; t < kCache; ++t) {
    const int g = first + kStride * t;
    if (g < groups) load_group<T>(a, 16 * g, K, vec, cache[t]);
  }
#pragma unroll
  for (int t = 0; t < kCache; ++t) {
    const int g = first + kStride * t;
    if (g < groups) m = group_max<T>(cache[t], 16 * g, mut_cols, m);
  }
  for (int g = first + kStride * kCache; g < groups; g += kStride) {
    uint32_t w[kW];
    load_group<T>(a, 16 * g, K, vec, w);
    m = group_max<T>(w, 16 * g, mut_cols, m);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if constexpr (kShare > 1) {
    if (lane == 0) red[warp] = m;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kShare; ++i) m = fmaxf(m, red[i]);
  }
  const osdm::RowQuant rq = osdm::row_quant(m);
  int8_t* q = Q + (size_t)row * ldq;
#pragma unroll
  for (int t = 0; t < kCache; ++t) {
    const int g = first + kStride * t;
    if (g < groups) store_codes<T>(cache[t], 16 * g, mut_cols, rq.inv, q);
  }
  for (int g = first + kStride * kCache; g < groups; g += kStride) {
    uint32_t w[kW];
    load_group<T>(a, 16 * g, K, vec, w);
    store_codes<T>(w, 16 * g, mut_cols, rq.inv, q);
  }
  if (first == 0) scale[row] = rq.scale;
}

template <typename T>
void launch(const T* A, int lda, int M, int K, int mut_cols, int8_t* Q, int ldq, float* scale,
            int vec, cudaStream_t s) {
  if (M <= kWideRows)
    rowquant_s8_kernel<T, kWarps><<<M, kThreads, 0, s>>>(A, lda, M, K, mut_cols, Q, ldq, scale,
                                                         vec);
  else
    rowquant_s8_kernel<T, 1><<<osdm::cdiv(M, kWarps), kThreads, 0, s>>>(A, lda, M, K, mut_cols,
                                                                        Q, ldq, scale, vec);
}

}  // namespace

OSDM_EXPORT int osdm_rowquant_s8(const void* A, int lda, int in_bf16, int M, int K, int mut_cols,
                                 void* Q, int ldq, void* scale, void* stream) {
  if (M <= 0 || K <= 0 || ldq < K || ldq % 16 || mut_cols < 0 || mut_cols > K ||
      reinterpret_cast<uintptr_t>(Q) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = in_bf16 ? 2 : 4;
  const int vec = reinterpret_cast<uintptr_t>(A) % 16 == 0 && ((size_t)lda * elem) % 16 == 0;
  if (in_bf16)
    launch(static_cast<const __nv_bfloat16*>(A), lda, M, K, mut_cols, static_cast<int8_t*>(Q), ldq,
           static_cast<float*>(scale), vec, s);
  else
    launch(static_cast<const float*>(A), lda, M, K, mut_cols, static_cast<int8_t*>(Q), ldq,
           static_cast<float*>(scale), vec, s);
  return static_cast<int>(cudaGetLastError());
}
