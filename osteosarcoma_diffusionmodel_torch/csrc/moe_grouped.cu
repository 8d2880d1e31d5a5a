// Grouped expert products of a DeepSeekMoE feed-forward layer
// (models/dit.py, the Moonlight-16B-A3B denoiser), on the sm90 wgmma/TMA
// mainloop of gemm_sm90.cuh.
//
// Replaces no TPU kernel: the JAX package has no transformer denoiser. It
// was added because the routed experts carry about 60% of the denoiser's
// operations, and a loop of one product per expert would leave the card
// idle between 64 launches a layer. The backward of the expert products
// (ops/moe.py) runs its activation gradients here too, in the kScatter
// mode on the transposed weights.
//
// The rows of A are the layer's token copies sorted by expert (ops/moe.py):
// expert e owns rows [row_off[e], row_off[e+1]) and 64-row tiles
// [tile_off[e], tile_off[e+1]). B stacks each expert's (K, N) row-major
// weight, so expert e's k-tile kt is rows e·K + 64·kt of one tensor map. A
// block (blockIdx.y) finds its expert in the prefix sums, streams its k-tiles
// through the ring as K1 does, and masks the rows of its tile that belong
// to the next expert (they are computed, never stored); blocks past the last
// tile return at once, so the grid is sized from the row count alone and
// the host never reads the routing. An expert with no rows owns no tile.
//
// Two epilogues:
//   kSwiGLU  (gate and up in one launch): B's columns are [gate | up], each
//            `inter` wide; a tile of BN accumulator columns holds BN/2 gate
//            columns and the same BN/2 up columns (its TMA boxes are chosen
//            so), and stores bf16(SiLU(g)·u), f32 arithmetic, BN/2 columns.
//   kScatter (down): C (f32) row dest[r] = acc·row_scale[r] (the routing
//            weight); with no dest / row_scale, row r and weight 1.
//
// What bounds it on the card: at the published widths (K = 2048 or 1408, N
// up to 2·1408, ~729 rows an expert) the products are compute-bound
// (~250-300 operations a byte); each expert's weight (≈ 11.5 MB gate-up)
// stays in L2 while its ~12 row tiles, adjacent in the grid, read it.
#include "gemm_sm90.cuh"

namespace osdm {
namespace moe {

using namespace sm90;

enum Epi { kSwiGLU = 0, kScatter = 1 };

struct MoeArgs {
  int K, k_tiles, ring;
  int n_out;     // output columns (kSwiGLU: inter)
  int inter;     // kSwiGLU: the up half's first column in B
  int experts;
  const int* row_off;   // (experts + 1) prefix sums of rows
  const int* tile_off;  // (experts + 1) prefix sums of 64-row tiles
  void* C;
  int ldc;
  const float* row_scale;  // kScatter, may be null
  const int* dest;         // kScatter, may be null
};

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.0f + expf(-g)) * u; }

template <int BN, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    moe_grouped_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b, const __grid_constant__ MoeArgs a) {
  constexpr int kRegs = BN / 2;
  constexpr int kOutBN = kEpi == kSwiGLU ? BN / 2 : BN;  // output columns of a tile
  const int y = blockIdx.y;
  if (y >= __ldg(a.tile_off + a.experts)) return;
  int e = 0;
  while (__ldg(a.tile_off + e + 1) <= y) ++e;
  const int row_end = __ldg(a.row_off + e + 1);
  const int m0 = __ldg(a.row_off + e) + (y - __ldg(a.tile_off + e)) * kBM;
  const int n0 = blockIdx.x * kOutBN;
  const int kb0 = e * a.K;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ring = a.ring;
  uint8_t* sa = smem;
  uint8_t* sb = smem + ring * kBox;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + ring * BN * kStageK);
  const int tid = threadIdx.x;
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
  }
  float d[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) d[i] = 0.0f;
  fence_operand(d);

  // Thread 0: k-tile i into stage st. B box j: a gate column block for
  // j < BN/128, the matching up block after it (kSwiGLU); else n0 + 64j.
  auto issue = [&](int i, int st) {
    uint64_t* bar = &full[st];
    mbar_expect_tx(bar, stage_bytes(BN));
    tma_load(sa + st * kBox, &map_a, bar, i * 64, m0);
    uint8_t* sbs = sb + st * BN * kStageK;
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      const int col = kEpi == kSwiGLU
                          ? (j < BN / 128 ? n0 + 64 * j : a.inter + n0 + 64 * (j - BN / 128))
                          : n0 + 64 * j;
      tma_load(sbs + j * kBox, &map_b, bar, col, kb0 + i * 64);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < ring; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < ring && i < a.k_tiles; ++i) issue(i, i);
  for (int i = 0; i < a.k_tiles; ++i) {
    const int s = i % ring;
    mbar_wait(&full[s], (i / ring) & 1);
    mma_stage<__nv_bfloat16, BN>(d, sa + s * kBox, sb + s * BN * kStageK);
    wgmma_wait<1>();  // the previous stage's group has retired ...
    __syncthreads();  // ... in every warp: refill its stage
    const int next = i - 1 + ring;
    if (tid == 0 && i >= 1 && next < a.k_tiles) issue(next, (i - 1) % ring);
  }
  wgmma_wait<0>();
  fence_operand(d);

  // Accumulator layout of m64nNk16: thread (warp w, lane l) holds rows
  // 16w + l/4 (+8) and columns 8i + 2(l%4) (+1) as d[4i + 2j + q].
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = m0 + warp * 16 + (lane >> 2), c0 = n0 + 2 * (lane & 3);
  if constexpr (kEpi == kSwiGLU) {
    __nv_bfloat16* C = static_cast<__nv_bfloat16*>(a.C);
#pragma unroll
    for (int i = 0; i < BN / 16; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r0 + 8 * j, c = c0 + 8 * i;
        if (r >= row_end || c >= a.n_out) continue;
        const int g = 4 * i + 2 * j, u = 4 * (i + BN / 16) + 2 * j;
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)r * a.ldc + c) =
            __floats2bfloat162_rn(silu_mul(d[g], d[u]), silu_mul(d[g + 1], d[u + 1]));
      }
  } else {
    float* C = static_cast<float*>(a.C);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 8 * j;
      if (r >= row_end) continue;
      const float w = a.row_scale != nullptr ? __ldg(a.row_scale + r) : 1.0f;
      const size_t row = a.dest != nullptr ? (size_t)__ldg(a.dest + r) : (size_t)r;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int c = c0 + 8 * i;
        if (c >= a.n_out) continue;
        *reinterpret_cast<float2*>(C + row * a.ldc + c) =
            make_float2(d[4 * i + 2 * j] * w, d[4 * i + 2 * j + 1] * w);
      }
    }
  }
}

template <int BN, int kEpi>
cudaError_t launch_grouped(const CUtensorMap& ma, const CUtensorMap& mb, MoeArgs a,
                           int max_tiles, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(moe_grouped_kernel<BN, kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(BN, stages(BN)));
  if (attr != cudaSuccess) return attr;
  a.ring = a.k_tiles < stages(BN) ? a.k_tiles : stages(BN);
  constexpr int kOutBN = kEpi == kSwiGLU ? BN / 2 : BN;
  const dim3 grid(cdiv(a.n_out, kOutBN), max_tiles);
  moe_grouped_kernel<BN, kEpi><<<grid, kThreads, smem_bytes(BN, a.ring), stream>>>(ma, mb, a);
  return cudaGetLastError();
}

}  // namespace moe
}  // namespace osdm

// A (rows_a, K) bf16 row-major (row stride lda), B (experts·K, b_cols) bf16
// row-major (ldb), C: kSwiGLU bf16 (rows_a, inter), kScatter f32 (·, n_out),
// row stride ldc. row_off / tile_off: int32 (experts + 1) on the device;
// max_tiles: the grid's rows of tiles, at least tile_off[experts]. K and the
// output width multiples of 64; kSwiGLU: b_cols = 2·inter. A tile whose
// gate boxes pass `inter` reads up columns there, and its up boxes zeros
// past 2·inter: those columns are past n_out, never stored.
OSDM_EXPORT int osdm_moe_grouped(const void* A, int lda, int rows_a, const void* B, int ldb,
                                 int b_cols, int experts, int K, void* C, int ldc, int n_out,
                                 int epi, const void* row_off, const void* tile_off, int max_tiles,
                                 const void* row_scale, const void* dest, void* stream) {
  using namespace osdm::sm90;
  using osdm::moe::MoeArgs;
  constexpr int kBN = 256;
  if (K % 64 != 0 || n_out % 64 != 0 || experts < 1 || max_tiles < 1 ||
      (epi == osdm::moe::kSwiGLU && b_cols != 2 * n_out))
    return static_cast<int>(cudaErrorInvalidValue);
  MoeArgs a{};
  a.K = K;
  a.k_tiles = K / 64;
  a.n_out = n_out;
  a.inter = n_out;
  a.experts = experts;
  a.row_off = static_cast<const int*>(row_off);
  a.tile_off = static_cast<const int*>(tile_off);
  a.C = C;
  a.ldc = ldc;
  a.row_scale = static_cast<const float*>(row_scale);
  a.dest = static_cast<const int*>(dest);
  CUtensorMap ma{}, mb{};
  cudaError_t err =
      tensor_map(&ma, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows_a, K, lda, 64, kBM);
  if (err == cudaSuccess)
    err = tensor_map(&mb, B, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, experts * K, b_cols, ldb, 64, 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      epi == osdm::moe::kSwiGLU
          ? osdm::moe::launch_grouped<kBN, osdm::moe::kSwiGLU>(ma, mb, a, max_tiles, s)
          : osdm::moe::launch_grouped<kBN, osdm::moe::kScatter>(ma, mb, a, max_tiles, s));
}
