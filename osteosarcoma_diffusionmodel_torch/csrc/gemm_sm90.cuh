// One Hopper GEMM mainloop, shared by K1 (gemm_bf16.cu: bf16 -> f32) and
// K6 (gemm_s8.cu: s8 -> s32). A template over the operand type: one
// warpgroup per 64-row block tile issues wgmma.mma_async on operands that
// TMA stages in a ring of shared memory, with a deterministic split of K.
//
// A stage (dynamic shared memory, 1024-byte aligned) holds 128 bytes of k:
//   A  64 rows x 128 bytes (64 bf16 or 128 int8), K-major, 128-byte swizzle;
//   B  BN x 128 bytes. int8 B is K-major like A (BN rows of the (Np, Kp)
//      codes; an 8-bit wgmma takes no transposed operand). bf16 B is the
//      caller's (K, N) row-major weight: it arrives MN-major as BN/64 boxes
//      of 64 k-rows x 64 columns and wgmma reads it transposed.
// A TMA box is exactly one 128-byte swizzle span wide, so the descriptors
// are the canonical ones: K-major start + 32 bytes per wgmma k-step with
// 1024 bytes between 8-row groups; MN-major start + 2048 bytes (16 k-rows)
// per k-step, 1024 bytes between 8-k-row groups and 8192 bytes to the next
// 64 columns. TMA zero-fills reads past the tensor, which covers ragged M,
// N and K; stores are masked.
//
// Pipeline: thread 0 arms a stage's mbarrier with the bytes it expects
// and issues its TMA loads, as many k-tiles ahead as the ring holds. All
// 128 threads wait on the stage's phase, issue its four wgmmas and keep
// one wgmma group in flight; once the previous group has retired, its
// stage is refilled.
//
// Split-K: blockIdx.z owns k-tiles [z·kt/S, (z+1)·kt/S). With S > 1 each
// split writes its accumulators to a workspace slot and takes an integer
// ticket; the last split of a tile sums the S slots in split order (one
// pass per slot, every load of a pass independent), resets the ticket to
// 0 for the next launch and runs the epilogue once. No float atomics: the
// bits do not depend on which split finished last.
//
// Operands that TMA cannot address (a base or row stride that is not a
// multiple of 16 bytes) take the general path: the same wgmma consumer,
// one stage filled by masked loads of all 128 threads in the swizzled
// layout. Only bf16 (K1) has it; the wrapper counts it as its own mode.
//
// Epilogues (template kEpi), applied once to the tile's full sum in the
// accumulator registers: kPlain stores C (+ bias, + row_add; K6's dequant
// and accumulate); kGroupNormSilu is K2's GroupNorm(8)+SiLU on that value
// (gemm_bf16_fused.cu, gemm_s8_fused.cu), stored as bf16 elsewhere;
// kPosterior is K3's step on the output product (posterior.cuh), which
// updates the bf16 carry in place and stores no product at all; kLatent is
// the latent tail's step (gemm_bf16_fused.cu): two products of one tile,
// each in its own accumulator, then K7's update of the f32 state.
//
// K6's quantizing prologue (template flag kQuantA, entry points
// osdm_gemm_s8q*): A arrives as the bf16 activations instead of K5's codes.
// Each block loads its 64-row strip over the whole K (<= 1024) by TMA,
// takes each row's amax and writes the int8 codes in place
// (strip_row_stats, quantize_tile: K5's arithmetic, rowquant.cuh); the ring
// then carries B only, and the epilogue uses the block's own row scales.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched through the runtime

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "posterior.cuh"
#include "rowquant.cuh"

namespace osdm {
namespace sm90 {

constexpr int kBM = 64;        // rows of a block tile: one m64 wgmma
constexpr int kStageK = 128;   // bytes of k per stage: one swizzle span
constexpr int kThreads = 128;  // one warpgroup
constexpr int kBox = kBM * kStageK;  // 8 KB: A's stage, or one 64x64 bf16 box of B
constexpr int kRingBytes = 200 * 1024;  // of the 227 KB a block may use

enum Epilogue { kPlain = 0, kGroupNormSilu = 1, kPosterior = 2, kLatent = 3 };
constexpr int kLatentCols = 5;  // kLatent's (n_lat, 5) table: A, c0, sv, w, v

__host__ __device__ constexpr int stage_bytes(int bn) { return kBox + bn * kStageK; }
// Deepest copy ring: as many stages as fit, so an SM keeps ~200 KB of
// loads in flight (12 at N = 64, 8 at 128, 5 at 256); with few CTAs per
// launch, bytes in flight per SM over the load latency is what bounds it.
// A launch whose splits walk fewer k-tiles takes only the stages it uses,
// so more of its CTAs share an SM.
__host__ __device__ constexpr int stages(int bn) {
  return kRingBytes / stage_bytes(bn) < 16 ? kRingBytes / stage_bytes(bn) : 16;
}
__host__ __device__ constexpr int smem_bytes(int bn, int ring) {
  return 1024 + ring * (stage_bytes(bn) + 8) + 16;  // align slack, ring, barriers, flag
}
// kQuantA: A's bf16 strip (2 boxes per int8 k-tile, K <= 1024), B's ring,
// its barriers, the strip's barriers, the flag, then inv and scale per row.
constexpr int kQuantMaxKTiles = 8;
__host__ __device__ constexpr int quant_smem_bytes(int bn, int ring, int k_tiles) {
  return 1024 + 2 * k_tiles * (kBox + 8) + ring * (bn * kStageK + 8) + 8 + 2 * kBM * 4;
}
// kQuantA's deepest B ring: the stages that fit beside the strip.
__host__ __device__ constexpr int quant_stages(int bn, int k_tiles) {
  return (kRingBytes - 2 * k_tiles * kBox) / (bn * kStageK) < 16
             ? (kRingBytes - 2 * k_tiles * kBox) / (bn * kStageK)
             : 16;
}

// Everything a launch needs besides the two tensor maps.
struct Args {
  int M, N, K;
  int k_tiles, splits;
  int ring;  // stages of the copy ring this launch uses
  void* C;
  int ldc, out_bf16;
  const float* bias;
  const float* row_add;
  int ldr;
  const float* row_scale;  // K6: per-row activation scales
  const float* col_scale;  // K6: per-column weight scales
  int accumulate;          // K6: C += result
  int a_mut_cols;          // K1: A's first columns read as 2a - 1
  const void* A;           // K1's general path: raw operands
  int lda;
  const void* B;
  int ldb;
  void* partials;  // split-K slots, tiles x splits x 64 x BN words
  int* tickets;    // one per tile, 0 between launches
  // kGroupNormSilu: groups of `group` contiguous columns, out = bf16(SiLU(
  // GN(v)·gn_scale + gn_bias)) into gn_out (row stride ldo).
  __nv_bfloat16* gn_out;
  int ldo, group;
  const float* gn_scale;
  const float* gn_bias;
  float eps;
  // kPosterior: the (M, N) bf16 carry x (row stride ldx), N = D.
  __nv_bfloat16* x;
  int ldx, mut_dim;
  const float* b_out;
  const float* coeffs;  // (n_loop, 6) table; row `step` is read in the kernel
  int step, noise_mode;
  const float* noise;  // (n_loop, M, N), "buffer" mode only
  uint32_t seed;
  float clip;
  // kLatent (N = K = H): the first product h·M2 + bias (A, B, bias above),
  // the second bf16(zeta_k)·Lᵀ (its own two maps); coeffs is the (n_lat, 5)
  // table, noise_mode "philox" or "buffer" (noise: zeta (n_lat, M, N) f32),
  // step k. Every (M, N) tensor below is contiguous.
  float* s;                  // f32 state, updated in place
  const float* c_proj;       // f32
  const float* t_add;        // (n_lat + 1, N) f32: row k + 1 is read
  __nv_bfloat16* h_in;       // the next stack input
  const __nv_bfloat16* h;    // the first product's A (row stride ldh): H_acc += w·h
  int ldh, n_lat;
  float* hacc;               // f32
  float* xi;                 // f32
  __nv_bfloat16* zeta_next;  // bf16(zeta_{k+1}), never the buffer A of this launch reads
};

template <typename T>
struct Traits;
template <>
struct Traits<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kTileK = 64;  // elements of k per stage
  static constexpr bool kBKMajor = false;
};
template <>
struct Traits<int8_t> {
  using Acc = int;
  static constexpr int kTileK = 128;
  static constexpr bool kBKMajor = true;
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();  // a copy that never lands fails, never hangs
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a wait.
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_operand(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// wgmma.mma_async m64nNk16 bf16 -> f32 (A K-major, B MN-major) and
// m64nNk32 s8 -> s32 (both K-major), accumulating into d.
template <int N>
__device__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db);
template <int N>
__device__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db));
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  wgmma_bf16<BN>(d, da, db);
}
template <int BN>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  wgmma_s8<BN>(d, da, db);
}

// The four wgmma k-steps of one stage, committed as one group.
template <typename T, int BN>
__device__ __forceinline__ void mma_stage(typename Traits<T>::Acc (&d)[BN / 2], const uint8_t* sa,
                                          const uint8_t* sb) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kStageK / 32; ++s) {
    const uint64_t da = desc(sa + 32 * s, 16, 1024);
    const uint64_t db = Traits<T>::kBKMajor ? desc(sb + 32 * s, 16, 1024)
                                            : desc(sb + 2048 * s, kBox, 1024);
    mma<BN>(d, da, db);
  }
  wgmma_commit();
}

// Thread 0: arm the stage's barrier and issue its TMA loads for k-tile kt.
template <typename T, int BN>
__device__ __forceinline__ void issue_stage(uint8_t* sa, uint8_t* sb, uint64_t* bar,
                                            const CUtensorMap* ma, const CUtensorMap* mb, int kt,
                                            int m0, int n0) {
  constexpr int kTileK = Traits<T>::kTileK;
  mbar_expect_tx(bar, stage_bytes(BN));
  tma_load(sa, ma, bar, kt * kTileK, m0);
  if (Traits<T>::kBKMajor) {
    tma_load(sb, mb, bar, kt * kTileK, n0);
  } else {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) tma_load(sb + j * kBox, mb, bar, n0 + 64 * j, kt * kTileK);
  }
}

// kQuantA: thread 0 arms the stage's barrier and issues its B load only
// (A is the block's resident strip of int8 k-tiles).
template <int BN>
__device__ __forceinline__ void issue_b_stage(uint8_t* sb, uint64_t* bar, const CUtensorMap* mb,
                                              int kt, int n0) {
  mbar_expect_tx(bar, BN * kStageK);
  tma_load(sb, mb, bar, kt * Traits<int8_t>::kTileK, n0);
}

// K6's quantizing prologue (kQuantA): K5's work on the block's own A strip.
// The strip -- all 64 rows of A over the whole K of the product (at most
// 1024), as 2·k_tiles TMA boxes of 64 bf16 columns, 128-byte swizzled, box
// j landing on bar[j] -- is read as it lands: two threads a row take its
// max |v| over every box (the swizzle only permutes 16-byte chunks within
// a row; packed bf16 maxima); rowquant.cuh gives inv and the scale (the
// epilogue's row scale, kept in `q_scale`).
__device__ __forceinline__ void strip_row_stats(const uint8_t* strip, uint64_t* bar, int k_tiles,
                                                float* q_inv, float* q_scale) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float m = 0.0f;
  for (int j = 0; j < 2 * k_tiles; ++j) {
    mbar_wait(&bar[j], 0);
    const uint4* p = reinterpret_cast<const uint4*>(strip + j * kBox + r * kStageK + half * 64);
    uint32_t w[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 v = p[c];
      w[4 * c] = v.x;
      w[4 * c + 1] = v.y;
      w[4 * c + 2] = v.z;
      w[4 * c + 3] = v.w;
    }
    m = bf16_words_max_abs<16>(w, m);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  if (half == 0) {
    const RowQuant rq = row_quant(m);
    q_inv[r] = rq.inv;
    q_scale[r] = rq.scale;
  }
  __syncthreads();
}

// int8 k-tile t of the strip (128 columns: bf16 boxes 2t and 2t+1), written
// in place over box t in the K-major swizzled layout TMA would have given
// K5's codes: every thread reads its sources, the block waits, then
// writes. Box t holds the bf16 of tile t/2, already consumed (t/2 < t, or
// t = 0 read before the wait), and no later tile reads it (they read boxes
// >= 2t + 2). A swizzled int8 stage rather than wgmma's A
// register fragment: the mainloop's shared-memory descriptors and s8 wgmma
// stay those of K6, and a fragment of the split's A would hold 8-32 more
// registers a thread through the mainloop.
__device__ __forceinline__ void quantize_tile(uint8_t* strip, int t, const float* q_inv) {
  const int tid = threadIdx.x;
  uint4 src[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // 64 rows x 8 chunks of 16 codes, 4 a thread
    const int e = tid + kThreads * q, row = e >> 3, p = e & 7;
    const uint8_t* box = strip + (2 * t + (p >> 2)) * kBox + row * kStageK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * (p & 3) + h;  // the box's 16-byte bf16 chunk
      src[q][h] = *reinterpret_cast<const uint4*>(box + (((c ^ row) & 7) << 4));
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = tid + kThreads * q, row = e >> 3, p = e & 7;
    const float inv = q_inv[row];
    const uint2 lo = bf16x8_codes(src[q][0], inv), hi = bf16x8_codes(src[q][1], inv);
    *reinterpret_cast<uint4*>(strip + t * kBox + row * kStageK + (((p ^ row) & 7) << 4)) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  fence_proxy_async();  // the codes, written by threads, are read by wgmma
}

// Byte offset of element (r, c) of a 128-byte-swizzled tile of 2-byte values.
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kStageK + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ __nv_bfloat16 two_b_minus_one(__nv_bfloat16 v) {
  return __float2bfloat16(__fsub_rn(2.0f * __bfloat162float(v), 1.0f));
}

// K1's D3PM prologue on a landed A stage whose columns start at k0: the
// columns below `mut` become 2a - 1 in place (the stage is swizzled, so each
// 16-byte chunk finds its columns through the row's XOR).
__device__ __forceinline__ void mutate_stage(uint8_t* sa, int k0, int mut) {
  for (int e = threadIdx.x; e < kBM * 8; e += kThreads) {
    const int r = e >> 3, p = e & 7;
    const int c0 = k0 + ((p ^ (r & 7)) << 3);
    if (c0 >= mut) continue;
    __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(sa + r * kStageK + p * 16);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (c0 + q < mut) v[q] = two_b_minus_one(v[q]);
  }
}

// K1's general path: one stage filled by masked loads in the layout TMA
// would have written (A K-major, B as 64-column MN-major boxes).
template <int BN>
__device__ __forceinline__ void fill_stage_general(uint8_t* sa, uint8_t* sb, const Args& a, int k0,
                                                   int m0, int n0) {
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a.A);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(a.B);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int e = threadIdx.x; e < kBM * 64; e += kThreads) {
    const int r = e >> 6, c = e & 63;
    const int gr = m0 + r, gc = k0 + c;
    __nv_bfloat16 v = (gr < a.M && gc < a.K) ? A[(size_t)gr * a.lda + gc] : zero;
    if (gc < a.a_mut_cols) v = two_b_minus_one(v);
    *reinterpret_cast<__nv_bfloat16*>(sa + swizzled(r, c)) = v;
  }
  for (int e = threadIdx.x; e < 64 * BN; e += kThreads) {
    const int kr = e / BN, c = e % BN;
    const int gk = k0 + kr, gc = n0 + c;
    const __nv_bfloat16 v = (gk < a.K && gc < a.N) ? B[(size_t)gk * a.ldb + gc] : zero;
    *reinterpret_cast<__nv_bfloat16*>(sb + (c >> 6) * kBox + swizzled(kr, c & 63)) = v;
  }
}

// Epilogues, applied once to the full sum. bias, row_add and the scales
// are read-only and never alias C, so they load through the read-only
// path (__ldg) and the loads need not wait for earlier stores.
// K1: + bias, then + row_add.
__device__ __forceinline__ float epilogue(const Args& a, int r, int c, float acc, float) {
  float v = acc;
  if (a.bias != nullptr) v = __fadd_rn(v, __ldg(a.bias + c));
  if (a.row_add != nullptr) v = __fadd_rn(v, __ldg(a.row_add + (size_t)r * a.ldr + c));
  return v;
}

// K6: float(acc)·row_scale·col_scale, then + C when accumulating, + bias,
// + row_add, each rounded once (the plain version's f32 operations).
__device__ __forceinline__ float epilogue(const Args& a, int r, int c, int acc, float row_scale) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), row_scale), __ldg(a.col_scale + c));
  if (a.accumulate) v = __fadd_rn(static_cast<const float*>(a.C)[(size_t)r * a.ldc + c], v);
  if (a.bias != nullptr) v = __fadd_rn(v, __ldg(a.bias + c));
  if (a.row_add != nullptr) v = __fadd_rn(v, __ldg(a.row_add + (size_t)r * a.ldr + c));
  return v;
}

// The fused epilogues' inputs other than the accumulators, for one
// thread's elements: columns c0 + 8i + q (i < BN/8, q < 2) of rows r0 and
// r0 + 8. One warpgroup per tile does an epilogue's work, so a load that
// waits for another serialises the tile; these are loaded in one
// straight-line batch (predicated, no branch between them), before the
// mainloop where registers allow (BN = 64), else as the epilogue starts.
template <int BN, int kEpi>
struct Ahead {
  static constexpr int kCols = BN / 4, kElems = BN / 2;
  // GN: bias, gn_scale, gn_bias; posterior: b_out; latent: bias (m_b), t_add[k + 1]
  float vec[kEpi == kGroupNormSilu ? 3 : kEpi == kLatent ? 2 : 1][kCols];
  float col_scale[kCols];                            // K6: the weight's column scales
  float row_scale[2];                                // K6: the activations' row scales
  float elem[kElems];  // GN: K6's accumulated C; posterior: Philox u ("buffer": noise z); latent: s
  uint32_t x[kEpi == kPosterior ? kElems / 2 : 1];  // posterior: the carry, bf16 pairs
  float c_proj[kEpi == kLatent ? kElems : 1];       // latent
};

// Two bf16 of a row, as one word (low half first), where the row allows a
// 4-byte access, else one by one; `two` false: the second is past N.
__device__ __forceinline__ uint32_t load_bf16_pair(const __nv_bfloat16* p, bool pairs, bool two) {
  if (pairs && two) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t lo = __bfloat16_as_ushort(p[0]);
  return two ? lo | (static_cast<uint32_t>(__bfloat16_as_ushort(p[1])) << 16) : lo;
}

__device__ __forceinline__ float bf16_half(uint32_t w, int q) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(q ? w >> 16 : w)));
}

__device__ __forceinline__ float ldg_or_zero(const float* p, bool ok) { return ok ? __ldg(p) : 0.0f; }

template <typename Acc, int BN, int kEpi>
__device__ __forceinline__ void load_ahead(const Args& a, int m0, int n0, Ahead<BN, kEpi>& in) {
  constexpr bool kInt8 = std::is_same<Acc, int>::value;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = m0 + warp * 16 + (lane >> 2), c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = c0 + 8 * i + q, k = 2 * i + q;
      const bool ok = c < a.N;
      if constexpr (kEpi == kGroupNormSilu) {
        in.vec[0][k] = ldg_or_zero(a.bias + c, ok && a.bias != nullptr);
        in.vec[1][k] = ldg_or_zero(a.gn_scale + c, ok);
        in.vec[2][k] = ldg_or_zero(a.gn_bias + c, ok);
      } else if constexpr (kEpi == kLatent) {
        in.vec[0][k] = ldg_or_zero(a.bias + c, ok);
        in.vec[1][k] = ldg_or_zero(a.t_add + (size_t)(a.step + 1) * a.N + c, ok);
      } else {
        in.vec[0][k] = ldg_or_zero(a.b_out + c, ok);
      }
      if constexpr (kInt8) in.col_scale[k] = ldg_or_zero(a.col_scale + c, ok);
    }
  if constexpr (kInt8) {  // kQuantA: the prologue's scales replace them (row_scale null)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      in.row_scale[j] =
          a.row_scale != nullptr ? ldg_or_zero(a.row_scale + r0 + 8 * j, r0 + 8 * j < a.M) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 8 * j, c = c0 + 8 * i;
      const bool ok = r < a.M && c < a.N;
      if constexpr (kEpi == kGroupNormSilu && kInt8) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          in.elem[4 * i + 2 * j + q] = ldg_or_zero(
              static_cast<const float*>(a.C) + (size_t)r * a.ldc + c + q,
              a.accumulate && ok && c + q < a.N);
      }
      if constexpr (kEpi == kPosterior) {
        const bool pairs = (a.ldx % 2 == 0) && (reinterpret_cast<uintptr_t>(a.x) % 4 == 0);
        in.x[2 * i + j] = ok ? load_bf16_pair(a.x + (size_t)r * a.ldx + c, pairs, c + 1 < a.N) : 0u;
      }
      if constexpr (kEpi == kLatent) {  // N is a multiple of 8: both columns, 8-byte pairs
        const size_t at = (size_t)r * a.N + c;
        // s is written by this thread only, after this read: a plain load
        const float2 sv = ok ? *reinterpret_cast<const float2*>(a.s + at) : make_float2(0.f, 0.f);
        const float2 cp = ok ? __ldg(reinterpret_cast<const float2*>(a.c_proj + at))
                             : make_float2(0.f, 0.f);
        in.elem[4 * i + 2 * j] = sv.x, in.elem[4 * i + 2 * j + 1] = sv.y;
        in.c_proj[4 * i + 2 * j] = cp.x, in.c_proj[4 * i + 2 * j + 1] = cp.y;
      }
    }
  if constexpr (kEpi == kPosterior) {
    // One loop for the block's mode, so the elements' Philox rounds have
    // no branch between them: "philox" draws every element, "none" only
    // the D3PM bits (in the first block column); "buffer" reads the step's
    // noise slab.
    if (a.noise_mode == kNoisePhilox || (a.noise_mode == kNoiseNone && n0 < a.mut_dim)) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int i = e >> 2, j = (e >> 1) & 1, q = e & 1;
        in.elem[e] = philox_uniform((size_t)(r0 + 8 * j) * a.N + c0 + 8 * i + q, a.seed, a.step);
      }
    } else if (a.noise_mode == kNoiseBuffer) {
      const float* noise_step = a.noise + (size_t)a.step * a.M * a.N;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int i = e >> 2, j = (e >> 1) & 1, q = e & 1;
        const int r = r0 + 8 * j, c = c0 + 8 * i + q;
        in.elem[e] = ldg_or_zero(noise_step + (size_t)r * a.N + c, r < a.M && c < a.N);
      }
    } else {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) in.elem[e] = 0.0f;
    }
  }
}

// The value K1 or K6 would store, from the accumulator and the loaded
// inputs (the plain epilogue's f32 operations in its order; row_add has no
// fused caller). K1: acc + bias.
template <int BN, int kEpi>
__device__ __forceinline__ float fused_value(const Args& a, const Ahead<BN, kEpi>& in, float acc,
                                             int k, int, int) {
  return kEpi == kGroupNormSilu && a.bias != nullptr ? __fadd_rn(acc, in.vec[0][k]) : acc;
}

// K6: float(acc)·row_scale·col_scale, + C when accumulating, + bias.
template <int BN, int kEpi>
__device__ __forceinline__ float fused_value(const Args& a, const Ahead<BN, kEpi>& in, int acc,
                                             int k, int j, int e) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), in.row_scale[j]), in.col_scale[k]);
  if constexpr (kEpi == kGroupNormSilu) {
    if (a.accumulate) v = __fadd_rn(in.elem[e], v);
    if (a.bias != nullptr) v = __fadd_rn(v, in.vec[0][k]);
  }
  return v;
}

// K2's GroupNorm(8)+SiLU on the tile's values. A group (a multiple of 8
// columns that divides BN, so it never leaves the tile) of one row lies in
// one lane quad: each lane sums its columns, the quad adds by two xor
// shuffles at the group's last 8 columns (a uniform branch), and the
// quad's first lane keeps mean and rstd in shared memory (the ring is
// free once every wgmma has retired), which only the same warp reads back.
// Statistics as K2 and the plain "f32" gn_mode: mean = s/g,
// var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps); SiLU t/(1 + e^-t)
// with the fast exp and divide (well within the bf16 rounding of the output).
template <int BN, typename Acc>
__device__ __forceinline__ void groupnorm_silu_epilogue(const Args& a, const Acc (&d)[BN / 2],
                                                        const Ahead<BN, kGroupNormSilu>& in,
                                                        uint8_t* smem, int m0, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gs = a.group, per = gs >> 3, shift = __ffs(per) - 1, groups = BN / gs;
  const float inv_gs = 1.0f / gs;  // exact: the group is a power of two
  float2* stats = reinterpret_cast<float2*>(smem);  // [64 tile rows][groups]: mean, rstd
  const int lr0 = warp * 16 + (lane >> 2);
  const int r0 = m0 + lr0, c0 = n0 + 2 * (lane & 3);
  float v[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = 4 * i + 2 * j + q;
        const float val = fused_value(a, in, d[e], 2 * i + q, j, e);
        v[e] = (r0 + 8 * j < a.M && c0 + 8 * i + q < a.N) ? val : 0.0f;
      }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float s = 0.0f, sq = 0.0f;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float v0 = v[4 * i + 2 * j], v1 = v[4 * i + 2 * j + 1];
      s += v0 + v1;
      sq += v0 * v0 + v1 * v1;
      if (((i + 1) & (per - 1)) == 0) {
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        if ((lane & 3) == 0) {
          const float mean = s * inv_gs;
          const float var = fmaxf(sq * inv_gs - mean * mean, 0.0f);
          stats[(lr0 + 8 * j) * groups + (i >> shift)] = make_float2(mean, rsqrtf(var + a.eps));
        }
        s = sq = 0.0f;
      }
    }
  }
  __syncwarp();
  const bool pairs = (a.ldo % 2 == 0) && (reinterpret_cast<uintptr_t>(a.gn_out) % 4 == 0);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = c0 + 8 * i;
    if (c >= a.N) continue;  // the same for the whole warp: N is a multiple of 8
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 8 * j;
      const float2 st = stats[(lr0 + 8 * j) * groups + (i >> shift)];
      float y[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float t =
            (v[4 * i + 2 * j + q] - st.x) * st.y * in.vec[1][2 * i + q] + in.vec[2][2 * i + q];
        y[q] = __fdividef(t, 1.0f + __expf(-t));
      }
      if (r >= a.M) continue;
      __nv_bfloat16* o = a.gn_out + (size_t)r * a.ldo + c;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y[0], y[1]);
      } else {
        o[0] = __float2bfloat16(y[0]);
        o[1] = __float2bfloat16(y[1]);
      }
    }
  }
}

// K3's step on the output product (posterior.cuh), element for element as
// the standalone kernel computes it from the stored f32 product, with the
// inputs loaded ahead; the carry is written in place, two columns at a
// time where its rows allow 4-byte bf16 pairs. kBits: 0, a block with no
// D3PM bit; 1, a block whose bits are all 0 or 1 (the sampler's: their
// posteriors are the two computed once); 2, any other bits. A block with
// bits computes both values of each element and keeps one, so that no
// branch separates its elements and they run side by side.
template <int kBits, int BN, typename Acc>
__device__ __forceinline__ void posterior_elements(const Args& a, const Acc (&d)[BN / 2],
                                                   const Ahead<BN, kPosterior>& in, int m0,
                                                   int n0) {
  const StepCoeffs cf = step_coeffs(a.coeffs, a.step);
  const BitPosteriors bp0 = bit_posteriors(0.0f, cf.beta, cf.acp_prev);
  const BitPosteriors bp1 = bit_posteriors(1.0f, cf.beta, cf.acp_prev);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = m0 + warp * 16 + (lane >> 2), c0 = n0 + 2 * (lane & 3);
  const bool pairs = (a.ldx % 2 == 0) && (reinterpret_cast<uintptr_t>(a.x) % 4 == 0);
  // Every element is computed (those past M or N on zeros) and only the
  // stores are guarded, so no branch separates the elements' arithmetic.
  float xn[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const int i = e >> 2, j = (e >> 1) & 1, q = e & 1;
    const float v = fused_value(a, in, d[e], 2 * i + q, j, e), b = in.vec[0][2 * i + q];
    const float xf = bf16_half(in.x[2 * i + j], q), u = in.elem[e];  // u, or z in "buffer"
    xn[e] = posterior_continuous(v, b, xf, u, u, cf, a.noise_mode, a.clip);
    if constexpr (kBits > 0) {
      const BitPosteriors bp = kBits == 1 ? (xf == 1.0f ? bp1 : bp0)
                                          : bit_posteriors(xf, cf.beta, cf.acp_prev);
      const float bit = posterior_bit(v, b, xf, u, u, cf, a.noise_mode, bp);
      xn[e] = c0 + 8 * i + q < a.mut_dim ? bit : xn[e];
    }
  }
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 8 * j, c = c0 + 8 * i;
      if (r >= a.M || c >= a.N) continue;
      const bool two = c + 1 < a.N;
      const float x0 = xn[4 * i + 2 * j], x1 = xn[4 * i + 2 * j + 1];
      __nv_bfloat16* xp = a.x + (size_t)r * a.ldx + c;
      if (pairs && two) {
        *reinterpret_cast<__nv_bfloat162*>(xp) = __floats2bfloat162_rn(x0, x1);
      } else {
        xp[0] = __float2bfloat16(x0);
        if (two) xp[1] = __float2bfloat16(x1);
      }
    }
}

template <int BN, typename Acc>
__device__ __forceinline__ void posterior_epilogue(const Args& a, const Acc (&d)[BN / 2],
                                                   const Ahead<BN, kPosterior>& in, int m0,
                                                   int n0) {
  if (n0 >= a.mut_dim) {  // the same for the whole block
    posterior_elements<0, BN>(a, d, in, m0, n0);
    return;
  }
  bool binary = true;
#pragma unroll
  for (int k = 0; k < BN / 4; ++k)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float xf = bf16_half(in.x[k], q);
      binary &= xf == 0.0f || xf == 1.0f;
    }
  if (__syncthreads_and(binary))
    posterior_elements<1, BN>(a, d, in, m0, n0);
  else
    posterior_elements<2, BN>(a, d, in, m0, n0);
}

// kLatent's side work: the tile's (rows, columns) slice of H_acc, xi and
// the next zeta, which no other block touches (N = H, so the output tile
// is that slice). H_acc += w_k·h, and unless k is the segment's last step
// the draw of zeta_{k+1} (Philox keyed by (seed, k + 1) at counter
// row·H + col, or zeta[k + 1] in "buffer" mode): xi += v_{k+1}·zeta_{k+1}
// and its bf16 copy into the other ping-pong buffer. None of it reads an
// accumulator, so it runs while the first TMA loads land. Four columns a
// thread (16-byte f32 accesses), a tile row in BN/4 threads; the passes
// over the tile's rows are dealt out among the splits, so each element is
// drawn once, and loaded in batches so that their loads are in flight
// together. Element for element latent_step.cu's draw (_rn intrinsics in
// the plain version's order).
template <int BN>
__device__ __forceinline__ void latent_side_work(const Args& a, int m0, int n0, int split) {
  constexpr int kQuads = BN / 4, kRows = kThreads / kQuads, kPasses = kBM / kRows, kBatch = 4;
  const int c = n0 + 4 * (threadIdx.x % kQuads), rr = m0 + threadIdx.x / kQuads;
  if (c >= a.N) return;
  const float* cf = a.coeffs + (size_t)a.step * kLatentCols;
  const float w = cf[3];
  const bool draw = a.step + 1 < a.n_lat;
  const bool buffer = a.noise_mode == kNoiseBuffer;
  const float v = draw ? cf[kLatentCols + 4] : 0.0f;
  const float* zeta = buffer && draw ? a.noise + (size_t)(a.step + 1) * a.M * a.N : nullptr;
#pragma unroll
  for (int b = 0; b < kPasses; b += kBatch) {
    bool ok[kBatch];
    uint2 hv[kBatch];
    float4 hacc[kBatch], xi[kBatch], zb[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int r = rr + kRows * (b + t);
      ok[t] = r < a.M && (b + t) % a.splits == split;
      const size_t at = (size_t)r * a.N + c;
      if (ok[t]) {
        hv[t] = __ldg(reinterpret_cast<const uint2*>(a.h + (size_t)r * a.ldh + c));
        hacc[t] = *reinterpret_cast<const float4*>(a.hacc + at);
        if (draw) xi[t] = *reinterpret_cast<const float4*>(a.xi + at);
        if (zeta != nullptr) zb[t] = __ldg(reinterpret_cast<const float4*>(zeta + at));
      }
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      if (!ok[t]) continue;
      const size_t at = (size_t)(rr + kRows * (b + t)) * a.N + c;
      const float hf[4] = {bf16_half(hv[t].x, 0), bf16_half(hv[t].x, 1), bf16_half(hv[t].y, 0),
                           bf16_half(hv[t].y, 1)};
      float4 ha = hacc[t];
      ha.x = __fadd_rn(ha.x, __fmul_rn(w, hf[0]));
      ha.y = __fadd_rn(ha.y, __fmul_rn(w, hf[1]));
      ha.z = __fadd_rn(ha.z, __fmul_rn(w, hf[2]));
      ha.w = __fadd_rn(ha.w, __fmul_rn(w, hf[3]));
      *reinterpret_cast<float4*>(a.hacc + at) = ha;
      if (!draw) continue;
      float z[4];
      if (zeta != nullptr) {
        z[0] = zb[t].x, z[1] = zb[t].y, z[2] = zb[t].z, z[3] = zb[t].w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          z[q] = __fmul_rn(__fsub_rn(philox_uniform(at + q, a.seed, a.step + 1), 0.5f),
                           kUniformScale);
      }
      float4 x = xi[t];
      x.x = __fadd_rn(x.x, __fmul_rn(v, z[0]));
      x.y = __fadd_rn(x.y, __fmul_rn(v, z[1]));
      x.z = __fadd_rn(x.z, __fmul_rn(v, z[2]));
      x.w = __fadd_rn(x.w, __fmul_rn(v, z[3]));
      *reinterpret_cast<float4*>(a.xi + at) = x;
      const __nv_bfloat162 z01 = __floats2bfloat162_rn(z[0], z[1]);
      const __nv_bfloat162 z23 = __floats2bfloat162_rn(z[2], z[3]);
      *reinterpret_cast<uint2*>(a.zeta_next + at) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&z01), *reinterpret_cast<const uint32_t*>(&z23));
    }
  }
}

// kLatent's epilogue on the two full sums: o = acc1 + m_b, then K7's
// update s <- A·s + c0·o + sv·acc2 and h_in <- bf16(s + t_add[k+1] +
// c_proj), the plain version's f32 operations in its order, so the state
// gets the bits of K1 -> K7 with the same plan (K1 adds its bias to the
// same sum the same way).
template <int BN>
__device__ __forceinline__ void latent_epilogue(const Args& a, const float (&d)[BN / 2],
                                                const float (&d2)[BN / 2],
                                                const Ahead<BN, kLatent>& in, int m0, int n0) {
  const float* cf = a.coeffs + (size_t)a.step * kLatentCols;
  const float A = cf[0], c0 = cf[1], sv = cf[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = m0 + warp * 16 + (lane >> 2), cb = n0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 8 * j, c = cb + 8 * i;
      if (r >= a.M || c >= a.N) continue;
      float sn[2], hn[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = 4 * i + 2 * j + q, k = 2 * i + q;
        const float o = __fadd_rn(d[e], in.vec[0][k]);
        sn[q] = __fadd_rn(__fadd_rn(__fmul_rn(A, in.elem[e]), __fmul_rn(c0, o)),
                          __fmul_rn(sv, d2[e]));
        hn[q] = __fadd_rn(__fadd_rn(sn[q], in.vec[1][k]), in.c_proj[e]);
      }
      const size_t at = (size_t)r * a.N + c;
      *reinterpret_cast<float2*>(a.s + at) = make_float2(sn[0], sn[1]);
      *reinterpret_cast<__nv_bfloat162*>(a.h_in + at) = __floats2bfloat162_rn(hn[0], hn[1]);
    }
}

// kQuantA: the epilogue's row scales are the prologue's, not K5's.
template <int BN, int kEpi>
__device__ __forceinline__ void quant_row_scales(Ahead<BN, kEpi>& in, const float* q_scale) {
  const int lr0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  in.row_scale[0] = q_scale[lr0];
  in.row_scale[1] = q_scale[lr0 + 8];
}

__device__ __forceinline__ void store_out(const Args& a, size_t at, float v) {
  if (a.out_bf16)
    static_cast<__nv_bfloat16*>(a.C)[at] = __float2bfloat16(v);
  else
    static_cast<float*>(a.C)[at] = v;
}

// The posterior epilogue's output product is short (K = 256: 2-4 k-tiles)
// and its elementwise work long, so its blocks keep a ring of at most two
// stages and at most 128 registers a thread: four blocks share an SM and
// the 492 tiles at 333 rows run in one wave.
constexpr int kPosteriorRing = 2;

// One block tile: the mainloop, split-K's sum and the epilogue. The
// kernels below take the tensor maps as grid constants and pass their
// addresses: A and B of the product, and for kLatent a second pair
// (map_a2, map_b2) whose product goes into a second accumulator.
template <typename T, int BN, bool kTma, int kEpi, bool kQuantA>
__device__ __forceinline__ void gemm_block(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                           const CUtensorMap* map_a2, const CUtensorMap* map_b2,
                                           const Args& a) {
  using Acc = typename Traits<T>::Acc;
  static_assert(!kQuantA || (std::is_same<T, int8_t>::value && kTma), "the prologue is K6's");
  static_assert(kEpi != kLatent || (std::is_same<T, __nv_bfloat16>::value && kTma && !kQuantA),
                "the latent step is K1's, on the TMA path");
  constexpr int kRegs = BN / 2;
  constexpr int kTileK = Traits<T>::kTileK;
  // kLatent walks each split's k-tiles twice: of the first product into d,
  // then of the second into d2 (split s owns k-tiles [s·kt/S, (s+1)·kt/S)
  // of each, as K1 splits either product alone).
  constexpr int kProducts = kEpi == kLatent ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;  // A's ring, or (kQuantA) its resident strip
  const int ring = a.ring;
  uint8_t* sb = smem + (kQuantA ? 2 * a.k_tiles : ring) * kBox;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + ring * BN * kStageK);
  uint64_t* strip_bar = full + ring;  // kQuantA: one a box
  const int strip_boxes = kQuantA ? 2 * a.k_tiles : 0;
  int* last = reinterpret_cast<int*>(full + ring + strip_boxes);
  float* q_inv = reinterpret_cast<float*>(full + ring + strip_boxes + 1);  // [64], q_scale [64]
  float* q_scale = q_inv + kBM;

  const int tid = threadIdx.x;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z;
  const int kt0 = (int)((long long)split * a.k_tiles / a.splits);
  const int n_kt = (int)((long long)(split + 1) * a.k_tiles / a.splits) - kt0;
  const int n_steps = kProducts * n_kt;  // k-tiles this block walks

  if (kTma && tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_b)) : "memory");
    if constexpr (kEpi == kLatent) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_a2)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_b2)) : "memory");
    }
  }
  Acc d[kRegs];
  [[maybe_unused]] Acc d2[kEpi == kLatent ? kRegs : 1];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) d[i] = 0;
  fence_operand(d);
  if constexpr (kEpi == kLatent) {
#pragma unroll
    for (int i = 0; i < kRegs; ++i) d2[i] = 0;
    fence_operand(d2);
  }
  // The fused epilogues' other inputs, loaded before the mainloop at BN = 64
  // (load_ahead), while the first TMA loads are in flight.
  constexpr bool kAheadEarly = kEpi != kPlain && BN == 64;
  [[maybe_unused]] Ahead<BN, kEpi> ahead;

  if constexpr (kTma) {
    // Thread 0: k-step i of the walk into stage st (kLatent: past n_kt,
    // the second product's k-tile i - n_kt).
    auto issue = [&](int i, int st) {
      if constexpr (kQuantA) {
        issue_b_stage<BN>(sb + st * BN * kStageK, &full[st], map_b, kt0 + i, n0);
      } else {
        const bool second = kEpi == kLatent && i >= n_kt;
        issue_stage<T, BN>(sa + st * kBox, sb + st * BN * kStageK, &full[st],
                           second ? map_a2 : map_a, second ? map_b2 : map_b,
                           kt0 + (second ? i - n_kt : i), m0, n0);
      }
    };
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < ring; ++s) mbar_init(&full[s], 1);
      for (int j = 0; j < strip_boxes; ++j) mbar_init(&strip_bar[j], 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      if constexpr (kQuantA) {
        for (int j = 0; j < strip_boxes; ++j) {
          mbar_expect_tx(&strip_bar[j], kBox);
          tma_load(sa + j * kBox, map_a, &strip_bar[j], 64 * j, m0);
        }
      }
      for (int i = 0; i < ring && i < n_steps; ++i) issue(i, i);
    }
    if constexpr (kQuantA) {
      strip_row_stats(sa, strip_bar, a.k_tiles, q_inv, q_scale);
      for (int t = kt0; t < kt0 + n_kt; ++t) quantize_tile(sa, t, q_inv);
      __syncthreads();  // every thread's codes are in place
    }
    if constexpr (kEpi == kLatent) latent_side_work<BN>(a, m0, n0, split);
    if constexpr (kAheadEarly) {
      load_ahead<Acc>(a, m0, n0, ahead);
      if constexpr (kQuantA) quant_row_scales(ahead, q_scale);
    }
    // k-step i into the accumulator acc (one loop per accumulator, so no
    // branch chooses the registers a wgmma writes).
    auto consume = [&](int i, Acc(&acc)[kRegs]) {
      const int s = i % ring;
      mbar_wait(&full[s], (i / ring) & 1);
      if constexpr (std::is_same<T, __nv_bfloat16>::value && kEpi != kLatent) {
        if ((kt0 + i) * kTileK < a.a_mut_cols) {  // uniform: only k-tiles below the bits
          mutate_stage(sa + s * kBox, (kt0 + i) * kTileK, a.a_mut_cols);
          fence_proxy_async();
          __syncthreads();
        }
      }
      mma_stage<T, BN>(acc, sa + (kQuantA ? kt0 + i : s) * kBox, sb + s * BN * kStageK);
      wgmma_wait<1>();  // the previous stage's group has retired ...
      __syncthreads();  // ... in every warp: refill its stage
      const int next = i - 1 + ring;
      if (tid == 0 && i >= 1 && next < n_steps) issue(next, (i - 1) % ring);
    };
    for (int i = 0; i < n_kt; ++i) consume(i, d);
    if constexpr (kEpi == kLatent)
      for (int i = n_kt; i < n_steps; ++i) consume(i, d2);
    wgmma_wait<0>();
  } else {
    static_assert(std::is_same<T, __nv_bfloat16>::value, "the general path is K1's");
    for (int i = 0; i < n_kt; ++i) {
      fill_stage_general<BN>(sa, sb, a, (kt0 + i) * kTileK, m0, n0);
      fence_proxy_async();
      __syncthreads();
      mma_stage<T, BN>(d, sa, sb);
      wgmma_wait<0>();
      __syncthreads();
    }
  }
  fence_operand(d);
  if constexpr (kEpi == kLatent) fence_operand(d2);

  if (a.splits > 1) {
    // A split's slot holds its partial of each product, kBM x BN words each.
    constexpr int kSlot = kBM * BN;
    Acc* slots = static_cast<Acc*>(a.partials) + (size_t)tile * a.splits * kProducts * kSlot;
    Acc* mine = slots + (size_t)split * kProducts * kSlot;
#pragma unroll
    for (int q = 0; q < kRegs; ++q) mine[q * kThreads + tid] = d[q];
    if constexpr (kEpi == kLatent) {
#pragma unroll
      for (int q = 0; q < kRegs; ++q) mine[kSlot + q * kThreads + tid] = d2[q];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int ticket = atomicAdd(&a.tickets[tile], 1);
      *last = ticket == a.splits - 1;
      if (*last) a.tickets[tile] = 0;  // every split has taken its ticket: reset for the next launch
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int s = 0; s < a.splits; ++s) {
      const Acc* slot = slots + (size_t)s * kProducts * kSlot + tid;
#pragma unroll
      for (int q = 0; q < kRegs; ++q) {
        const Acc v = __ldcg(slot + q * kThreads);
        d[q] = s == 0 ? v : d[q] + v;  // ((p0 + p1) + p2) ...: split order
      }
      if constexpr (kEpi == kLatent) {
#pragma unroll
        for (int q = 0; q < kRegs; ++q) {
          const Acc v = __ldcg(slot + kSlot + q * kThreads);
          d2[q] = s == 0 ? v : d2[q] + v;
        }
      }
    }
  }

  // Accumulator layout of m64nNk*: thread (warp w, lane l) holds rows
  // 16w + l/4 (+8) and columns 8i + 2(l%4) (+1) as d[4i + 2j + q]; the
  // two neighbouring columns are stored together where the output allows.
  if constexpr (kEpi != kPlain) {
    static_assert(kTma, "the fused epilogues run on the TMA path only");
    if constexpr (!kAheadEarly) {
      load_ahead<Acc>(a, m0, n0, ahead);
      if constexpr (kQuantA) quant_row_scales(ahead, q_scale);
    }
    if constexpr (kEpi == kGroupNormSilu) {
      __syncthreads();  // every warp's last wgmma has retired: the ring is free for the statistics
      groupnorm_silu_epilogue<BN>(a, d, ahead, smem, m0, n0);
    } else if constexpr (kEpi == kPosterior) {
      posterior_epilogue<BN>(a, d, ahead, m0, n0);
    } else {
      latent_epilogue<BN>(a, d, d2, ahead, m0, n0);
    }
    return;
  }
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = m0 + warp * 16 + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
  const bool pairs = (a.ldc % 2 == 0) &&
                     (reinterpret_cast<uintptr_t>(a.C) % (a.out_bf16 ? 4 : 8) == 0);
  float rs[2] = {0.0f, 0.0f};  // K6's row scales: K5's, or the prologue's
  if constexpr (std::is_same<Acc, int>::value) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 8 * j;
      rs[j] = kQuantA ? q_scale[r - m0] : (r < a.M ? __ldg(a.row_scale + r) : 0.0f);
    }
  }
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 8 * j, c = c0 + 8 * i;
      if (r >= a.M || c >= a.N) continue;
      const size_t at = (size_t)r * a.ldc + c;
      const float v0 = epilogue(a, r, c, d[4 * i + 2 * j], rs[j]);
      if (pairs && c + 1 < a.N) {
        const float v1 = epilogue(a, r, c + 1, d[4 * i + 2 * j + 1], rs[j]);
        if (a.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.C) + at) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.C) + at) = make_float2(v0, v1);
      } else {
        store_out(a, at, v0);
        if (c + 1 < a.N) store_out(a, at + 1, epilogue(a, r, c + 1, d[4 * i + 2 * j + 1], rs[j]));
      }
    }
}

template <typename T, int BN, bool kTma, int kEpi, bool kQuantA>
__global__ void __launch_bounds__(kThreads, kEpi == kPosterior ? 4 : 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ Args a) {
  gemm_block<T, BN, kTma, kEpi, kQuantA>(&map_a, &map_b, nullptr, nullptr, a);
}

// kLatent: both products of the latent step, h·M2 (map_a, map_b) and
// bf16(zeta_k)·Lᵀ (map_a2, map_b2), in one launch.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_latent_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_a2,
                       const __grid_constant__ CUtensorMap map_b2, const __grid_constant__ Args a) {
  gemm_block<__nv_bfloat16, BN, true, kLatent, false>(&map_a, &map_b, &map_a2, &map_b2, a);
}

// ---------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled fetched through the CUDA runtime, so the
// library links without -lcuda.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major (rows, cols) matrix with a row stride of `ld`
// elements, read in 128-byte-swizzled boxes of box_rows x box_cols.
// Encoded once per distinct (pointer, shape, stride, box) and cached.
inline cudaError_t tensor_map(CUtensorMap* out, const void* ptr, CUtensorMapDataType dtype,
                              int elem_bytes, int rows, int cols, int ld, int box_cols,
                              int box_rows) {
  using Key = std::tuple<const void*, int, int, int, int, int, int>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  const Key key(ptr, static_cast<int>(dtype), rows, cols, ld, box_cols, box_rows);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(out, dtype, 2, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *out);
  return cudaSuccess;
}

template <typename T, int BN, bool kTma, int kEpi, bool kQuantA>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, Args a, cudaStream_t stream,
                   const CUtensorMap* ma2, const CUtensorMap* mb2) {
  static const cudaError_t attr = [] {
    const int most = kQuantA ? quant_smem_bytes(BN, quant_stages(BN, kQuantMaxKTiles),
                                                kQuantMaxKTiles)
                             : smem_bytes(BN, stages(BN));
    if constexpr (kEpi == kLatent)
      return cudaFuncSetAttribute(gemm_latent_kernel<BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    else
      return cudaFuncSetAttribute(gemm_kernel<T, BN, kTma, kEpi, kQuantA>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }();
  if (attr != cudaSuccess) return attr;
  if (kQuantA && (a.k_tiles < 1 || a.k_tiles > kQuantMaxKTiles)) return cudaErrorInvalidValue;
  // A split walks at most cdiv(k_tiles, splits) k-tiles of each product.
  // k-tile j >= ring is issued in iteration j - ring + 1, which must come
  // before iteration j: a ring of 1 serves only single-tile walks.
  const int walk = (kEpi == kLatent ? 2 : 1) * cdiv(a.k_tiles, a.splits);
  const int deepest = kEpi == kPosterior ? kPosteriorRing
                      : kQuantA          ? quant_stages(BN, a.k_tiles)
                                         : stages(BN);
  a.ring = walk <= 1 ? 1 : (walk < deepest ? walk : deepest);
  const int bytes = kQuantA ? quant_smem_bytes(BN, a.ring, a.k_tiles) : smem_bytes(BN, a.ring);
  const dim3 grid(cdiv(a.N, BN), cdiv(a.M, kBM), a.splits);
  if constexpr (kEpi == kLatent)
    gemm_latent_kernel<BN><<<grid, kThreads, bytes, stream>>>(ma, mb, *ma2, *mb2, a);
  else
    gemm_kernel<T, BN, kTma, kEpi, kQuantA><<<grid, kThreads, bytes, stream>>>(ma, mb, a);
  return cudaGetLastError();
}

// The block width (= the wgmma N) the host's plan chose, among the widths
// this epilogue is built for (each width is one kernel in the build).
// kLatent passes the second product's maps too.
template <typename T, bool kTma, int kEpi, bool kQuantA, int... kWidths>
cudaError_t dispatch(int bn, const CUtensorMap& ma, const CUtensorMap& mb, const Args& a,
                     cudaStream_t stream, const CUtensorMap* ma2 = nullptr,
                     const CUtensorMap* mb2 = nullptr) {
  if (a.splits < 1 || a.splits > (a.k_tiles > 0 ? a.k_tiles : 1)) return cudaErrorInvalidValue;
  if (a.splits > 1 && (a.partials == nullptr || a.tickets == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  (void)(((bn == kWidths &&
           ((err = launch<T, kWidths, kTma, kEpi, kQuantA>(ma, mb, a, stream, ma2, mb2)), true))) ||
         ...);
  return err;
}

// The TMA maps of K1's operands: A (M, K) in 64 x 64 boxes, the (K, N)
// weight in 64 x 64 boxes read MN-major.
inline cudaError_t bf16_maps(CUtensorMap* ma, CUtensorMap* mb, const void* A, int lda,
                             const void* B, int ldb, int M, int N, int K) {
  const cudaError_t err = tensor_map(ma, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, lda, 64, kBM);
  return err != cudaSuccess
             ? err
             : tensor_map(mb, B, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, ldb, 64, 64);
}

// The TMA maps of K6's operands: the (M, K) codes and the K-major
// (b_rows, K) weight codes, 128 bytes of k per box.
inline cudaError_t s8_maps(CUtensorMap* ma, CUtensorMap* mb, const void* A, int lda,
                           const void* B, int ldb, int b_rows, int M, int K, int bn) {
  const cudaError_t err = tensor_map(ma, A, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, lda, kStageK, kBM);
  return err != cudaSuccess
             ? err
             : tensor_map(mb, B, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b_rows, K, ldb, kStageK, bn);
}

// The TMA maps of K6 with its quantizing prologue: A the bf16 (M, K)
// activations in 64 x 64 boxes, B the K-major (b_rows, kp) weight codes.
inline cudaError_t s8q_maps(CUtensorMap* ma, CUtensorMap* mb, const void* A, int lda,
                            const void* B, int ldb, int b_rows, int M, int K, int bn) {
  const cudaError_t err =
      tensor_map(ma, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, lda, 64, kBM);
  return err != cudaSuccess ? err
                            : tensor_map(mb, B, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b_rows,
                                         cdiv(K, 16) * 16, ldb, kStageK, bn);
}

// The prologue's operands: TMA-readable bf16 rows, K <= 1024, the codes'
// rows (kp = pad16(K) bytes, 16-byte multiple) holding N columns.
inline bool s8q_operands_fit(const void* A, int lda, int K, int ldb, int N, int b_rows) {
  return reinterpret_cast<uintptr_t>(A) % 16 == 0 && (lda * 2) % 16 == 0 && K >= 1 &&
         K <= kQuantMaxKTiles * Traits<int8_t>::kTileK && ldb >= cdiv(K, 16) * 16 &&
         ldb % 16 == 0 && N <= b_rows;
}

// The GN epilogue's precondition: groups of a multiple of 8 columns that
// tile both the block width and N.
inline bool groupnorm_fits(int group, int bn, int N) {
  return group >= 8 && group % 8 == 0 && bn % group == 0 && N % group == 0;
}

}  // namespace sm90
}  // namespace osdm
