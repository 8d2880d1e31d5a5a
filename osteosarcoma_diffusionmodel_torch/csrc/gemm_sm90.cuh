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
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched through the runtime

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "common.cuh"

namespace osdm {
namespace sm90 {

constexpr int kBM = 64;        // rows of a block tile: one m64 wgmma
constexpr int kStageK = 128;   // bytes of k per stage: one swizzle span
constexpr int kThreads = 128;  // one warpgroup
constexpr int kBox = kBM * kStageK;  // 8 KB: A's stage, or one 64x64 bf16 box of B
constexpr int kRingBytes = 200 * 1024;  // of the 227 KB a block may use

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
__device__ __forceinline__ float epilogue(const Args& a, int r, int c, float acc) {
  float v = acc;
  if (a.bias != nullptr) v = __fadd_rn(v, __ldg(a.bias + c));
  if (a.row_add != nullptr) v = __fadd_rn(v, __ldg(a.row_add + (size_t)r * a.ldr + c));
  return v;
}

// K6: float(acc)·row_scale·col_scale, then + C when accumulating, + bias,
// + row_add, each rounded once (the plain version's f32 operations).
__device__ __forceinline__ float epilogue(const Args& a, int r, int c, int acc) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), __ldg(a.row_scale + r)),
                      __ldg(a.col_scale + c));
  if (a.accumulate) v = __fadd_rn(static_cast<const float*>(a.C)[(size_t)r * a.ldc + c], v);
  if (a.bias != nullptr) v = __fadd_rn(v, __ldg(a.bias + c));
  if (a.row_add != nullptr) v = __fadd_rn(v, __ldg(a.row_add + (size_t)r * a.ldr + c));
  return v;
}

__device__ __forceinline__ void store_out(const Args& a, size_t at, float v) {
  if (a.out_bf16)
    static_cast<__nv_bfloat16*>(a.C)[at] = __float2bfloat16(v);
  else
    static_cast<float*>(a.C)[at] = v;
}

template <typename T, int BN, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ Args a) {
  using Acc = typename Traits<T>::Acc;
  constexpr int kRegs = BN / 2;
  constexpr int kTileK = Traits<T>::kTileK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;
  const int ring = a.ring;
  uint8_t* sb = smem + ring * kBox;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + ring * BN * kStageK);
  int* last = reinterpret_cast<int*>(full + ring);

  const int tid = threadIdx.x;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z;
  const int kt0 = (int)((long long)split * a.k_tiles / a.splits);
  const int n_kt = (int)((long long)(split + 1) * a.k_tiles / a.splits) - kt0;

  if (kTma && tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
  }
  Acc d[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) d[i] = 0;
  fence_operand(d);

  if constexpr (kTma) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < ring; ++s) mbar_init(&full[s], 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int i = 0; i < ring && i < n_kt; ++i)
        issue_stage<T, BN>(sa + i * kBox, sb + i * BN * kStageK, &full[i], &map_a, &map_b, kt0 + i,
                           m0, n0);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % ring;
      mbar_wait(&full[s], (i / ring) & 1);
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if ((kt0 + i) * kTileK < a.a_mut_cols) {  // uniform: only k-tiles below the bits
          mutate_stage(sa + s * kBox, (kt0 + i) * kTileK, a.a_mut_cols);
          fence_proxy_async();
          __syncthreads();
        }
      }
      mma_stage<T, BN>(d, sa + s * kBox, sb + s * BN * kStageK);
      wgmma_wait<1>();  // the previous stage's group has retired ...
      __syncthreads();  // ... in every warp: refill its stage
      const int next = i - 1 + ring;
      if (tid == 0 && i >= 1 && next < n_kt) {
        const int ps = (i - 1) % ring;
        issue_stage<T, BN>(sa + ps * kBox, sb + ps * BN * kStageK, &full[ps], &map_a, &map_b,
                           kt0 + next, m0, n0);
      }
    }
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

  if (a.splits > 1) {
    Acc* slots = static_cast<Acc*>(a.partials) + (size_t)tile * a.splits * (kBM * BN);
    Acc* mine = slots + (size_t)split * (kBM * BN);
#pragma unroll
    for (int q = 0; q < kRegs; ++q) mine[q * kThreads + tid] = d[q];
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
      const Acc* slot = slots + (size_t)s * (kBM * BN) + tid;
#pragma unroll
      for (int q = 0; q < kRegs; ++q) {
        const Acc v = __ldcg(slot + q * kThreads);
        d[q] = s == 0 ? v : d[q] + v;  // ((p0 + p1) + p2) ...: split order
      }
    }
  }

  // Accumulator layout of m64nNk*: thread (warp w, lane l) holds rows
  // 16w + l/4 (+8) and columns 8i + 2(l%4) (+1) as d[4i + 2j + q]; the
  // two neighbouring columns are stored together where the output allows.
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = m0 + warp * 16 + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
  const bool pairs = (a.ldc % 2 == 0) &&
                     (reinterpret_cast<uintptr_t>(a.C) % (a.out_bf16 ? 4 : 8) == 0);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 8 * j, c = c0 + 8 * i;
      if (r >= a.M || c >= a.N) continue;
      const size_t at = (size_t)r * a.ldc + c;
      const float v0 = epilogue(a, r, c, d[4 * i + 2 * j]);
      if (pairs && c + 1 < a.N) {
        const float v1 = epilogue(a, r, c + 1, d[4 * i + 2 * j + 1]);
        if (a.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.C) + at) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.C) + at) = make_float2(v0, v1);
      } else {
        store_out(a, at, v0);
        if (c + 1 < a.N) store_out(a, at + 1, epilogue(a, r, c + 1, d[4 * i + 2 * j + 1]));
      }
    }
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

template <typename T, int BN, bool kTma>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, Args a, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(gemm_kernel<T, BN, kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(BN, stages(BN)));
  if (attr != cudaSuccess) return attr;
  // A split walks at most cdiv(k_tiles, splits) k-tiles. k-tile j >= ring
  // is issued in iteration j - ring + 1, which must come before iteration
  // j: a ring of 1 serves only single-tile splits.
  const int walk = cdiv(a.k_tiles, a.splits);
  a.ring = walk <= 1 ? 1 : (walk < stages(BN) ? walk : stages(BN));
  const dim3 grid(cdiv(a.N, BN), cdiv(a.M, kBM), a.splits);
  gemm_kernel<T, BN, kTma><<<grid, kThreads, smem_bytes(BN, a.ring), stream>>>(ma, mb, a);
  return cudaGetLastError();
}

// The block width (= the wgmma N) the host's plan chose.
template <typename T, bool kTma>
cudaError_t dispatch(int bn, const CUtensorMap& ma, const CUtensorMap& mb, const Args& a,
                     cudaStream_t stream) {
  if (a.splits < 1 || a.splits > (a.k_tiles > 0 ? a.k_tiles : 1)) return cudaErrorInvalidValue;
  if (a.splits > 1 && (a.partials == nullptr || a.tickets == nullptr)) return cudaErrorInvalidValue;
  switch (bn) {
    case 64: return launch<T, 64, kTma>(ma, mb, a, stream);
    case 128: return launch<T, 128, kTma>(ma, mb, a, stream);
    case 256: return launch<T, 256, kTma>(ma, mb, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace osdm
