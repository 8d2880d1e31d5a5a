// Kimi Delta Attention's chunked forward (models/kda.py, ops/kda.py): the
// gated delta rule with a decay per key channel, over whole sequences from a
// zero state, chunk 64, head widths 128.
//
//   per head, token t:  S_t = (I − β_t k_t k_tᵀ) Diag(exp g_t) S_{t−1} + β_t k_t v_tᵀ,
//                       o_t = scale · S_tᵀ q_t,
//   q, k, v, g (B, L, H, 128) f32, β (B, L, H) f32  ->  o (B, L, H, 128) f32.
//
// Within a chunk (rows i, j of it; Γ the cumulative log decay from the
// chunk's start, inclusive; S_0 the state at its start):
//   A_ij = β_i Σ_c k_ic k_jc exp(Γ_ic − Γ_jc)   (j < i),
//   P_ij = scale Σ_c q_ic k_jc exp(Γ_ic − Γ_jc)  (j ≤ i),
//   [W | U] = (I + A)⁻¹ [β ⊙ k ⊙ exp(Γ) | β ⊙ v]  (the WY/UT transform, a
//            forward substitution),
//   u = U − W S_0,   o = scale (q ⊙ exp(Γ)) S_0 + P u,
//   S_64 = Diag(exp Γ_64) S_0 + (k ⊙ exp(Γ_64 − Γ))ᵀ u.
// Every exponent is a difference that is ≤ 0 (Γ falls along the chunk), so
// no factor exceeds 1: at the published initialisation a channel can decay
// by e^-10 a token, e^-640 over a chunk, and exp(±Γ) alone would overflow.
// The state passes from chunk to chunk in f32 and never leaves the block.
//
// Replaces no TPU kernel: the JAX package has no linear attention. It takes
// the place of fla's chunked KDA (Triton), which the port may not import.
//
// What bounds it on the card: f32 arithmetic. A chunk of a head does ≈ 8.9
// MFLOP of products (the two pairwise sums over 128 channels, the
// substitution over 256 columns, three 64 × 128 × 128 products with the
// state) and ≈ 266 k exponentials, for 128 kB of input; at the cell's shape
// (6 × 1,289 tokens, 32 heads) ≈ 36 GFLOP against 0.63 GB a layer call.
//
// What the design does about it: one block per (sequence, head) walks its
// chunks in order with the state, the chunk's operands and the two 64 × 64
// matrices in shared memory (230 kB), so nothing but q, k, v, g, β is read
// and o written. q, k and Γ are stored with their 16-byte groups XOR-swizzled
// by row, so the pairwise sums' 4 × 4 tiles (rows varying across a warp)
// and the column walks of the substitution read without bank conflicts.
// Each product is a register tile per thread (4 × 8 or 8 × 8 outputs) fed by
// broadcast and 16-byte shared loads. Plain f32 SIMT throughout: the
// tensor cores are left for a later kernel.

#include "common.cuh"

namespace {

constexpr int kC = 64;         // chunk
constexpr int kD = 128;        // key and value width of a head
constexpr int kThreads = 256;
constexpr int kPStride = kC + 1;  // P's rows padded: step 5's two rows a warp in two banks
constexpr int kTiles = (kC / 4) * (kC / 4 + 1) / 2;  // 4 × 4 tiles on or below the diagonal
constexpr int kSmemFloats = kD * kD + 4 * kC * kD + kC * kC + kC * kPStride + kC + kD;
constexpr float kLog2e = 1.4426950408889634f;

// Element (row i, column d) of a swizzled [kC][kD] tile; group = d / 4.
__device__ __forceinline__ int swz(int i, int d) {
  return i * kD + ((((d >> 2) ^ i) & 31) << 2) + (d & 3);
}
__device__ __forceinline__ int swz4(int i, int group) {
  return i * kD + (((group ^ i) & 31) << 2);
}
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, 1) kda_chunk_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ beta, float* __restrict__ out, int L,
    int H, float scale) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // [kD][kD]: row = key channel
  float* Q = S + kD * kD;                      // [kC][kD] swizzled: q, then scale·q·exp(Γ)
  float* K = Q + kC * kD;                      // swizzled: k, then k·exp(Γ_64 − Γ)
  float* G = K + kC * kD;                      // swizzled: g·log2(e), Γ (log2), then W
  float* V = G + kC * kD;                      // [kC][kD]: v, then U, then u
  float* A = V + kC * kD;                      // [kC][kC]
  float* P = A + kC * kC;                      // [kC][kPStride]
  float* Bt = P + kC * kPStride;               // [kC] β
  float* Gend = Bt + kC;                       // [kD] Γ at the chunk's last row
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const size_t row_stride = (size_t)H * kD;
  const size_t base = ((size_t)b * L * H + h) * kD;

  for (int i = tid; i < kD * kD; i += kThreads) S[i] = 0.f;
  for (int i = tid; i < kC * kC + kC * kPStride; i += kThreads) A[i] = 0.f;  // A and P

  for (int t0 = 0; t0 < L; t0 += kC) {
    const int n = min(kC, L - t0);
    // 1. The chunk's rows (zeros past the sequence's end: no decay, no update).
    for (int idx = tid; idx < kC * (kD / 4); idx += kThreads) {
      const int i = idx >> 5, grp = idx & 31;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), kv = qv, vv = qv, gv = qv;
      if (i < n) {
        const size_t off = base + (size_t)(t0 + i) * row_stride + 4 * grp;
        qv = __ldg(reinterpret_cast<const float4*>(q + off));
        kv = __ldg(reinterpret_cast<const float4*>(k + off));
        vv = __ldg(reinterpret_cast<const float4*>(v + off));
        gv = __ldg(reinterpret_cast<const float4*>(g + off));
        gv = make_float4(gv.x * kLog2e, gv.y * kLog2e, gv.z * kLog2e, gv.w * kLog2e);
      }
      const int s = swz4(i, grp);
      *reinterpret_cast<float4*>(Q + s) = qv;
      *reinterpret_cast<float4*>(K + s) = kv;
      *reinterpret_cast<float4*>(G + s) = gv;
      *reinterpret_cast<float4*>(V + i * kD + 4 * grp) = vv;
    }
    if (tid < kC) Bt[tid] = tid < n ? __ldg(beta + ((size_t)b * L + t0 + tid) * H + h) : 0.f;
    __syncthreads();

    // 2. Γ: the running sum of the log2 decay down each channel.
    if (tid < kD) {
      float acc = 0.f;
      for (int i = 0; i < kC; ++i) {
        const int s = swz(i, tid);
        acc += G[s];
        G[s] = acc;
      }
      Gend[tid] = acc;
    }
    __syncthreads();

    // 3. A and P, a 4 × 4 tile of (i, j) a thread, on or below the diagonal.
    if (tid < kTiles) {
      int a = 0, p = tid;
      while (p > a) {
        p -= a + 1;
        ++a;
      }
      const int bj = p;  // tile (a, bj), bj <= a
      float acc_a[4][4] = {}, acc_p[4][4] = {};
      for (int grp = 0; grp < kD / 4; ++grp) {
        float4 qi[4], ki[4], gi[4], kj[4], gj[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int si = swz4(4 * a + m, grp), sj = swz4(4 * bj + m, grp);
          qi[m] = *reinterpret_cast<const float4*>(Q + si);
          ki[m] = *reinterpret_cast<const float4*>(K + si);
          gi[m] = *reinterpret_cast<const float4*>(G + si);
          kj[m] = *reinterpret_cast<const float4*>(K + sj);
          gj[m] = *reinterpret_cast<const float4*>(G + sj);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              // ≤ 0 on and below the diagonal; clamped above it, where it is discarded.
              const float e = exp2f(fminf(comp(gi[m], c) - comp(gj[l], c), 0.f));
              const float kk = comp(kj[l], c) * e;
              acc_a[m][l] = fmaf(comp(ki[m], c), kk, acc_a[m][l]);
              acc_p[m][l] = fmaf(comp(qi[m], c), kk, acc_p[m][l]);
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = 4 * a + m;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int j = 4 * bj + l;
          A[i * kC + j] = j < i ? Bt[i] * acc_a[m][l] : 0.f;
          P[i * kPStride + j] = j <= i ? scale * acc_p[m][l] : 0.f;
        }
      }
    }
    __syncthreads();

    // 3b. A thread a column: the decayed q and k, then the forward
    // substitution (I + A) x = rhs, for W (threads 0-127) and U (128-255).
    if (tid < kD) {
      const int d = tid;
      const float g_end = Gend[d];
      float x[kC];
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int s = swz(i, d);
        const float gi = G[s], ki = K[s];
        const float decay = exp2f(gi);
        Q[s] = Q[s] * decay * scale;
        K[s] = ki * exp2f(g_end - gi);
        float acc = Bt[i] * ki * decay;
#pragma unroll
        for (int j = 0; j < i; ++j) acc = fmaf(-A[i * kC + j], x[j], acc);
        x[i] = acc;
        G[s] = acc;  // W
      }
    } else {
      const int c = tid - kD;
      float x[kC];
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        float acc = Bt[i] * V[i * kD + c];
#pragma unroll
        for (int j = 0; j < i; ++j) acc = fmaf(-A[i * kC + j], x[j], acc);
        x[i] = acc;
        V[i * kD + c] = acc;  // U
      }
    }
    __syncthreads();

    // 4. u = U − W S_0: rows 4ty..4ty+3, columns 8tx..8tx+7 a thread.
    {
      float acc[4][8];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 u0 = *reinterpret_cast<const float4*>(V + (4 * ty + m) * kD + 8 * tx);
        const float4 u1 = *reinterpret_cast<const float4*>(V + (4 * ty + m) * kD + 8 * tx + 4);
        acc[m][0] = u0.x; acc[m][1] = u0.y; acc[m][2] = u0.z; acc[m][3] = u0.w;
        acc[m][4] = u1.x; acc[m][5] = u1.y; acc[m][6] = u1.z; acc[m][7] = u1.w;
      }
#pragma unroll 4
      for (int r = 0; r < kD; ++r) {
        const float4 s0 = *reinterpret_cast<const float4*>(S + r * kD + 8 * tx);
        const float4 s1 = *reinterpret_cast<const float4*>(S + r * kD + 8 * tx + 4);
        const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float w = G[swz(4 * ty + m, r)];
#pragma unroll
          for (int l = 0; l < 8; ++l) acc[m][l] = fmaf(-w, sv[l], acc[m][l]);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float* row = V + (4 * ty + m) * kD + 8 * tx;
        *reinterpret_cast<float4*>(row) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        *reinterpret_cast<float4*>(row + 4) =
            make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
      }
    }
    __syncthreads();

    // 5. o = scale (q ⊙ exp Γ) S_0 + P u, the same tiles, stored to the output.
    {
      float acc[4][8] = {};
#pragma unroll 4
      for (int r = 0; r < kD; ++r) {
        const float4 s0 = *reinterpret_cast<const float4*>(S + r * kD + 8 * tx);
        const float4 s1 = *reinterpret_cast<const float4*>(S + r * kD + 8 * tx + 4);
        const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float qd = Q[swz(4 * ty + m, r)];
#pragma unroll
          for (int l = 0; l < 8; ++l) acc[m][l] = fmaf(qd, sv[l], acc[m][l]);
        }
      }
      const int j_end = 4 * ty + 4;  // P is 0 above the diagonal
      for (int j = 0; j < j_end; ++j) {
        const float4 u0 = *reinterpret_cast<const float4*>(V + j * kD + 8 * tx);
        const float4 u1 = *reinterpret_cast<const float4*>(V + j * kD + 8 * tx + 4);
        const float uv[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float pv = P[(4 * ty + m) * kPStride + j];
#pragma unroll
          for (int l = 0; l < 8; ++l) acc[m][l] = fmaf(pv, uv[l], acc[m][l]);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = 4 * ty + m;
        if (i < n) {
          float* o = out + base + (size_t)(t0 + i) * row_stride + 8 * tx;
          *reinterpret_cast<float4*>(o) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
          *reinterpret_cast<float4*>(o + 4) =
              make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
        }
      }
    }
    __syncthreads();

    // 6. S = Diag(exp Γ_64) S_0 + (k ⊙ exp(Γ_64 − Γ))ᵀ u: rows 8ty..8ty+7,
    // columns 8tx..8tx+7 a thread.
    {
      float acc[8][8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float decay = exp2f(Gend[8 * ty + m]);
        const float4 s0 = *reinterpret_cast<const float4*>(S + (8 * ty + m) * kD + 8 * tx);
        const float4 s1 = *reinterpret_cast<const float4*>(S + (8 * ty + m) * kD + 8 * tx + 4);
        acc[m][0] = s0.x * decay; acc[m][1] = s0.y * decay;
        acc[m][2] = s0.z * decay; acc[m][3] = s0.w * decay;
        acc[m][4] = s1.x * decay; acc[m][5] = s1.y * decay;
        acc[m][6] = s1.z * decay; acc[m][7] = s1.w * decay;
      }
      for (int j = 0; j < n; ++j) {  // rows past the end hold u = 0
        const float4 k0 = *reinterpret_cast<const float4*>(K + swz4(j, 2 * ty));
        const float4 k1 = *reinterpret_cast<const float4*>(K + swz4(j, 2 * ty + 1));
        const float4 u0 = *reinterpret_cast<const float4*>(V + j * kD + 8 * tx);
        const float4 u1 = *reinterpret_cast<const float4*>(V + j * kD + 8 * tx + 4);
        const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
        const float uv[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int m = 0; m < 8; ++m) {
#pragma unroll
          for (int l = 0; l < 8; ++l) acc[m][l] = fmaf(kv[m], uv[l], acc[m][l]);
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float* row = S + (8 * ty + m) * kD + 8 * tx;
        *reinterpret_cast<float4*>(row) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        *reinterpret_cast<float4*>(row + 4) =
            make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// q, k, v, g, out (B, L, H, 128) and beta (B, L, H), contiguous f32, each
// base 16-byte aligned; the caller keeps B · H below 2^31.
OSDM_EXPORT int osdm_kda_chunk(const void* q, const void* k, const void* v, const void* g,
                               const void* beta, void* out, int B, int L, int H, float scale,
                               void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmemBytes = kSmemFloats * static_cast<int>(sizeof(float));
  const cudaError_t set = cudaFuncSetAttribute(
      kda_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  kda_chunk_kernel<<<B * H, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(beta), static_cast<float*>(out), L,
      H, scale);
  return static_cast<int>(cudaGetLastError());
}
