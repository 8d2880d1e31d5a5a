// K4 rbf_kernel_sum: sum_ij exp(-gamma ||x_i - y_j||^2), never storing the Gram matrix.
//
// Replaces: osteosarcoma_diffusionmodel_tpu/ops/pallas_kernels.py
// `rbf_kernel_sum` (body `_kernel_sum_block`), the tiled kernel sum
// behind the validator's MMD. Same algebra: ||x||^2 + ||y||^2 - 2 x·y,
// clamped at 0, exp, rows past n or m masked.
//
// What bounds it on the card: f32 FMA throughput. The cross products
// must be f32-accurate (no TF32): at d = 5142 the subtraction cancels,
// so tensor-core TF32 would lose the small distances.
//
// What the design does about it: a register-blocked FMA tile (64x64
// outputs per block, 4x4 per thread, K staged through shared memory in
// chunks of 16, ragged n, m and d masked at the loads). The TPU grid
// runs in order and folds every tile into one accumulator; GPU blocks
// run in no order, so each block writes an f64 partial and the last
// block to finish (an integer ticket) sums the partials in a fixed
// order. No float atomics: the result is the same from run to run. The
// caller passes a zeroed ticket for every launch.

#include "common.cuh"

namespace {

constexpr int kTM = 64, kTN = 64, kTK = 16, kThreads = 256;

__global__ void __launch_bounds__(kThreads) rbf_kernel_sum_kernel(
    const float* __restrict__ X, const float* __restrict__ Y, const float* __restrict__ xsq,
    const float* __restrict__ ysq, int n, int m, int d, float gamma, double* partials,
    unsigned int* ticket, double* out) {
  __shared__ float Xs[kTK][kTM + 4];
  __shared__ float Ys[kTK][kTN + 4];
  __shared__ double red[kThreads];
  __shared__ bool is_last;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kTM, col0 = blockIdx.x * kTN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kTK) {
    for (int e = tid; e < kTM * kTK; e += kThreads) {
      const int r = e / kTK, c = e % kTK;
      const int gr = row0 + r, gc = k0 + c;
      Xs[c][r] = (gr < n && gc < d) ? X[(size_t)gr * d + gc] : 0.0f;
    }
    for (int e = tid; e < kTN * kTK; e += kThreads) {
      const int r = e / kTK, c = e % kTK;
      const int gr = col0 + r, gc = k0 + c;
      Ys[c][r] = (gr < m && gc < d) ? Y[(size_t)gr * d + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  double local = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gr < n && gc < m) {
        const float sq = fmaxf(xsq[gr] + ysq[gc] - 2.0f * acc[i][j], 0.0f);
        local += (double)expf(-gamma * sq);
      }
    }
  }
  red[tid] = local;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }

  const unsigned int nblocks = gridDim.x * gridDim.y;
  if (tid == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
    __threadfence();
    is_last = (atomicAdd(ticket, 1u) == nblocks - 1);
  }
  __syncthreads();
  if (!is_last) return;

  // Last block: fixed-order sum of every block's partial.
  __threadfence();
  const volatile double* vp = partials;
  double s = 0.0;
  for (unsigned int b = tid; b < nblocks; b += kThreads) s += vp[b];
  red[tid] = s;
  __syncthreads();
  for (int st = kThreads / 2; st > 0; st >>= 1) {
    if (tid < st) red[tid] += red[tid + st];
    __syncthreads();
  }
  if (tid == 0) *out = red[0];
}

}  // namespace

OSDM_EXPORT int osdm_rbf_kernel_sum(const void* X, const void* Y, const void* xsq, const void* ysq,
                                    int n, int m, int d, float gamma, void* partials,
                                    void* ticket, void* out, void* stream) {
  const dim3 grid(osdm::cdiv(m, kTN), osdm::cdiv(n, kTM));
  rbf_kernel_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(Y), static_cast<const float*>(xsq),
      static_cast<const float*>(ysq), n, m, d, gamma, static_cast<double*>(partials),
      static_cast<unsigned int*>(ticket), static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

OSDM_EXPORT int osdm_rbf_grid_blocks(int n, int m) {
  return osdm::cdiv(m, kTN) * osdm::cdiv(n, kTM);
}
