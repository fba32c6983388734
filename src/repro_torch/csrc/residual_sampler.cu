// Residual-replica sampling for Algorithm 1's π_kill path (paper eq. (7)).
//
// Replaces the TPU kernel src/repro/kernels/residual_sampler.py::
// residual_sample (Pallas body `_kernel`).  For each row m of u (M, S, K):
// idx = clip(ceil(u·n) - 1, 0, n - 1), y_j = min_k xs[idx], then
// max_y[m] = max_j y_j and sum_y[m] = Σ_j y_j.
//
// Design.  The sorted trace xs (n floats, 4 KB for the 1026-task Job 1)
// sits in dynamic shared memory, so the gather never touches device
// memory.  A block of 128 threads walks rows m = blockIdx.x, +gridDim.x, …:
// the launch caps the grid at a few blocks per SM, so xs is staged once per
// block and not once per row.  Threads stride over the S residuals of a
// row, each taking the min over its K replicas, then a warp-shuffle and
// shared-memory reduction gives the row's max and sum.
//
// Exactness.  No fast math: u·n is a round-to-nearest product (written as
// __fmul_rn), so every index and every gathered value equals the plain
// version's and the max is exact.  The sum runs in another order than
// torch.sum, so it agrees to float32 rounding (rtol 1e-5).
//
// What bounds it on an H100.  Bytes: reading u once, M·S·K·4 (40 MB at
// M=32768, S=103, K=3), about 12 µs at 3.35 TB/s; xs and the two outputs
// add 0.3 MB.  The gather and the min are a few operations per byte, far
// below the FP32 rate, so the kernel is memory bound by design.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
residual_sample_kernel(const float* __restrict__ u, const float* __restrict__ xs,
                       int M, int S, int K, int n, float* __restrict__ max_y,
                       float* __restrict__ sum_y) {
  extern __shared__ float s_xs[];
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps];

  for (int i = threadIdx.x; i < n; i += kThreads) s_xs[i] = xs[i];
  __syncthreads();

  const float fn = static_cast<float>(n);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const float* row = u + static_cast<size_t>(m) * S * K;
    float mx = -INFINITY;
    float sm = 0.0f;
    for (int j = threadIdx.x; j < S; j += kThreads) {
      float y = INFINITY;
      for (int k = 0; k < K; ++k) {
        int idx = static_cast<int>(ceilf(__fmul_rn(row[j * K + k], fn))) - 1;
        idx = min(max(idx, 0), n - 1);
        y = fminf(y, s_xs[idx]);
      }
      mx = fmaxf(mx, y);
      sm += y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
      sm += __shfl_down_sync(0xffffffffu, sm, off);
    }
    if (lane == 0) {
      red_max[warp] = mx;
      red_sum[warp] = sm;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float bm = red_max[0];
      float bs = red_sum[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        bm = fmaxf(bm, red_max[w]);
        bs += red_sum[w];
      }
      max_y[m] = bm;
      sum_y[m] = bs;
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry for ctypes.  `grid` is the number of blocks (the wrapper
// sizes it from the SM count).  Returns the CUDA error code of the launch.
extern "C" int residual_sample_launch(const float* u, const float* xs, int M, int S,
                                      int K, int n, float* max_y, float* sum_y,
                                      int grid, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(residual_sample_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  residual_sample_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, xs, M, S, K, n, max_y, sum_y);
  return static_cast<int>(cudaGetLastError());
}
