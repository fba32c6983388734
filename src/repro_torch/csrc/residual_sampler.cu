// Residual-replica sampling for Algorithm 1's π_kill path (paper eq. (7)).
//
// Replaces the TPU kernel src/repro/kernels/residual_sampler.py::
// residual_sample (Pallas body `_kernel`).  For each row m of u (M, S, K):
// idx = clip(ceil(u·n) - 1, 0, n - 1), y_j = min_k xs[idx], then
// max_y[m] = max_j y_j and sum_y[m] = Σ_j y_j.
//
// Design.  A persistent grid of four blocks per SM streams u through shared
// memory and never synchronises the block per row.
//   - The sorted trace xs (n floats, 4 KB for the 1026-task Job 1) is staged
//     in dynamic shared memory once per block, while the first chunks
//     load, so the gather never touches device memory.
//   - Rows are contiguous, so R rows (R a multiple of 4, making R·S·K·4 a
//     multiple of 16 bytes) form one chunk.  A producer warp brings chunk
//     b, b + grid, ... of its block into a ring of up to 4 stages with
//     cp.async.bulk (the 1-D bulk copy of the tensor memory accelerator),
//     each stage guarded by a "full" mbarrier (the copy's bytes) and an
//     "empty" one (one arrival per consumer warp).
//   - Each of the 8 consumer warps takes whole rows of a chunk: lane l
//     takes residuals j = l, l + 32, ..., reads its K uniforms from shared
//     memory, gathers and takes the min, then the warp reduces max and sum
//     with xor shuffles only.
//   - Rows outside the full chunks (the ragged end, or every row where u is
//     not 16-byte aligned or no stage fits beside xs) are read with plain
//     loads from device memory by the consumer warps, inside this kernel.
//
// Exactness.  No fast math: u·n is a round-to-nearest product (written as
// __fmul_rn), so every index and every gathered value equals the plain
// version's and the max is exact.  The sum runs in another order than
// torch.sum: each lane adds its residuals in increasing j, then the lanes
// are added by an xor butterfly (offsets 16, 8, 4, 2, 1); it agrees to
// float32 rounding (rtol 1e-5).
//
// What bounds it on an H100.  Bytes: reading u once, M·S·K·4 (40 MB at
// M=32768, S=103, K=3), about 12 µs at 3.35 TB/s; xs and the two outputs
// add 0.3 MB.  The gather and the min are a few operations per byte, far
// below the FP32 rate, so the kernel is memory bound by design, and the
// ring keeps several chunks per SM in flight.  On the card a plain one-pass
// read of the same u takes about twice the byte bound (PERF.md); the
// consumers' gathers and shuffles add a little to that, less with more
// blocks per SM to hide their latency.
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kConsumers = 8;                   // consumer warps per block
constexpr int kThreads = (kConsumers + 1) * 32;  // and one producer warp
constexpr int kMaxStages = 4;
constexpr int kChunkTarget = 12 * 1024;         // bytes a chunk aims for
constexpr int kSmemLimit = 232448;              // per block on Hopper (227 KB)
constexpr int kBlocksPerSM = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One row (S residuals × K replicas at `row`) reduced by one warp; lane 0
// writes max_y[m] and sum_y[m].
__device__ __forceinline__ void reduce_row(const float* row, int S, int K, const float* s_xs,
                                           int n, float fn, int lane, float* max_y,
                                           float* sum_y, int m) {
  float mx = -INFINITY;
  float sm = 0.0f;
  for (int j = lane; j < S; j += 32) {
    float y = INFINITY;
    for (int k = 0; k < K; ++k) {
      int idx = static_cast<int>(ceilf(__fmul_rn(row[j * K + k], fn))) - 1;
      idx = min(max(idx, 0), n - 1);
      y = fminf(y, s_xs[idx]);
    }
    mx = fmaxf(mx, y);
    sm = __fadd_rn(sm, y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    sm = __fadd_rn(sm, __shfl_xor_sync(0xffffffffu, sm, off));
  }
  if (lane == 0) {
    max_y[m] = mx;
    sum_y[m] = sm;
  }
}

__global__ void __launch_bounds__(kThreads)
residual_sample_kernel(const float* __restrict__ u, const float* __restrict__ xs, int M, int S,
                       int K, int n, int R, int stages, int n_chunks, float* __restrict__ max_y,
                       float* __restrict__ sum_y) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full_bar[kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kMaxStages];

  float* s_xs = reinterpret_cast<float*>(smem);
  float* s_rows = reinterpret_cast<float*>(smem + ((static_cast<size_t>(n) * 4 + 127) / 128) * 128);
  const int row_elems = S * K;
  const int chunk_elems = R * row_elems;

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full_bar[st], 1);
      mbar_init(&empty_bar[st], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == kConsumers) {  // the producer, which starts before xs is in
    if (lane == 0) {
      int t = 0;
      for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x, ++t) {
        const int st = t % stages;
        mbar_wait(&empty_bar[st], ((t / stages) & 1) ^ 1);  // passes at once in round 0
        mbar_arrive_expect_tx(&full_bar[st], static_cast<uint32_t>(chunk_elems) * 4);
        bulk_copy(s_rows + static_cast<size_t>(st) * chunk_elems,
                  u + static_cast<size_t>(ch) * chunk_elems, static_cast<uint32_t>(chunk_elems) * 4,
                  &full_bar[st]);
      }
    }
    return;
  }

  // the consumers stage xs while the first chunks load, then wait for each
  // other once (named barrier 1: the consumer warps only)
  for (int i = threadIdx.x; i < n; i += kConsumers * 32) s_xs[i] = xs[i];
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 32) : "memory");

  const float fn = static_cast<float>(n);
  int t = 0;
  for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x, ++t) {
    const int st = t % stages;
    mbar_wait(&full_bar[st], (t / stages) & 1);
    const float* chunk = s_rows + static_cast<size_t>(st) * chunk_elems;
    for (int r = warp; r < R; r += kConsumers) {
      reduce_row(chunk + r * row_elems, S, K, s_xs, n, fn, lane, max_y, sum_y, ch * R + r);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[st]);
  }
  // rows outside the full chunks, straight from device memory
  for (int m = n_chunks * R + blockIdx.x * kConsumers + warp; m < M; m += gridDim.x * kConsumers) {
    reduce_row(u + static_cast<size_t>(m) * row_elems, S, K, s_xs, n, fn, lane, max_y, sum_y, m);
  }
}

}  // namespace

// Plain C entry for ctypes.  `sms` is the card's SM count; the launch puts
// kBlocksPerSM blocks on each (fewer when the work is smaller) and picks the
// chunk size and the number of stages from the row size and n.  Returns the
// CUDA error code of the launch.
extern "C" int residual_sample_launch(const float* u, const float* xs, int M, int S, int K,
                                      int n, float* max_y, float* sum_y, int sms, void* stream,
                                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_bytes = static_cast<long long>(S) * K * 4;
  const long long xs_bytes = (static_cast<long long>(n) * 4 + 127) / 128 * 128;
  // R: a multiple of 4 rows, about kChunkTarget bytes
  const long long R = 4 * std::max(1LL, kChunkTarget / (4 * row_bytes));
  const long long chunk_bytes = R * row_bytes;
  const long long room = kSmemLimit - 64 - xs_bytes;  // 64: the static barriers
  int stages = static_cast<int>(std::min<long long>(kMaxStages, room > 0 ? room / chunk_bytes : 0));
  const bool aligned = reinterpret_cast<uintptr_t>(u) % 16 == 0;
  if (!aligned) stages = 0;
  const int n_chunks = stages > 0 ? static_cast<int>(M / R) : 0;
  const long long tail_rows = M - n_chunks * R;
  const long long work = std::max<long long>(n_chunks, (tail_rows + kConsumers - 1) / kConsumers);
  const long long slots = static_cast<long long>(sms) * kBlocksPerSM;
  const int grid = static_cast<int>(std::max(1LL, std::min(work, slots)));
  const size_t smem = static_cast<size_t>(xs_bytes + static_cast<long long>(stages) * chunk_bytes);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(residual_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  residual_sample_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, xs, M, S, K, n, static_cast<int>(R), stages, n_chunks, max_y, sum_y);
  return static_cast<int>(cudaGetLastError());
}
