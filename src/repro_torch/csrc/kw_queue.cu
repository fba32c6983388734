// Kiefer–Wolfowitz FIFO G/G/c queues: one thread per queue.
//
// Replaces the TPU kernel src/repro/kernels/kw_queue.py::kw_queue (Pallas
// body `_kernel`).  Job j of a queue takes the lowest-index slot already
// idle at its arrival, else the lowest-index slot among those that free
// earliest; start = max(a, free), svc = s / speed[slot], finish = start + svc.
//
// Design.  The recursion is sequential over jobs, so the parallelism is
// across queues: one thread carries one queue, with the c slot free times
// in a register array whose size MAXC is fixed at compile time (the launch
// picks the smallest instantiation >= c; c <= 32).  Slot selection is an
// unrolled, predicated scan of that array, so nothing spills to local
// memory.  A block is one warp = 32 queues.  Loads and stores stay
// coalesced in the (B, J) row-major layout by staging 32-queue × 32-job
// tiles through shared memory: a lane reads column j0+lane of each of the
// warp's 32 rows (128 contiguous bytes per row), then reads its own row
// out of the tile.  Outputs are written back through tiles the same way.
//
// Exactness.  Built without fast math: max, IEEE round-to-nearest division
// and addition (written as __fdiv_rn / __fadd_rn, so no contraction) are
// the operations of the plain PyTorch version, which it equals bit for bit.
//
// What bounds it on an H100.  Bytes: B·J·24 (two float inputs, three float
// outputs and one int32 output), 25 MB at B=512, J=2048, i.e. 7.5 µs at
// 3.35 TB/s.  The kernel is far from that: it is bound by the chain of J
// dependent steps of each thread, and B=512 queues fill only 16 warps on
// 132 SMs.  Closing that gap needs more parallelism than one thread per
// queue (for example a parallel-prefix formulation), which this simple
// kernel does not attempt.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kQueues = 32;  // queues per block: one warp
constexpr int kTile = 32;    // jobs per staged tile

template <int MAXC>
__global__ void __launch_bounds__(kQueues)
kw_queue_kernel(const float* __restrict__ arrivals,
                const float* __restrict__ services,
                const float* __restrict__ speeds, int B, int J, int c,
                float* __restrict__ starts, float* __restrict__ finishes,
                float* __restrict__ svcs, int* __restrict__ slots) {
  __shared__ float t_a[kQueues][kTile + 1];
  __shared__ float t_s[kQueues][kTile + 1];
  __shared__ float t_st[kQueues][kTile + 1];
  __shared__ float t_fi[kQueues][kTile + 1];
  __shared__ float t_sv[kQueues][kTile + 1];
  __shared__ int t_sl[kQueues][kTile + 1];

  const int lane = threadIdx.x;
  const int q0 = blockIdx.x * kQueues;
  const int rows = min(kQueues, B - q0);

  float free_t[MAXC];
  float speed[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    free_t[i] = 0.0f;
    speed[i] = i < c ? speeds[i] : 1.0f;
  }

  for (int j0 = 0; j0 < J; j0 += kTile) {
    const int cols = min(kTile, J - j0);
    if (lane < cols) {
      for (int r = 0; r < rows; ++r) {
        const size_t off = static_cast<size_t>(q0 + r) * J + j0 + lane;
        t_a[r][lane] = arrivals[off];
        t_s[r][lane] = services[off];
      }
    }
    __syncwarp();
    if (lane < rows) {
      for (int jj = 0; jj < cols; ++jj) {
        const float a = t_a[lane][jj];
        int first_idle = MAXC;
        int soonest = 0;
        float min_free = free_t[0];
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          if (i < c) {
            if (first_idle == MAXC && free_t[i] <= a) first_idle = i;
            if (free_t[i] < min_free) {
              min_free = free_t[i];
              soonest = i;
            }
          }
        }
        const int slot = first_idle < MAXC ? first_idle : soonest;
        float f_sel = 0.0f;
        float sp_sel = 1.0f;
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          if (i == slot) {
            f_sel = free_t[i];
            sp_sel = speed[i];
          }
        }
        const float start = fmaxf(a, f_sel);
        const float svc = __fdiv_rn(t_s[lane][jj], sp_sel);
        const float fin = __fadd_rn(start, svc);
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          if (i == slot) free_t[i] = fin;
        }
        t_st[lane][jj] = start;
        t_fi[lane][jj] = fin;
        t_sv[lane][jj] = svc;
        t_sl[lane][jj] = slot;
      }
    }
    __syncwarp();
    if (lane < cols) {
      for (int r = 0; r < rows; ++r) {
        const size_t off = static_cast<size_t>(q0 + r) * J + j0 + lane;
        starts[off] = t_st[r][lane];
        finishes[off] = t_fi[r][lane];
        svcs[off] = t_sv[r][lane];
        slots[off] = t_sl[r][lane];
      }
    }
    __syncwarp();
  }
}

template <int MAXC>
void launch(const float* a, const float* s, const float* sp, int B, int J, int c,
            float* st, float* fi, float* sv, int* sl, cudaStream_t stream) {
  const dim3 grid((B + kQueues - 1) / kQueues);
  kw_queue_kernel<MAXC><<<grid, kQueues, 0, stream>>>(a, s, sp, B, J, c, st, fi, sv, sl);
}

}  // namespace

// Plain C entry for ctypes.  Returns the CUDA error code of the launch
// (0 on success); c above 32 returns cudaErrorInvalidValue.
extern "C" int kw_queue_launch(const float* arrivals, const float* services,
                               const float* speeds, int B, int J, int c,
                               float* starts, float* finishes, float* svcs,
                               int* slots, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c <= 1) {
    launch<1>(arrivals, services, speeds, B, J, c, starts, finishes, svcs, slots, st);
  } else if (c <= 2) {
    launch<2>(arrivals, services, speeds, B, J, c, starts, finishes, svcs, slots, st);
  } else if (c <= 4) {
    launch<4>(arrivals, services, speeds, B, J, c, starts, finishes, svcs, slots, st);
  } else if (c <= 8) {
    launch<8>(arrivals, services, speeds, B, J, c, starts, finishes, svcs, slots, st);
  } else if (c <= 16) {
    launch<16>(arrivals, services, speeds, B, J, c, starts, finishes, svcs, slots, st);
  } else if (c <= 32) {
    launch<32>(arrivals, services, speeds, B, J, c, starts, finishes, svcs, slots, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
