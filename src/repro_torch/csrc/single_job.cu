// The single-job evaluator: every law of a chunk on one (trial, job) row of
// shared draws, one block a row.
//
// Replaces no TPU kernel.  The JAX package evaluates these laws with
// XLA-fused vmaps (`repro.fleet.vector`, `repro.core.simulate`); the port
// ran them as chains of PyTorch operations over (laws, trials, jobs, n)
// blocks (`fleet/vector.py::_masked_cells`, `core/simulate.py::
// lowered_eval_cells`): argsorts of int64 indices, gathers, scatters and
// some thirty elementwise passes a law.  This kernel computes the same
// (T, C) of every law, reading each row's draws once.
//
// Inputs: x (Lx, R, n) task times, Lx = 1 (shared by the laws: x_law = 0)
// or L (one a law: x_law = R·n); cm (Lc, R, S, n, r_cap), the fresh block
// running-min'd over its replica axis and aligned by completion rank, Lc =
// 1 or L likewise; each law's lowered stages mode, k, t, r, keep (L, S) and
// its group width d (L,).  `ranked` says x is in ascending order along n
// (the single-fork program's sorted draws).  Outputs T and C (L, R).
//
// What a block does for its row.
//   1. Stage 0's order: the row's times are staged in shared memory and
//      sorted once for all the laws when x is shared (a stable block radix
//      sort of (key, task) pairs: CUB's BlockRadixSort, ties in task order,
//      as torch.argsort(stable=True) breaks them); with `ranked` input the
//      order is the identity and nothing is sorted; per-law x is staged and
//      sorted once a law.
//   2. Each law in turn.  A single quantile stage at full width (S = 1,
//      d = n) is the single-fork leg, which one warp evaluates (law l on
//      warp l mod 8, without a block barrier, so the warps take a chunk's
//      leg laws side by side): t1 = the k-th time, y = min(x - t1,
//      fresh_{r-1}) under keep or fresh_r under kill for ranks >= k, T = t1
//      + max y, C = (Σ_{<k} x + (n - k)·t1 + (r + 1)·Σ y) / n, with Σ_{<k} x
//      from the row's prefix sums (taken once, in double), so that a law's
//      pass runs over its stragglers only.  Otherwise the lowered algebra:
//      per active stage, the current finishes' group-blocked stable order
//      (stage 0's from step 1, later stages sorted again; with d < n the
//      order is sorted once more, stably, by group: task i is in group
//      i / d, so group g holds positions g·d .. g·d + d - 1), each group's
//      fork instant τ_g (the finish at position g·d + k - 1, clamped at 0,
//      or t), the stragglers (ranks within the group >= k, or finishes >
//      t), their new finishes τ_g + y with y from the fresh column of their
//      position, and the cohorts: each task keeps a bit mask of its live
//      cohorts, whose starts (0, then each stage's τ_g of the task's group)
//      and copies (1, then r under keep, r + 1 under kill) are the law's; a
//      kill settles a straggler's live cohorts at τ_g.  The last finishes
//      give T (their max) and the rest of the cost.  A stage of mode -1, or
//      a quantile stage with k >= d, has no stragglers and changes nothing:
//      it is skipped, with its sort.
//
// Exactness.  No fast math.  T is made of subtractions, adds, mins and
// maxes of the same float32 values as the chains', in the same order for
// each element, so it equals theirs bit for bit.  C's sums run in another
// order: each thread adds its elements in double, the block adds the
// threads' sums in double, and the one float32 rounding of the total
// leaves C within float32 rounding of the chains' float32 sums.  A law
// whose parameters the kernel does not take (a mode outside -1, 0, 1, d
// not a divisor of n, k outside [0, d], r < 0, a fresh column >= r_cap)
// gets NaN for T and C.
//
// What bounds it on an H100.  Bytes: x read once, and of cm the 32-byte
// sectors that hold a column some law reads at one of its stragglers'
// positions (chip_smoke.py's `single_job_bytes` counts them from the draws;
// PERF.md gives them at the benchmark's grids).  The work beside it is
// order statistics within each row, and those stay in shared memory: the
// radix sort takes 8 passes of 4 bits over n pairs, once a row and once
// more for each law's later stage (3 more passes by group where d < n), and
// a law's pass over its row is a few operations an element.  The fresh
// columns are read from device memory where a law needs them (rank by
// rank, coalesced), and a block's laws read the same row's columns in
// turn, so they come from L1 and L2 after the first; that keeps shared
// memory at 14 + 4·S bytes a task (the groups' fork instants take 4 a task
// and stage) and lets 4096 tasks at 8 stages fit.  With a few tasks a
// thread, what a law costs beyond its pass is the reduction of its sums
// over the block, and at two stages the sorts; PERF.md gives the times
// beside the bound.
#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 8;  // cohort masks are 16 bits: S + 1 <= 16
constexpr int kMaxTasks = 4096;
constexpr int kQuantile = 0;
constexpr int kTime = 1;
constexpr int kInactive = -1;

// Group ids are sorted on their low kGroupBits bits (a task's group i / d
// is below kMaxTasks).
constexpr int kGroupBits = 12;
static_assert(kMaxTasks <= (1 << kGroupBits), "group ids must fit kGroupBits");

// One warp's partial (max, sum) of a law.
struct Partial {
  float mx;
  double sum;
};

// An order-preserving unsigned key of a float: -0 and +0 tie, as torch's
// stable sort compares them.
__device__ __forceinline__ unsigned sort_key(float f) {
  unsigned u = f == 0.0f ? 0u : __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The max of mx and the sum over the warp, in lane 0.
__device__ __forceinline__ void warp_reduce(float& mx, double& sum) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  }
}

template <int IPT>
using Sort = cub::BlockRadixSort<unsigned, kThreads, IPT, uint16_t>;

// Sorts the (key, task) pairs held in rank order (blocked: thread t holds
// ranks t·IPT .. t·IPT + IPT - 1) stably by group, task / d, and writes the
// tasks to order: the group-blocked order, each group's tasks in rank order.
// Ranks >= n (padding) stay last.
template <int IPT>
__device__ __forceinline__ void group_blocked(unsigned (&keys)[IPT], uint16_t (&task)[IPT], int n, int d,
                                              uint16_t* order, typename Sort<IPT>::TempStorage& tmp) {
  if (d < n) {
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const int j = threadIdx.x * IPT + q;
      keys[q] = j < n ? task[q] / d : 0xffffffffu;
    }
    __syncthreads();  // the last sort is done with tmp
    Sort<IPT>(tmp).Sort(keys, task, 0, kGroupBits);
  }
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    const int j = threadIdx.x * IPT + q;
    if (j < n) order[j] = task[q];
  }
  __syncthreads();
}

// The stable ascending order of vals[0, n), group-blocked for width d:
// order[j] = the task at position j.  Thread t sorts tasks t·IPT .. t·IPT +
// IPT - 1 (the blocked arrangement, in task order), so equal keys keep task
// order.
template <int IPT>
__device__ __forceinline__ void rank_order(const float* vals, int n, int d, uint16_t* order,
                                           typename Sort<IPT>::TempStorage& tmp) {
  unsigned keys[IPT];
  uint16_t task[IPT];
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    const int i = threadIdx.x * IPT + q;
    keys[q] = i < n ? sort_key(vals[i]) : 0xffffffffu;
    task[q] = static_cast<uint16_t>(i);
  }
  Sort<IPT>(tmp).Sort(keys, task);
  group_blocked<IPT>(keys, task, n, d, order, tmp);
}

// The group-blocked order for width d < n of the tasks in rank order src.
template <int IPT>
__device__ __forceinline__ void group_order(const uint16_t* src, int n, int d, uint16_t* order,
                                            typename Sort<IPT>::TempStorage& tmp) {
  unsigned keys[IPT];
  uint16_t task[IPT];
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    const int j = threadIdx.x * IPT + q;
    task[q] = j < n ? src[j] : static_cast<uint16_t>(j);
  }
  group_blocked<IPT>(keys, task, n, d, order, tmp);
}

// Stage 0's values by rank (xs) and, unless `ranked`, its order (p0), from
// the row `src`; `scratch` (n floats) is free for the staging.
template <int IPT>
__device__ __forceinline__ void stage_zero(const float* __restrict__ src, int n, bool ranked,
                                           float* xs, uint16_t* p0, float* scratch,
                                           typename Sort<IPT>::TempStorage& tmp) {
  if (ranked) {
    for (int i = threadIdx.x; i < n; i += kThreads) xs[i] = src[i];
    __syncthreads();
    return;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) scratch[i] = src[i];
  __syncthreads();
  rank_order<IPT>(scratch, n, n, p0, tmp);
  for (int j = threadIdx.x; j < n; j += kThreads) xs[j] = scratch[p0[j]];
  __syncthreads();
}

// pre[j] = Σ_{i<j} xs[i] in double, for j = 0..n (thread t adds tasks
// t·IPT .. t·IPT + IPT - 1, then the threads' totals are scanned).
template <int IPT>
__device__ __forceinline__ void prefix_sums(const float* xs, int n, double* pre, double* warp_total) {
  const int base = threadIdx.x * IPT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double before[IPT];
  double run = 0.0;
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    before[q] = run;
    if (base + q < n) run += xs[base + q];
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  double excl = incl - run;
  for (int w = 0; w < warp; ++w) excl += warp_total[w];
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    if (base + q < n) pre[base + q] = excl + before[q];
  }
  if (base <= n && (n < base + IPT || threadIdx.x == kThreads - 1)) pre[n] = excl + run;
  __syncthreads();
}

// Five blocks an SM (48 registers a thread) where a thread sorts up to 8
// keys: the sorts and barriers wait on latency, which more blocks hide (four
// blocks and six were slower at one grid or the other on the card).
template <int IPT>
__global__ void __launch_bounds__(kThreads, IPT <= 8 ? 5 : 1)
single_job_kernel(const float* __restrict__ x, long long x_law, const float* __restrict__ cm,
                  long long cm_law, const int* __restrict__ modes, const int* __restrict__ ks,
                  const float* __restrict__ ts, const int* __restrict__ rs,
                  const unsigned char* __restrict__ keeps, const int* __restrict__ ds, int L, int R, int S,
                  int n, int r_cap, int ranked, float* __restrict__ T, float* __restrict__ C) {
  __shared__ typename Sort<IPT>::TempStorage sort_tmp;
  __shared__ float copies[kMaxStages + 1];  // a law's cohorts' copies a task
  __shared__ Partial part[kWarps];
  __shared__ double warp_total[kWarps];
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_pad = (n + 7) & ~7;
  float* xs = reinterpret_cast<float*>(smem);  // stage 0's values by rank
  float* fin = xs + n_pad;  // a law's finishes by task
  float* gtau = fin + n_pad;  // (S, n_pad): each stage's fork instant by group
  uint16_t* alive = reinterpret_cast<uint16_t*>(gtau + static_cast<size_t>(S) * n_pad);  // live cohorts by task
  uint16_t* p0 = alive + n_pad;  // stage 0's order: the task of each rank
  uint16_t* order = p0 + n_pad;  // a stage's group-blocked order
  double* pre = reinterpret_cast<double*>(order + n_pad);  // one stage: stage 0's prefix sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x;
  const size_t x_row = static_cast<size_t>(row) * n;
  const size_t cm_stage = static_cast<size_t>(n) * r_cap;
  const size_t cm_row = static_cast<size_t>(row) * S * cm_stage;
  const bool shared_x = x_law == 0;
  if (tid == 0) copies[0] = 1.0f;
  if (shared_x) {
    stage_zero<IPT>(x + x_row, n, ranked, xs, p0, fin, sort_tmp);
    if (S == 1) prefix_sums<IPT>(xs, n, pre, warp_total);
  }

  // A leg law is one warp's (warp l mod 8), with no block barrier, so the
  // warps take the chunk's leg laws side by side; a lowered law takes the
  // whole block.
  for (int l = 0; l < L; ++l) {
    if (!shared_x) {
      __syncthreads();  // the last law is done with xs, pre and fin
      stage_zero<IPT>(x + l * x_law + x_row, n, ranked, xs, p0, fin, sort_tmp);
      if (S == 1) prefix_sums<IPT>(xs, n, pre, warp_total);
    }
    const int* mode_l = modes + l * S;
    const int* k_l = ks + l * S;
    const int* r_l = rs + l * S;
    const unsigned char* keep_l = keeps + l * S;
    const int d = ds[l];
    const bool leg = S == 1 && mode_l[0] == kQuantile && d == n;
    if (leg && warp != l % kWarps) continue;
    bool bad = d < 1 || d > n || n % d != 0;
    for (int s = 0; s < S; ++s) {
      const int m = mode_l[s], k = k_l[s], r = r_l[s];
      bad |= (m != kInactive && m != kQuantile && m != kTime) || (m == kQuantile && (k < 0 || k > d)) ||
             (m != kInactive && (r < 0 || (keep_l[s] ? r - 1 : r) >= r_cap));
    }
    const size_t out = static_cast<size_t>(l) * R + row;
    if (bad) {
      if ((leg ? lane : tid) == 0) T[out] = C[out] = NAN;
      continue;
    }
    const float* cm_l = cm + (cm_law ? l * cm_law : 0) + cm_row;

    if (leg) {  // the single-fork leg, on this warp: lane i takes ranks k + i, k + i + 32, ...
      const int k = k_l[0], r = r_l[0];
      const bool keep = keep_l[0] != 0;
      const float t1 = xs[max(k - 1, 0)];
      float my = k > 0 ? 0.0f : -INFINITY;  // the non-stragglers' y are 0
      double sy = 0.0;
      for (int j = k + lane; j < n; j += 32) {
        const float* col = cm_l + static_cast<size_t>(j) * r_cap;
        float y;
        if (keep) {
          y = __fsub_rn(xs[j], t1);
          if (r > 0) y = fminf(y, col[r - 1]);
        } else {
          y = col[r];
        }
        my = fmaxf(my, y);
        sy += y;
      }
      warp_reduce(my, sy);
      if (lane == 0) {
        // C = (Σ_{<k} x + (n - k)·t1 + (r + 1)·Σ y) / n, Σ_{<k} x a prefix sum
        const float c1 = __fadd_rn(static_cast<float>(pre[k]), __fmul_rn(static_cast<float>(n - k), t1));
        T[out] = __fadd_rn(t1, my);
        C[out] = __fdiv_rn(__fadd_rn(c1, __fmul_rn(static_cast<float>(r) + 1.0f, static_cast<float>(sy))),
                           static_cast<float>(n));
      }
      continue;
    }

    // the lowered algebra: every task in its first cohort, at its own time
    if (ranked) {
      for (int i = tid; i < n; i += kThreads) fin[i] = xs[i];
    } else {
      for (int j = tid; j < n; j += kThreads) fin[p0[j]] = xs[j];
    }
    for (int i = tid; i < n; i += kThreads) alive[i] = 1;
    __syncthreads();
    const int G = n / d;
    double cost = 0.0;
    bool first = true;  // no stage has moved a finish yet: stage 0's order holds
    for (int s = 0; s < S; ++s) {
      const int m = mode_l[s], k = k_l[s], r = r_l[s];
      const bool keep = keep_l[s] != 0;
      const bool quantile = m == kQuantile;
      if (m == kInactive || (quantile && k >= d)) continue;  // no stragglers
      // sorted input is in group-blocked order already (a group's tasks are
      // consecutive); otherwise stage 0's order is grouped, a later stage's
      // sorted and grouped
      const bool ident = first && ranked;
      const uint16_t* ord = p0;
      if (!first) {
        rank_order<IPT>(fin, n, d, order, sort_tmp);
        ord = order;
      } else if (!ranked && d < n) {
        group_order<IPT>(p0, n, d, order, sort_tmp);
        ord = order;
      }
      first = false;
      float* tau_s = gtau + static_cast<size_t>(s) * n_pad;
      const float t = ts[l * S + s];
      for (int g = tid; g < G; g += kThreads) {
        const int j = max(g * d + k - 1, 0);  // the group's k-th finish, as the chain clamps it
        tau_s[g] = quantile ? fin[ident ? j : ord[j]] : t;
      }
      __syncthreads();  // every group's τ is in before a finish moves
      const float* cm_s = cm_l + s * cm_stage;
      for (int j = tid; j < n; j += kThreads) {
        const int i = ident ? j : ord[j];
        const int g = j / d;
        const float tau = tau_s[g];
        const float f = fin[i];
        if (quantile ? j - g * d < k : !(f > tau)) continue;
        const float* col = cm_s + static_cast<size_t>(j) * r_cap;
        float y;
        if (keep) {
          y = __fsub_rn(f, tau);
          if (r > 0) y = fminf(y, col[r - 1]);
        } else {
          y = col[r];
        }
        unsigned live = alive[i];
        if (!keep) {  // the straggler's running copies stop at τ
          for (int c = 0; c <= s; ++c) {
            if (live >> c & 1u) {
              const float start = c ? gtau[static_cast<size_t>(c - 1) * n_pad + g] : 0.0f;
              cost += __fmul_rn(copies[c], fmaxf(__fsub_rn(tau, start), 0.0f));
            }
          }
          live = 0;
        }
        alive[i] = static_cast<uint16_t>(live | (1u << (s + 1)));
        fin[i] = __fadd_rn(tau, y);
      }
      if (tid == 0) copies[s + 1] = keep ? static_cast<float>(r) : static_cast<float>(r) + 1.0f;
      __syncthreads();
    }
    float mt = -INFINITY;
    for (int i = tid; i < n; i += kThreads) {
      const float f = fin[i];
      mt = fmaxf(mt, f);
      const unsigned live = alive[i];
      const int g = i / d;
      for (int c = 0; c <= S; ++c) {
        if (live >> c & 1u) {
          const float start = c ? gtau[static_cast<size_t>(c - 1) * n_pad + g] : 0.0f;
          cost += __fmul_rn(copies[c], fmaxf(__fsub_rn(f, start), 0.0f));
        }
      }
    }
    warp_reduce(mt, cost);
    if (lane == 0) part[warp] = Partial{mt, cost};
    __syncthreads();  // the partials are in; every thread is done with fin, alive and the cohorts
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) {
        mt = fmaxf(mt, part[w].mx);
        cost += part[w].sum;
      }
      T[out] = mt;
      C[out] = __fdiv_rn(static_cast<float>(cost), static_cast<float>(n));
    }
  }
}

template <int IPT>
int launch(const float* x, long long x_law, const float* cm, long long cm_law, const int* modes,
           const int* ks, const float* ts, const int* rs, const unsigned char* keeps, const int* ds, int L,
           int R, int S, int n, int r_cap, int ranked, float* T, float* C, cudaStream_t stream) {
  // 14 + 4·S bytes a task, and with one stage n + 1 prefix sums in double
  const size_t n_pad = static_cast<size_t>((n + 7) & ~7);
  const size_t smem = n_pad * (14 + 4 * static_cast<size_t>(S)) + (S == 1 ? (n_pad + 8) * 8 : 0);
  auto kernel = single_job_kernel<IPT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<R, kThreads, smem, stream>>>(x, x_law, cm, cm_law, modes, ks, ts, rs, keeps, ds, L, R, S, n,
                                        r_cap, ranked, T, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes: one launch of R blocks for the L laws.  The
// block sorts n pairs as 256 threads × IPT, IPT the least of 2, 5, 8, 16
// that holds n (512, 1280, 2048, 4096 tasks).  Returns the CUDA error code of
// the launch (cudaErrorInvalidValue for sizes it does not take).
extern "C" int single_job_launch(const float* x, long long x_law, const float* cm, long long cm_law,
                                 const int* modes, const int* ks, const float* ts, const int* rs,
                                 const unsigned char* keeps, const int* ds, int L, int R, int S, int n,
                                 int r_cap, int ranked, float* T, float* C, void* stream, int device) {
  if (L < 1 || R < 1 || S < 1 || S > kMaxStages || n < 1 || n > kMaxTasks || r_cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= kThreads * 2) {
    return launch<2>(x, x_law, cm, cm_law, modes, ks, ts, rs, keeps, ds, L, R, S, n, r_cap, ranked, T, C, s);
  }
  if (n <= kThreads * 5) {
    return launch<5>(x, x_law, cm, cm_law, modes, ks, ts, rs, keeps, ds, L, R, S, n, r_cap, ranked, T, C, s);
  }
  if (n <= kThreads * 8) {
    return launch<8>(x, x_law, cm, cm_law, modes, ks, ts, rs, keeps, ds, L, R, S, n, r_cap, ranked, T, C, s);
  }
  return launch<16>(x, x_law, cm, cm_law, modes, ks, ts, rs, keeps, ds, L, R, S, n, r_cap, ranked, T, C, s);
}
