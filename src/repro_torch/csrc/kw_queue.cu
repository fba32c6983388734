// Kiefer–Wolfowitz FIFO G/G/c queues: segment-parallel with an exact fix-up.
//
// Replaces the TPU kernel src/repro/kernels/kw_queue.py::kw_queue (Pallas
// body `_kernel`).  Job j of a queue takes the lowest-index slot already
// idle at its arrival, else the lowest-index slot among those that free
// earliest; start = max(a, free), svc = s / speed[slot], finish = start + svc.
//
// Design.  The recursion is sequential over the jobs of a queue, but its
// state forgets.  Call two states X, Y equivalent at a when every slot is
// idle in both (free <= a) or holds the same bits in both.  If the
// arrivals from a job on never decrease, two runs whose states are
// equivalent at that job's arrival give bit-identical outputs from it on:
// a slot idle at a stays idle for every later job and starts it at its
// arrival, and the "earliest-freeing" branch is taken only when every slot
// is busy, where the two states agree bit for bit.  Without that order only
// bitwise-equal states are known to agree.
//
//   Kernel 1 (kw_segment_kernel), one thread per (queue, segment): the J
//   jobs are cut into K segments of L jobs (the last may be short).
//   a. Speculate: segment 0 runs from the true initial state (zeros), every
//      other one from all slots idle (-inf).  It writes all four outputs,
//      its end state E[k] (c floats) and whether its arrivals never decrease
//      (counting the step from the job before it).  A block is one warp;
//      32-job tiles of a and s come in by 4-byte cp.async into two stages
//      (the next tile loads while the current one runs), and outputs are
//      staged in shared memory and stored coalesced, each of the warp's 32
//      segments as one 128-byte row.
//   b. Fix up in parallel: the lanes of one queue hold consecutive
//      segments, so lane k takes E[k-1] from lane k-1 by shuffle and re-runs
//      its segment from it beside its speculative run, rewriting the jobs up
//      to where the two states first agree (equivalent where the row's
//      arrivals never decrease from this segment to its end, else bitwise).
//      If the speculation of k-1 was right, this is segment k's true run.
//      It records where they agreed and the speculative state there, or,
//      where they never did, its end state W[k].
//   Kernel 2 (kw_fixup_kernel), one thread per queue, walks the segments in
//   order.  Segment k's fix-up stands if the true end state of k-1 is
//   equivalent to E[k-1], i.e. if k-1 agreed (segment 0 is exact); then the
//   true end state of k is E[k] or, if it never agreed, W[k].  Otherwise k
//   is walked from the true state, the true run alone: up to where kernel
//   1's fix-up agreed, where the state is compared with the speculative one
//   recorded there, and on to the segment's end if they differ.  A segment
//   walked to its end is compared with E[k] at the next arrival, which says
//   whether the fix-up of k + 1 stands.  At low load nearly every segment
//   agrees within a few jobs and kernel 2 only reads; a saturated queue
//   never empties, nothing agrees, and kernel 2 walks every job after the
//   second segment.
//
// Kernel 1's fix-up and kernel 2's walk go four jobs at a time, with
// 16-byte loads and stores where rows and segments are aligned to four jobs
// (outputs past the point of agreement are rewritten with the values
// already there).  Per step, one pass over the slots picks the slot with
// selects only, then one division by the chosen slot's speed.  (Dividing
// by every slot's speed ahead of the choice, which takes the division off
// the chain, measured slower on the card, and so did branches in the slot
// choice, and a second round of fix-ups in kernel 1 from the predecessor's
// fixed-up end state: PERF.md.)  The agreement test is not on the chain:
// both runs are stepped whatever it says.
//
// Exactness.  Built without fast math: max, IEEE round-to-nearest division
// and addition (written as __fdiv_rn / __fadd_rn, so no contraction) are
// the operations of the plain PyTorch version, which it equals bit for bit,
// for sorted and unsorted rows alike: nothing a row keeps is speculative
// without the agreement test.  c <= 32, B·J < 2^31.
//
// What bounds it on an H100.  Bytes: B·J·24 (two float inputs, three float
// outputs and one int32 output), 25 MB at B=512, J=2048, i.e. 7.5 µs at
// 3.35 TB/s.  Kernel 1 is B·K threads, each a chain of L dependent steps
// plus the steps to agreement (about 15-40 at load 0.7-0.85, c = 4); kernel
// 2 is B threads, nearly idle at low load and J - 2L dependent steps when
// saturated.  Both are bound by the latency of those chains, not by bytes;
// PERF.md records the times.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 32;  // threads per block: one warp
constexpr int kTile = 32;   // jobs per staged tile

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One job of the recursion on `free_t` (arrival a, service s); returns the
// outputs.  One pass over the slots finds the first idle one and the
// earliest-freeing one with their free times and speeds, all as selects.
template <int MAXC>
__device__ __forceinline__ void kw_step(float (&free_t)[MAXC], const float (&speed)[MAXC], float a,
                                        float s, int c, float& start, float& fin, float& svc,
                                        int& slot) {
  int first_idle = MAXC;
  float f_idle = 0.0f;
  float sp_idle = 1.0f;
  int soonest = 0;
  float min_free = free_t[0];
  float sp_soon = speed[0];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const bool live = i < c;
    const bool idle = live & (first_idle == MAXC) & (free_t[i] <= a);
    first_idle = idle ? i : first_idle;
    f_idle = idle ? free_t[i] : f_idle;
    sp_idle = idle ? speed[i] : sp_idle;
    const bool sooner = live & (free_t[i] < min_free);
    soonest = sooner ? i : soonest;
    min_free = sooner ? free_t[i] : min_free;
    sp_soon = sooner ? speed[i] : sp_soon;
  }
  const bool any_idle = first_idle < MAXC;
  slot = any_idle ? first_idle : soonest;
  start = fmaxf(a, any_idle ? f_idle : min_free);
  svc = __fdiv_rn(s, any_idle ? sp_idle : sp_soon);
  fin = __fadd_rn(start, svc);
#pragma unroll
  for (int i = 0; i < MAXC; ++i) free_t[i] = i == slot ? fin : free_t[i];
}

// Whether two states give the same outputs from the job arriving at `a` on.
// In a sorted row a slot with free <= a is idle for good, so it compares as
// `a`; otherwise (and in an unsorted row always) the raw bits must agree.
template <int MAXC>
__device__ __forceinline__ bool coupled(const float (&x)[MAXC], const float (&y)[MAXC], float a,
                                        int c, bool sorted) {
  bool same = true;  // bitwise operators throughout: selects, not branches
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const float cx = sorted & (x[i] <= a) ? a : x[i];
    const float cy = sorted & (y[i] <= a) ? a : y[i];
    same &= (i >= c) | (__float_as_uint(cx) == __float_as_uint(cy));
  }
  return same;
}

template <int MAXC>
__device__ __forceinline__ void load_speeds(float (&speed)[MAXC], const float* speeds, int c) {
#pragma unroll
  for (int i = 0; i < MAXC; ++i) speed[i] = i < c ? speeds[i] : 1.0f;
}

// Jobs j0 .. j0 + 31 of each of the warp's 32 segments into one stage,
// coalesced: lane l copies job j0 + l of every segment r (of `base` and
// `len`, held by lane r).
__device__ __forceinline__ void issue_tile(float (*dst_a)[kTile + 1], float (*dst_s)[kTile + 1],
                                           const float* arrivals, const float* services,
                                           long long base, int len, int j0) {
  const int lane = threadIdx.x;
  for (int r = 0; r < kLanes; ++r) {
    const long long b_r = __shfl_sync(0xffffffffu, base, r);
    const int len_r = __shfl_sync(0xffffffffu, len, r);
    if (lane < len_r - j0) {
      cp_async4(&dst_a[r][lane], arrivals + b_r + j0 + lane);
      cp_async4(&dst_s[r][lane], services + b_r + j0 + lane);
    }
  }
  cp_async_commit();
}

// Loads jobs j .. j + 3 of a row: with VEC one 16-byte load (the row and j
// aligned to four jobs), else four loads of the jobs below j1.
template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int j, int j1, float (&v)[4]) {
  if constexpr (VEC) {
    const float4 x = *reinterpret_cast<const float4*>(row + j);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = j + u < j1 ? row[j + u] : 0.0f;
  }
}

// Stores the outputs of jobs j .. j + 3 (those below j1).
template <bool VEC>
__device__ __forceinline__ void store4(float* st_row, float* fi_row, float* sv_row, int* sl_row,
                                       int j, int j1, const float (&st)[4], const float (&fi)[4],
                                       const float (&sv)[4], const int (&sl)[4]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(st_row + j) = make_float4(st[0], st[1], st[2], st[3]);
    *reinterpret_cast<float4*>(fi_row + j) = make_float4(fi[0], fi[1], fi[2], fi[3]);
    *reinterpret_cast<float4*>(sv_row + j) = make_float4(sv[0], sv[1], sv[2], sv[3]);
    *reinterpret_cast<int4*>(sl_row + j) = make_int4(sl[0], sl[1], sl[2], sl[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j + u < j1) {
        st_row[j + u] = st[u];
        fi_row[j + u] = fi[u];
        sv_row[j + u] = sv[u];
        sl_row[j + u] = sl[u];
      }
    }
  }
}

// Re-runs jobs j0 .. j1 - 1 of one row from `tru` beside a run from all
// slots idle, four jobs at a time, writing the outputs of the first, and
// stops after the four jobs in which the two first agree (`sorted`:
// equivalent, else bitwise); from there on the first run's outputs are the
// second's, which are already in place.  Returns the job where they agreed
// (j1 if nowhere), with the second run's state before it in `spec`; if
// nowhere, `tru` is the state after job j1 - 1.  The agreement test is not
// on the chain: both runs are stepped whatever it says.
template <int MAXC, bool VEC>
__device__ __forceinline__ int rerun(const float* a_row, const float* s_row, int j0, int j1,
                                     bool sorted, float (&tru)[MAXC], float (&spec)[MAXC],
                                     const float (&speed)[MAXC], int c, float* st_row,
                                     float* fi_row, float* sv_row, int* sl_row) {
  float run[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) run[i] = -INFINITY;
  int stop = j1;
  float an[4], sn[4];
  load4<VEC>(a_row, j0, j1, an);
  load4<VEC>(s_row, j0, j1, sn);
  for (int j = j0; j < j1; j += 4) {
    float a[4], s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = an[u], s[u] = sn[u];
    if (j + 4 < j1) {  // the next four, ahead of this chain
      load4<VEC>(a_row, j + 4, j1, an);
      load4<VEC>(s_row, j + 4, j1, sn);
    }
    float st[4], fi[4], sv[4], unused_f[3];
    int sl[4], unused_i;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (VEC || j + u < j1) {
        const bool first = (stop == j1) & coupled(tru, run, a[u], c, sorted);
        stop = first ? j + u : stop;
#pragma unroll
        for (int i = 0; i < MAXC; ++i) spec[i] = first ? run[i] : spec[i];
        kw_step(tru, speed, a[u], s[u], c, st[u], fi[u], sv[u], sl[u]);
        kw_step(run, speed, a[u], s[u], c, unused_f[0], unused_f[1], unused_f[2], unused_i);
      }
    }
    store4<VEC>(st_row, fi_row, sv_row, sl_row, j, j1, st, fi, sv, sl);
    if (stop < j1) break;
  }
  return stop;
}

// Steps `tru` over jobs j0 .. j1 - 1 of one row, writing the outputs, four
// jobs at a time.  Before job `check` it tests `tru` against `ref`
// (`sorted`: equivalent, else bitwise); if they agree it finishes those
// four jobs and returns `check`.  Otherwise it runs through, leaves `tru`
// the state after job j1 - 1 and returns j1.
template <int MAXC, bool VEC>
__device__ __forceinline__ int walk(const float* a_row, const float* s_row, int j0, int j1,
                                    int check, const float (&ref)[MAXC], bool sorted,
                                    float (&tru)[MAXC], const float (&speed)[MAXC], int c,
                                    float* st_row, float* fi_row, float* sv_row, int* sl_row) {
  float an[4], sn[4];
  load4<VEC>(a_row, j0, j1, an);
  load4<VEC>(s_row, j0, j1, sn);
  for (int j = j0; j < j1; j += 4) {
    float a[4], s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = an[u], s[u] = sn[u];
    if (j + 4 < j1) {  // the next four, ahead of this chain
      load4<VEC>(a_row, j + 4, j1, an);
      load4<VEC>(s_row, j + 4, j1, sn);
    }
    float st[4], fi[4], sv[4];
    int sl[4];
    bool hit = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j + u == check) hit = coupled(tru, ref, a[u], c, sorted);
      if (VEC || j + u < j1) kw_step(tru, speed, a[u], s[u], c, st[u], fi[u], sv[u], sl[u]);
    }
    store4<VEC>(st_row, fi_row, sv_row, sl_row, j, j1, st, fi, sv, sl);
    if (hit) return check;
  }
  return j1;
}

// Kernel 1: every (queue, segment) speculated, then fixed up from its
// predecessor's speculation; see the top.  info[pair] is -1 where no fix-up
// ran (segment 0, or the predecessor in another warp), else 2·(jobs
// written) + (1 if the runs agreed); walked[pair] is then the speculative
// state where they agreed, or else the fixed-up run's end state.
template <int MAXC, bool VEC>
__global__ void __launch_bounds__(kLanes)
kw_segment_kernel(const float* __restrict__ arrivals, const float* __restrict__ services,
                  const float* __restrict__ speeds, int B, int J, int c, int L, int K,
                  float* __restrict__ starts, float* __restrict__ finishes,
                  float* __restrict__ svcs, int* __restrict__ slots, float* __restrict__ ends,
                  float* __restrict__ walked, int* __restrict__ sorted_flags,
                  int* __restrict__ info) {
  __shared__ float in_a[2][kLanes][kTile + 1];
  __shared__ float in_s[2][kLanes][kTile + 1];
  __shared__ float o_st[kLanes][kTile + 1];
  __shared__ float o_fi[kLanes][kTile + 1];
  __shared__ float o_sv[kLanes][kTile + 1];
  __shared__ int o_sl[kLanes][kTile + 1];

  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  const int pair = blockIdx.x * kLanes + lane;
  const bool live = pair < B * K;
  const int seg = live ? pair % K : 0;
  const long long row = live ? static_cast<long long>(pair / K) * J : 0;
  const long long base = row + static_cast<long long>(seg) * L;
  const int len = live ? min(L, J - seg * L) : 0;
  const int tiles = (min(L, J) + kTile - 1) / kTile;

  float speed[MAXC];
  load_speeds(speed, speeds, c);
  float free_t[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) free_t[i] = seg == 0 ? 0.0f : -INFINITY;
  float prev = seg > 0 ? arrivals[base - 1] : -INFINITY;
  bool sorted = true;

  // a. the speculative run
  issue_tile(in_a[0], in_s[0], arrivals, services, base, len, 0);
  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < tiles) {
      issue_tile(in_a[st ^ 1], in_s[st ^ 1], arrivals, services, base, len, (t + 1) * kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int j0 = t * kTile;
    const int cols = min(kTile, len - j0);
#pragma unroll 4
    for (int jj = 0; jj < cols; ++jj) {
      const float a = in_a[st][lane][jj];
      sorted = sorted && a >= prev;  // false for NaN as well
      prev = a;
      float start, fin, svc;
      int slot;
      kw_step(free_t, speed, a, in_s[st][lane][jj], c, start, fin, svc, slot);
      o_st[lane][jj] = start;
      o_fi[lane][jj] = fin;
      o_sv[lane][jj] = svc;
      o_sl[lane][jj] = slot;
    }
    __syncwarp();
    for (int r = 0; r < kLanes; ++r) {
      const long long b_r = __shfl_sync(full, base, r);
      const int len_r = __shfl_sync(full, len, r);
      if (lane < len_r - j0) {
        const long long off = b_r + j0 + lane;
        starts[off] = o_st[r][lane];
        finishes[off] = o_fi[r][lane];
        svcs[off] = o_sv[r][lane];
        slots[off] = o_sl[r][lane];
      }
    }
    __syncwarp();  // also orders these stores before the fix-up's below
  }

  // b. the fix-up from the predecessor's speculation (lane - 1 holds it)
  float tru[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) tru[i] = __shfl_up_sync(full, free_t[i], 1);
  const unsigned sorted_lanes = __ballot_sync(full, sorted || !live);
  // equivalence is sound here if this segment and the rest of the row, all
  // in this warp, never decrease
  const int last = lane + (K - 1 - seg);
  const unsigned rest = last < kLanes ? ((2u << last) - 1) & ~((1u << lane) - 1) : 0u;
  const bool equiv_ok = last < kLanes && (sorted_lanes & rest) == rest;
  if (!live) return;
  const long long at = static_cast<long long>(pair) * c;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    if (i < c) ends[at + i] = free_t[i];
  }
  sorted_flags[pair] = sorted;
  if (seg == 0 || lane == 0) {
    info[pair] = -1;
    return;
  }
  const int j0 = seg * L;
  float spec[MAXC];
  const int stop = rerun<MAXC, VEC>(arrivals + row, services + row, j0, j0 + len, equiv_ok, tru,
                                    spec, speed, c, starts + row, finishes + row, svcs + row,
                                    slots + row);
  const bool agreed = stop < j0 + len;
  info[pair] = 2 * (stop - j0) + (agreed ? 1 : 0);
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    if (i < c) walked[at + i] = agreed ? spec[i] : tru[i];
  }
}

// Kernel 2: the fix-ups kernel 1 could not confirm, one thread per queue;
// see the top.  A segment to re-run is walked from the true state with the
// true run alone: up to where kernel 1's fix-up agreed with the speculative
// run, where the two states are compared, and on to the segment's end if
// they differ.  A segment walked to its end is compared with E[k] at the
// next arrival, which says whether kernel 1's fix-up of k + 1 stands.
template <int MAXC, bool VEC>
__global__ void __launch_bounds__(kLanes)
kw_fixup_kernel(const float* __restrict__ arrivals, const float* __restrict__ services,
                const float* __restrict__ speeds, int B, int J, int c, int L, int K,
                const float* __restrict__ ends, const float* __restrict__ walked,
                const int* __restrict__ sorted_flags, const int* __restrict__ info,
                float* __restrict__ starts, float* __restrict__ finishes,
                float* __restrict__ svcs, int* __restrict__ slots) {
  const int q = blockIdx.x * kLanes + threadIdx.x;
  if (q >= B) return;
  const long long qk = static_cast<long long>(q) * K;
  // equivalence is sound from segment k on if k > last_unsorted
  int last_unsorted = -1;
  for (int k = 0; k < K; ++k) {
    if (!sorted_flags[qk + k]) last_unsorted = k;
  }
  float speed[MAXC];
  load_speeds(speed, speeds, c);
  const long long row = static_cast<long long>(q) * J;
  const float* a_row = arrivals + row;

  // The true end state of segment k - 1: in registers (`tru`) or at `held`.
  float tru[MAXC];
  const float* held = ends + qk * c;
  bool confirmed = true;  // that state is equivalent to E[k - 1]
  int inf_next = info[qk + 1];
  for (int k = 1; k < K; ++k) {
    const int inf = inf_next;
    if (k + 1 < K) inf_next = info[qk + k + 1];
    if (confirmed && inf >= 0) {  // kernel 1's fix-up of k stands
      confirmed = inf & 1;
      held = (confirmed ? ends : walked) + (qk + k) * c;
      continue;
    }
    float ref[MAXC];
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      if (held != nullptr) tru[i] = i < c ? held[i] : 0.0f;
      ref[i] = i < c ? walked[(qk + k) * c + i] : 0.0f;
    }
    const int j0 = k * L;
    const int j1 = j0 + min(L, J - j0);
    const int check = inf >= 0 && (inf & 1) ? j0 + (inf >> 1) : -1;
    const int stop = walk<MAXC, VEC>(a_row, services + row, j0, j1, check, ref, k > last_unsorted,
                                     tru, speed, c, starts + row, finishes + row, svcs + row,
                                     slots + row);
    if (stop < j1) {
      confirmed = true;
      held = ends + (qk + k) * c;
    } else {
      held = nullptr;  // `tru` is exact
      if (k + 1 < K) {
        float e[MAXC];
#pragma unroll
        for (int i = 0; i < MAXC; ++i) e[i] = i < c ? ends[(qk + k) * c + i] : 0.0f;
        confirmed = coupled(tru, e, a_row[j1], c, k + 1 > last_unsorted);
      }
    }
  }
}

template <int MAXC>
int launch(const float* a, const float* s, const float* sp, int B, int J, int c, int L,
           float* scratch, int* flags, float* st, float* fi, float* sv, int* sl,
           cudaStream_t stream) {
  const int K = (J + L - 1) / L;
  const int pairs = B * K;
  float* ends = scratch;
  float* walked = scratch + static_cast<long long>(pairs) * c;
  int* sorted_flags = flags;
  int* info = flags + pairs;
  const bool vec = J % 4 == 0 && L % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(s) |
                    reinterpret_cast<uintptr_t>(st) | reinterpret_cast<uintptr_t>(fi) |
                    reinterpret_cast<uintptr_t>(sv) | reinterpret_cast<uintptr_t>(sl)) % 16 == 0;
  const dim3 grid1((pairs + kLanes - 1) / kLanes);
  if (vec) {
    kw_segment_kernel<MAXC, true><<<grid1, kLanes, 0, stream>>>(
        a, s, sp, B, J, c, L, K, st, fi, sv, sl, ends, walked, sorted_flags, info);
  } else {
    kw_segment_kernel<MAXC, false><<<grid1, kLanes, 0, stream>>>(
        a, s, sp, B, J, c, L, K, st, fi, sv, sl, ends, walked, sorted_flags, info);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || K == 1) return static_cast<int>(err);
  const dim3 grid((B + kLanes - 1) / kLanes);
  if (vec) {
    kw_fixup_kernel<MAXC, true><<<grid, kLanes, 0, stream>>>(
        a, s, sp, B, J, c, L, K, ends, walked, sorted_flags, info, st, fi, sv, sl);
  } else {
    kw_fixup_kernel<MAXC, false><<<grid, kLanes, 0, stream>>>(
        a, s, sp, B, J, c, L, K, ends, walked, sorted_flags, info, st, fi, sv, sl);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes.  `seg_len` is L, the jobs per segment; with
// K = ceil(J / L), `scratch` (2·B·K·c floats) and `flags` (2·B·K ints) are
// scratch the caller allocates.  Returns the CUDA error code of the launches
// (0 on success); c above 32 or L below 1 returns cudaErrorInvalidValue.
extern "C" int kw_queue_launch(const float* arrivals, const float* services,
                               const float* speeds, int B, int J, int c, int seg_len,
                               float* scratch, int* flags, float* starts, float* finishes,
                               float* svcs, int* slots, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (seg_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KW_LAUNCH(N)                                                                          \
  return launch<N>(arrivals, services, speeds, B, J, c, seg_len, scratch, flags, starts, \
                   finishes, svcs, slots, st)
  if (c <= 1) KW_LAUNCH(1);
  if (c <= 2) KW_LAUNCH(2);
  if (c <= 4) KW_LAUNCH(4);
  if (c <= 8) KW_LAUNCH(8);
  if (c <= 16) KW_LAUNCH(16);
  if (c <= 32) KW_LAUNCH(32);
#undef KW_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
