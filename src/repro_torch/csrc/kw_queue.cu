// Kiefer–Wolfowitz FIFO G/G/c queues: segment-parallel with an exact fix-up.
//
// Replaces the TPU kernel src/repro/kernels/kw_queue.py::kw_queue (Pallas
// body `_kernel`).  Job j of a queue takes the lowest-index slot already
// idle at its arrival, else the lowest-index slot among those that free
// earliest; start = max(a, free), svc = s / speed[slot], finish = start + svc.
//
// Coupling.  The recursion is sequential over the jobs of a queue, but its
// state forgets.  Call two states X, Y equivalent at a when every slot is
// idle in both (free <= a) or holds the same bits in both.  If the
// arrivals from a job on never decrease, two runs whose states are
// equivalent at that job's arrival give bit-identical outputs from it on:
// a slot idle at a stays idle for every later job and starts it at its
// arrival, and the "earliest-freeing" branch is taken only when every slot
// is busy, where the two states agree bit for bit.  Without that order only
// bitwise-equal states are known to agree.  Both paths cut a queue's J jobs
// into K segments of L, run each from a guessed start state, and re-run a
// segment from its predecessor's end state until the two runs couple.
//
// Path "tma" (kw_tma_kernel; every call with J a multiple of 4, 16-byte
// aligned tensors and a row group that fits in shared memory): one launch,
// no scratch.  A block holds R whole rows (queues), one thread a segment
// (R·K <= 256; the wrapper picks L so that B·K chains give several warps
// on every SM and a row has at most 80 segments, and R so that a block
// fills a warp).
//   0. One thread issues TMA loads of the rows' arrivals and services in
//      (R rows x TJ jobs) tiles, each completing on its own mbarrier; the
//      rows stay in shared memory, since the fix-ups read any job of them.
//   a. Speculate: each segment waits for its tiles and runs from all slots
//      idle (segment 0 from zeros), staging its outputs in shared memory,
//      its start and end states and whether its arrivals never decrease.
//   b. Rounds: each segment whose predecessor's end state changed (in the
//      first round, every segment after the first) re-runs from it beside
//      the staged run, whose state it rebuilds from its own start state and
//      the staged slots and finishes, and stops four jobs after the two
//      couple (equivalent where the row's arrivals never decrease from this
//      segment on, else bitwise).  If they never couple, its end state
//      changes.  A round's segments are listed first and taken by the
//      block's first threads, so that they fill as few warps as they can.
//      (Letting a re-run that never couples go on into the next segment
//      when the round does not hold that one measured slower on the card:
//      from a start not yet exact it walks stretches later rounds redo.)
//      Rounds go on, at most `max_rounds`, while a round settles (re-runs
//      without a change to pass on) at least two segments a row (after
//      round r, segments 0..r are exact).
//   c. Walk: where rounds stopped paying (a saturated queue never empties,
//      and each round settles one segment), one thread a row steps, in
//      order, every segment whose predecessor changed, from the exact state,
//      with nothing but the recursion on its chain; at the segment's end
//      its state is tested against the recorded end state at the next
//      arrival, which says whether the next segment must be walked too.
//   d. The four outputs go out from shared memory by TMA stores.
//   Each segment and each row's ordering flags live in shared memory: the
//   end states pass between segments there, and nothing else is written.
//   Shared memory is read 16 bytes a lane; with L/4 odd the lanes of a row
//   hit distinct banks.
//
// Path "two_launch" (kw_segment_kernel, kw_fixup_kernel; unaligned rows and
// views, and rows too long for shared memory): two launches, one
// thread a (queue, segment) in one-warp blocks and then one a queue, with
// the end states passed through scratch tensors the caller allocates.
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
//   whether the fix-up of k + 1 stands.
//   Its fix-up and walk go four jobs at a time, with 16-byte loads and
//   stores where rows and segments are aligned to four jobs.
//
// The step.  Passes over the slots pick the slot with selects only, then
// one division by the chosen slot's speed (path "tma" specialises c <= 4,
// scanning for the lowest idle slot from the top down).  The agreement
// tests are not on the chain: both runs are stepped whatever they say.
//
// Exactness.  Built without fast math: max, IEEE round-to-nearest division
// and addition (written as __fdiv_rn / __fadd_rn, so no contraction) are
// the operations of the plain PyTorch version, which both paths equal bit
// for bit, for sorted and unsorted rows alike: nothing a row keeps is
// speculative without the agreement test.  c <= 32, B·J < 2^31.
//
// What bounds it on an H100.  Bytes: B·J·24 (two float inputs, three float
// outputs and one int32 output), 25 MB at B=512, J=2048, i.e. 7.5 µs at
// 3.35 TB/s.  What sets the time of path "tma": the chains of dependent
// steps (L speculated, then the steps to coupling in each round, and at
// saturation J - 2L walked by one thread a row) and the issue slots of the
// B·K chains at once; PERF.md records the times.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

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

// ---- path "tma": one launch, a block per group of rows ----

constexpr int kTmaThreads = 256;  // most threads a block: R rows x K segments
constexpr int kTmaMaxTiles = 64;
constexpr long long kTmaSmemLimit = 232448;  // 227 KB, a block's most on Hopper
constexpr int kMaxDevices = 64;

// A block's shared memory, in bytes from a 128-byte aligned base: the six
// staged arrays (arrivals, services, starts, finishes, services scaled,
// slots), each `tiles` boxes of R rows x TJ jobs as TMA writes them (tile
// t of row r at (t·R + r)·TJ elements); each segment's start state and end
// state (c floats); each segment's "changed" flag; each row's last
// unsorted segment; a round's work list of segments; the list's length
// and a count of walked segments; one mbarrier per tile.
struct TmaLayout {
  long long arr, init, end, chg, last, list, walked, bars, total;
  __host__ __device__ TmaLayout(int R, int K, int c, int tj, int tiles) {
    const long long pairs = static_cast<long long>(R) * K;
    arr = static_cast<long long>(tiles) * R * tj * 4;
    init = 6 * arr;
    end = init + pairs * c * 4;
    chg = end + pairs * c * 4;
    last = chg + pairs * 4;
    list = last + R * 4;
    walked = list + pairs * 4;
    bars = (walked + 8 + 7) / 8 * 8;
    total = bars + tiles * 8 + 128;  // + the base's alignment
  }
};

// One job of the recursion, as kw_step, with fewer instructions: with
// EXACT the slot count is MAXC (c <= 4 is dispatched so), and the lowest
// idle slot is found scanning down, the last hit winning, so that each slot
// costs one comparison and three selects in each of the two scans.  (The c
// quotients s / speed[i] computed ahead of the choice, which takes the
// division off the chain, measured slower on the card in every phase.)
template <int MAXC, bool EXACT>
__device__ __forceinline__ void tma_step(float (&fr)[MAXC], const float (&speed)[MAXC], float a,
                                         float s, int c, float& start, float& fin, float& svc,
                                         int& slot) {
  int idle = MAXC;
  float f_idle = 0.0f, q_idle = 1.0f;
#pragma unroll
  for (int i = MAXC - 1; i >= 0; --i) {
    const bool hit = (EXACT || i < c) && fr[i] <= a;
    idle = hit ? i : idle;
    f_idle = hit ? fr[i] : f_idle;
    q_idle = hit ? speed[i] : q_idle;
  }
  int soon = 0;
  float f_soon = fr[0], q_soon = speed[0];
#pragma unroll
  for (int i = 1; i < MAXC; ++i) {
    const bool hit = (EXACT || i < c) && fr[i] < f_soon;
    soon = hit ? i : soon;
    f_soon = hit ? fr[i] : f_soon;
    q_soon = hit ? speed[i] : q_soon;
  }
  const bool any_idle = idle < MAXC;
  slot = any_idle ? idle : soon;
  start = fmaxf(a, any_idle ? f_idle : f_soon);
  svc = __fdiv_rn(s, any_idle ? q_idle : q_soon);
  fin = __fadd_rn(start, svc);
#pragma unroll
  for (int i = 0; i < MAXC; ++i) fr[i] = i == slot ? fin : fr[i];
}

// Element (r, j) of a staged array: tile j / TJ, row r, job j % TJ.
__device__ __forceinline__ int tma_at(int r, int j, int R, int lg) {
  return (((j >> lg) * R + r) << lg) | (j & ((1 << lg) - 1));
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Stores the outputs of jobs x .. x + 3 of the staged arrays (16 bytes each).
__device__ __forceinline__ void stage4(float* ST, float* FI, float* SV, int* SL, int x,
                                       const float (&st)[4], const float (&fi)[4],
                                       const float (&sv)[4], const int (&sl)[4]) {
  *reinterpret_cast<float4*>(ST + x) = make_float4(st[0], st[1], st[2], st[3]);
  *reinterpret_cast<float4*>(FI + x) = make_float4(fi[0], fi[1], fi[2], fi[3]);
  *reinterpret_cast<float4*>(SV + x) = make_float4(sv[0], sv[1], sv[2], sv[3]);
  *reinterpret_cast<int4*>(SL + x) = make_int4(sl[0], sl[1], sl[2], sl[3]);
}

// Runs jobs j0 .. j1 - 1 of staged row r from `fr`, four at a time (the
// next four loaded ahead of the chain), staging the outputs.  `prev` is the
// arrival of the job before j0 (-inf for none); returns whether the
// arrivals never decrease from there.
template <int MAXC, bool EXACT>
__device__ __forceinline__ bool tma_speculate(const float* A, const float* S, float* ST, float* FI,
                                              float* SV, int* SL, int r, int j0, int j1, int R,
                                              int lg, float prev, float (&fr)[MAXC],
                                              const float (&speed)[MAXC], int c) {
  bool sorted = true;
  int x = tma_at(r, j0, R, lg);
  float4 a4 = *reinterpret_cast<const float4*>(A + x);
  float4 s4 = *reinterpret_cast<const float4*>(S + x);
  for (int j = j0; j < j1; j += 4) {
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
    const int xc = x;
    if (j + 4 < j1) {
      x = tma_at(r, j + 4, R, lg);
      a4 = *reinterpret_cast<const float4*>(A + x);
      s4 = *reinterpret_cast<const float4*>(S + x);
    }
    float st[4], fi[4], sv[4];
    int sl[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      sorted &= a[u] >= prev;  // false for NaN as well
      prev = a[u];
      tma_step<MAXC, EXACT>(fr, speed, a[u], s[u], c, st[u], fi[u], sv[u], sl[u]);
    }
    stage4(ST, FI, SV, SL, xc, st, fi, sv, sl);
  }
  return sorted;
}

// Re-runs jobs j0 .. j1 - 1 of staged row r from `nw` beside the run whose
// outputs are staged there, whose state is rebuilt job by job from `old`
// (its start state) and its staged slots and finishes.  Four jobs at a
// time, staging the new run's outputs over the old: before each four the
// two states are tested at the first one's arrival (`equiv`: equivalent,
// else bitwise); if they agree, the four are finished (their outputs are
// the old ones) and it returns true.  Otherwise it returns false with `nw`
// the new run's end state.  The test is not on the chain: the four jobs
// are stepped whatever it says.
template <int MAXC, bool EXACT>
__device__ __forceinline__ bool tma_rerun(const float* A, const float* S, float* ST, float* FI,
                                          float* SV, int* SL, int r, int j0, int j1, int R, int lg,
                                          bool equiv, float (&nw)[MAXC], float (&old)[MAXC],
                                          const float (&speed)[MAXC], int c) {
  int x = tma_at(r, j0, R, lg);
  float4 a4 = *reinterpret_cast<const float4*>(A + x);
  float4 s4 = *reinterpret_cast<const float4*>(S + x);
  float4 f4 = *reinterpret_cast<const float4*>(FI + x);
  int4 l4 = *reinterpret_cast<const int4*>(SL + x);
  for (int j = j0; j < j1; j += 4) {
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
    const float of[4] = {f4.x, f4.y, f4.z, f4.w};
    const int ol[4] = {l4.x, l4.y, l4.z, l4.w};
    const int xc = x;
    if (j + 4 < j1) {  // the next four, ahead of the chain (and of this four's stores)
      x = tma_at(r, j + 4, R, lg);
      a4 = *reinterpret_cast<const float4*>(A + x);
      s4 = *reinterpret_cast<const float4*>(S + x);
      f4 = *reinterpret_cast<const float4*>(FI + x);
      l4 = *reinterpret_cast<const int4*>(SL + x);
    }
    const bool hit = coupled(nw, old, a[0], c, equiv);
    float st[4], fi[4], sv[4];
    int sl[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) tma_step<MAXC, EXACT>(nw, speed, a[u], s[u], c, st[u], fi[u], sv[u], sl[u]);
    stage4(ST, FI, SV, SL, xc, st, fi, sv, sl);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int i = 0; i < MAXC; ++i) old[i] = i == ol[u] ? of[u] : old[i];
    }
    if (hit) return true;
  }
  return false;
}

// Steps `tr` over jobs j0 .. j1 - 1 of staged row r alone, four at a time,
// staging the outputs: the walk's chain, with nothing else on it.
template <int MAXC, bool EXACT>
__device__ __forceinline__ void tma_walk(const float* A, const float* S, float* ST, float* FI,
                                         float* SV, int* SL, int r, int j0, int j1, int R, int lg,
                                         float (&tr)[MAXC], const float (&speed)[MAXC], int c) {
  int x = tma_at(r, j0, R, lg);
  float4 a4 = *reinterpret_cast<const float4*>(A + x);
  float4 s4 = *reinterpret_cast<const float4*>(S + x);
  for (int j = j0; j < j1; j += 4) {
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
    const int xc = x;
    if (j + 4 < j1) {
      x = tma_at(r, j + 4, R, lg);
      a4 = *reinterpret_cast<const float4*>(A + x);
      s4 = *reinterpret_cast<const float4*>(S + x);
    }
    float st[4], fi[4], sv[4];
    int sl[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) tma_step<MAXC, EXACT>(tr, speed, a[u], s[u], c, st[u], fi[u], sv[u], sl[u]);
    stage4(ST, FI, SV, SL, xc, st, fi, sv, sl);
  }
}

// The one-launch kernel; see the top.  Block b holds rows bR .. bR + R - 1,
// thread r·K + k owns segment k of row r.  EXACT: c == MAXC.
// `stats` (or null): per block, the %globaltimer ns at the start, after
// the speculation, the rounds, the walk and the stores, then the rounds
// run, the segments re-run in them and the segments walked.
template <int MAXC, bool EXACT>
__global__ void __launch_bounds__(kTmaThreads)
kw_tma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_s,
              const __grid_constant__ CUtensorMap tm_st, const __grid_constant__ CUtensorMap tm_fi,
              const __grid_constant__ CUtensorMap tm_sv, const __grid_constant__ CUtensorMap tm_sl,
              const float* __restrict__ speeds, int B, int J, int c, int L, int K, int R, int lg,
              int tiles, int max_rounds, long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char kw_raw[];
  const uint32_t raw = hopper::smem_addr(kw_raw);
  unsigned char* sm = kw_raw + (((raw + 127u) & ~127u) - raw);
  const uint32_t base = hopper::smem_addr(sm);
  const int tj = 1 << lg;
  const TmaLayout lay(R, K, c, tj, tiles);
  const float* A = reinterpret_cast<const float*>(sm);
  const float* S = reinterpret_cast<const float*>(sm + lay.arr);
  float* ST = reinterpret_cast<float*>(sm + 2 * lay.arr);
  float* FI = reinterpret_cast<float*>(sm + 3 * lay.arr);
  float* SV = reinterpret_cast<float*>(sm + 4 * lay.arr);
  int* SL = reinterpret_cast<int*>(sm + 5 * lay.arr);
  float* init = reinterpret_cast<float*>(sm + lay.init);
  float* end = reinterpret_cast<float*>(sm + lay.end);
  int* chg = reinterpret_cast<int*>(sm + lay.chg);
  int* last = reinterpret_cast<int*>(sm + lay.last);
  int* list = reinterpret_cast<int*>(sm + lay.list);
  int* count = reinterpret_cast<int*>(sm + lay.walked);
  int* walked = count + 1;
  const uint32_t bars = base + static_cast<uint32_t>(lay.bars);
  const int t = threadIdx.x;
  const int r = t / K, k = t - r * K;
  const int row0 = blockIdx.x * R;
  const bool live = r < R && row0 + r < B;
  const long long t_start = stats != nullptr && t == 0 ? global_ns() : 0;

  if (t == 0) {
    hopper::prefetch_tensormap(&tm_a);
    hopper::prefetch_tensormap(&tm_s);
    for (int i = 0; i < tiles; ++i) hopper::mbar_init(bars + 8 * i, 1);
    hopper::mbar_init_fence();
    *count = 0;
    *walked = 0;
  }
  if (t < R) last[t] = -1;
  float speed[MAXC];
  load_speeds(speed, speeds, c);
  __syncthreads();
  if (t == 0) {  // every tile's arrivals and services, each tile on its own mbarrier
    const uint32_t box = static_cast<uint32_t>(R * tj * 4);
    for (int i = 0; i < tiles; ++i) {
      hopper::mbar_expect_tx(bars + 8 * i, 2 * box);
      hopper::tma_load_2d(base + i * box, &tm_a, bars + 8 * i, i * tj, row0);
      hopper::tma_load_2d(base + static_cast<uint32_t>(lay.arr) + i * box, &tm_s, bars + 8 * i, i * tj, row0);
    }
    hopper::prefetch_tensormap(&tm_st);
    hopper::prefetch_tensormap(&tm_fi);
    hopper::prefetch_tensormap(&tm_sv);
    hopper::prefetch_tensormap(&tm_sl);
  }

  // a. the speculative runs, as their tiles land
  const int j0 = k * L, j1 = min(J, j0 + L);
  if (live) {
    for (int i = max(j0 - 1, 0) >> lg; i <= (j1 - 1) >> lg; ++i) hopper::mbar_wait(bars + 8 * i, 0);
    const float from = k == 0 ? 0.0f : -INFINITY;
    float fr[MAXC];
#pragma unroll
    for (int i = 0; i < MAXC; ++i) fr[i] = from;
    const float prev = k > 0 ? A[tma_at(r, j0 - 1, R, lg)] : -INFINITY;
    const bool sorted = tma_speculate<MAXC, EXACT>(A, S, ST, FI, SV, SL, r, j0, j1, R, lg, prev, fr,
                                                   speed, c);
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      if (i < c) {
        init[t * c + i] = from;
        end[t * c + i] = fr[i];
      }
    }
    if (!sorted) atomicMax(&last[r], k);
  }
  __syncthreads();
  const long long t_spec = stats != nullptr && t == 0 ? global_ns() : 0;

  // b. rounds: each segment whose predecessor's end state changed re-runs
  // from it, all at once (listed, so that they fill as few warps as they
  // can), until none changes, or until the rounds stop paying
  int rounds = 0;
  long long reruns = 0;
  bool walk = false;
  bool pend = live && k > 0;
  while (K > 1) {
    ++rounds;
    if (pend) list[atomicAdd(count, 1)] = t;
    __syncthreads();
    const int n_ran = *count;
    bool agreed = true;
    int seg = 0, sk = 0;
    float nw[MAXC];
    if (t < n_ran) {
      seg = list[t];
      const int sr = seg / K;
      sk = seg - sr * K;
      float old[MAXC];
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        nw[i] = i < c ? end[(seg - 1) * c + i] : 0.0f;
        old[i] = i < c ? init[seg * c + i] : 0.0f;
        if (i < c) init[seg * c + i] = nw[i];
      }
      // equivalence is sound where the arrivals never decrease from here on
      agreed = tma_rerun<MAXC, EXACT>(A, S, ST, FI, SV, SL, sr, sk * L, min(J, sk * L + L), R, lg,
                                      sk > last[sr], nw, old, speed, c);
    }
    if (t < R * K) chg[t] = 0;
    __syncthreads();  // every read of `end` and of the list is done
    if (t == 0) *count = 0;
    if (!agreed) {
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        if (i < c) end[seg * c + i] = nw[i];
      }
    }
    const bool spawned = !agreed && sk + 1 < K;
    if (spawned) chg[seg] = 1;
    const int n_spawned = __syncthreads_count(spawned);
    reruns += n_ran;
    if (n_spawned == 0) break;
    pend = live && k > 0 && chg[t - 1];
    // a round pays while it settles two or more segments a row; a saturated
    // row settles one a round, which the walk does without the re-runs
    if (rounds >= max_rounds || n_ran - n_spawned < 2 * R) {
      walk = true;
      break;
    }
  }
  const long long t_rounds = stats != nullptr && t == 0 ? global_ns() : 0;

  // c. the walk: per row, in order, each segment whose predecessor changed,
  // from the exact state, alone on the chain; at its end the state is
  // tested against the segment's recorded end state at the next arrival,
  // which says whether the next segment must be walked too
  if (walk && live && k == 0) {
    float tr[MAXC];
    bool held = false;  // tr is the exact end state of the segment before
    int n_walked = 0;
    for (int kk = 1; kk < K; ++kk) {
      const int u = t + kk;
      if (!chg[u - 1]) {
        held = false;
        continue;
      }
      if (!held) {
#pragma unroll
        for (int i = 0; i < MAXC; ++i) tr[i] = i < c ? end[(u - 1) * c + i] : 0.0f;
      }
      const int s0 = kk * L, s1 = min(J, s0 + L);
      tma_walk<MAXC, EXACT>(A, S, ST, FI, SV, SL, r, s0, s1, R, lg, tr, speed, c);
      if (kk + 1 < K) {
        float e[MAXC];
#pragma unroll
        for (int i = 0; i < MAXC; ++i) e[i] = i < c ? end[u * c + i] : 0.0f;
        if (!coupled(tr, e, A[tma_at(r, s1, R, lg)], c, kk + 1 > last[r])) chg[u] = 1;
      }
      held = true;
      ++n_walked;
    }
    atomicAdd(walked, n_walked);
  }

  // d. the outputs, by TMA from the staged arrays
  hopper::fence_proxy_async_cta();
  __syncthreads();
  if (t == 0) {
    const long long t_walk = stats != nullptr ? global_ns() : 0;
    const uint32_t box = static_cast<uint32_t>(R * tj * 4);
    for (int i = 0; i < tiles; ++i) {
      const uint32_t at = base + i * box;
      hopper::tma_store_2d(&tm_st, at + static_cast<uint32_t>(2 * lay.arr), i * tj, row0);
      hopper::tma_store_2d(&tm_fi, at + static_cast<uint32_t>(3 * lay.arr), i * tj, row0);
      hopper::tma_store_2d(&tm_sv, at + static_cast<uint32_t>(4 * lay.arr), i * tj, row0);
      hopper::tma_store_2d(&tm_sl, at + static_cast<uint32_t>(5 * lay.arr), i * tj, row0);
    }
    hopper::bulk_commit();
    hopper::bulk_wait();
    if (stats != nullptr) {
      long long* out = stats + static_cast<long long>(blockIdx.x) * 8;
      out[0] = t_start;
      out[1] = t_spec;
      out[2] = t_rounds;
      out[3] = t_walk;
      out[4] = global_ns();
      out[5] = rounds;
      out[6] = reruns;
      out[7] = *walked;
    }
  }
}

template <int MAXC, bool EXACT>
int launch_tma(const float* a, const float* s, const float* sp, int B, int J, int c, int L, int R,
               int lg, int max_rounds, float* st, float* fi, float* sv, int* sl, long long* stats,
               cudaStream_t stream, int device) {
  const int K = (J + L - 1) / L;
  const int tj = 1 << lg;
  const int tiles = (J + tj - 1) / tj;
  const TmaLayout lay(R, K, c, tj, tiles);
  auto kernel = kw_tma_kernel<MAXC, EXACT>;
  static bool attr_set[kMaxDevices] = {};
  if (!attr_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(kTmaSmemLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[device] = true;
  }
  CUtensorMap maps[6];
  const void* ptrs[6] = {a, s, st, fi, sv, sl};
  for (int m = 0; m < 6; ++m) {
    const int e = hopper::encode_map_2d(&maps[m], ptrs[m],
                                        m == 5 ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                        B, J, tj, R);
    if (e != 0) return e;
  }
  const int threads = (R * K + 31) / 32 * 32;
  kernel<<<(B + R - 1) / R, threads, lay.total, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                          maps[5], sp, B, J, c, L, K, R, lg, tiles,
                                                          max_rounds, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a block of the one-launch kernel takes (bytes): R rows of
// K segments, c slots, tiles of tj jobs.
extern "C" long long kw_queue_tma_smem_bytes(int R, int K, int c, int tj, int tiles) {
  return TmaLayout(R, K, c, tj, tiles).total;
}

// Plain C entry of path "tma" for ctypes: one launch, no scratch.  L jobs a
// segment (a multiple of 4), R rows a block, tiles of 2^lg jobs, at most
// `max_rounds` rounds before the walk, `stats` null or 8 int64 a block.  Returns 0, a CUDA error code, or
// hopper.cuh's codes for the tensor maps (cudaErrorInvalidValue for a shape
// the kernel does not take: J or L not a multiple of 4, R·K above 256,
// unaligned pointers, too much shared memory, c above 32).
extern "C" int kw_queue_tma_launch(const float* arrivals, const float* services,
                                   const float* speeds, int B, int J, int c, int L, int R, int lg,
                                   int max_rounds, float* starts, float* finishes,
                                   float* svcs, int* slots, long long* stats, void* stream,
                                   int device) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int K = L >= 4 ? (J + L - 1) / L : 0;
  const int tiles = lg >= 5 && lg <= 8 ? (J + (1 << lg) - 1) >> lg : 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(arrivals) | reinterpret_cast<uintptr_t>(services) |
                         reinterpret_cast<uintptr_t>(starts) | reinterpret_cast<uintptr_t>(finishes) |
                         reinterpret_cast<uintptr_t>(svcs) | reinterpret_cast<uintptr_t>(slots);
  if (B < 1 || J < 4 || J % 4 != 0 || L % 4 != 0 || K < 1 || R < 1 || R > 256 || R * K > kTmaThreads ||
      tiles < 1 || tiles > kTmaMaxTiles || addr % 16 != 0 || c < 1 || c > 32 ||
      max_rounds < 1 || TmaLayout(R, K, c, 1 << lg, tiles).total > kTmaSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KW_TMA(N, EXACT)                                                                        \
  return launch_tma<N, EXACT>(arrivals, services, speeds, B, J, c, L, R, lg, max_rounds, starts, \
                              finishes, svcs, slots, stats, st, device)
  if (c == 1) KW_TMA(1, true);
  if (c == 2) KW_TMA(2, true);
  if (c == 3) KW_TMA(3, true);
  if (c == 4) KW_TMA(4, true);
  if (c <= 8) KW_TMA(8, false);
  if (c <= 16) KW_TMA(16, false);
  KW_TMA(32, false);
#undef KW_TMA
}

// Plain C entry of path "two_launch" for ctypes.  `seg_len` is L, the jobs per segment; with
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
