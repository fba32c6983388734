// Mamba2 SSD chunked scan (state-space duality), from a zero initial state.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (Pallas
// body `_kernel`).  Per batch row b and head h (group g = h / (H / G)), the
// sequence is cut into chunks of Q steps.  Within a chunk, with
// cs = cumsum(dt·A):
//   y_i = Σ_{j<=i} (C_i·B_j) exp(cs_i - cs_j) dt_j x_j        (intra-chunk)
//       + exp(cs_i) C_i · h                                    (carried state)
//       + D x_i
//   h  <- exp(cs_last) h + Σ_j exp(cs_last - cs_j) dt_j x_j ⊗ B_j
// x, B and C are float32 or bfloat16 (one type), dt, A and D float32; y is
// stored in x's type and h_final in float32.  Groups are indexed (h / (H /
// G)) where the TPU wrapper repeated B and C, and the ragged last chunk is
// masked (x = dt = B = C = 0 past S: the step's decay is exp(0) = 1 and its
// input 0, which leaves h as the TPU wrapper's zero padding does).  The TPU
// kernel carries h along a sequential grid axis; here the chunks of one
// head run in parallel, split as the plain version (ssd_scan_plain) and the
// reference's ssd_chunked split them.  Three kernels; the wrapper's
// `kernel_path` picks one.
//
// bfloat16, chunk 128, P and N 64 or 128, 16-byte aligned x, B and C, any
// number of chunks (every main-path call; "wgmma_tma"): one launch on
// Hopper.
// - Work.  The blocks of a (batch row, head), K = min(nc, 8) of two
//   warpgroups each, form a thread block cluster along the chunks
//   (cudaLaunchKernelEx with a cluster dimension; the launch checks with
//   cudaOccupancyMaxActiveClusters that one fits and fails otherwise).
//   The cluster walks the chunks in groups of K, one group after another:
//   the block of rank r takes chunks r, r + K, r + 2K, ...  Below, "the
//   chunk" is a block's chunk of the current group.  At P = N = 64 two
//   blocks share an SM (85 KB of shared memory, 128 registers a thread).
// - Loads.  Thread 0 loads the chunk's x (Bt, S, H, P) and its group's B
//   and C (Bt, S, G, N) by TMA, 4-D maps read by strides in 128-row boxes
//   of 64 columns with the 128-byte swizzle, rows past S as zeros, onto
//   one mbarrier; dt by ordinary loads, its cumsum by warp shuffles.
// - Products on wgmma, every float32 operand split into bf16 hi + lo (two
//   products, relative error 2^-18): the state (w ⊙ x)ᵀ·B with both
//   operands MN-major (the weighted x written by the threads in x's
//   swizzled layout), S = C·Bᵀ with both K-major (as Q·Kᵀ), Y = (S ⊙ L ⊙
//   dt)·x with the scaled S from registers as the A operand (as P in
//   flash attention) and x MN-major, and C·h_cᵀ with h K-major.  Rows 0-63
//   need keys 0-63 only: warpgroup 0 takes them and the state, warpgroup 1
//   rows 64-127 against all 128 keys; key blocks past a warp's rows are
//   skipped, and L·dt is one exp2 an element, 2^(cs_i·log2 e + k_j) with
//   k_j = log2(dt_j) - cs_j·log2 e (ex2.approx, lg2.approx).
// - The chunk states never leave the chip.  Each block leaves its state
//   (float32) and decay in shared memory and arrives at the cluster
//   barrier.  Warpgroup 0 then runs the recurrence h_{c+1} = decay_c·h_c +
//   state_c in float32 and the plain version's order, the cluster's blocks
//   splitting the elements, each block owning the same elements in every
//   group: each reads its elements' states from every block of the group
//   over distributed shared memory (mapa, ld.shared::cluster) and stores
//   each block's h_c, bf16 hi and lo in the K-major layout C·hᵀ reads, into
//   that block's shared memory by st.async, whose bytes complete on the
//   receiving block's own mbarrier.  The owner keeps its elements' float32
//   h from the group's last chunk in its own shared memory, starts the
//   next group's recurrence from it, and writes h_final after the last
//   group.  Warpgroup 1 runs its intra-chunk product meanwhile, and
//   warpgroup 0's overlaps its recurrence.  A second cluster barrier,
//   waited for at the end of a group, keeps every state and decay in place
//   until all blocks have read them, before the next group's loads and
//   weighted x overwrite them; the two mbarriers' phases flip once a group.
//   Where nc is not a multiple of K, the last group's later blocks run
//   chunks past the end, all zeros (TMA's fill, dt = 0): state 0, decay 1,
//   so h passes them unchanged and exactly, and they store nothing.
// - y = Y + exp(cs)·Z + D·x goes from the accumulators to device memory,
//   4 bytes a store (a TMA store of the tile, staged over x, was slower).
//
// bfloat16 otherwise ("mma_sync": P = 16, N = 8, chunks other than 128,
// unaligned views): chunk-parallel, two launches.
//   1. ssd_chunk_state_kernel, one block per (chunk, head, batch row):
//      cs by a warp-shuffle scan, the chunk's own state
//      Σ_j exp(cs_last - cs_j)·dt_j·x_jᵀ B_j (a (P x Q)·(Q x N) product) and
//      its decay exp(cs_last), into a float32 scratch tensor; x is weighted
//      in place, so 55 KB of shared memory let 4 blocks share an SM;
//   2. ssd_chunk_output_kernel, one block per (chunk, head, batch row):
//      the state entering the chunk by the elementwise recurrence
//      h_c = decay_{c-1}·h_{c-1} + state_{c-1} over the chunks before it, in
//      float32 and in the plain version's order (the last chunk's block
//      writes h_final = h_nc), while cp.async brings the chunk's x, B and
//      C; then y = exp(cs)·C·h_cᵀ + (C·Bᵀ ⊙ L ⊙ dt)·x + D·x, each warp
//      taking 16 rows and walking the key blocks of 16 up to its diagonal.
// Products run as mma.sync.m16n8k16 on bf16 operands with float32
// accumulators, the float32 operands split as above.  Widths are padded to
// multiples of 16 with zeros in shared memory.
//
// float32 ("cuda_core"; 1e-3 tolerance, exact float32 arithmetic): one
// block of 256 threads per (b, h) that loops over the chunks with the
// (P, N) state in shared memory; 32-row tiles of the Q x Q score matrix
// against their causal columns only; products on the CUDA cores.
//
// What bounds it on an H100.  At the serve shape (1, 1024, 64, 64), N = 64,
// G = 1, Q = 128, bf16: x and y 8.4 MB each, B, C, dt and h_final 1.6 MB,
// about 18 MB, 5.5 µs at 3.35 TB/s; 2.16 GFLOP, 2.2 µs at the bf16 rate.
// On an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md) the Hopper kernel takes
// about 0.033 ms there, against 0.073 ms for the two mma.sync launches
// (0.464 ms for the float32 kernel), and 0.062 against 0.201 ms at
// mamba2-2.7b's (1, 1024, 80, 64), N = 128; at its 4096 tokens (32 chunks,
// 4 groups) 0.224 against 1.110 ms, whose output kernel reads every
// earlier chunk's state.  Neither bytes nor operations set it: a block's
// chain of dependent steps (loads, products, the cluster barrier, the
// recurrence over distributed shared memory, the stores), 6-9 µs a group,
// and the waves: 30 clusters of 8 blocks fit on the card at once (15 at N
// = 128), so the serve shape's 64 clusters take 3 (tools/ssd_trace.py).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows of y per tile: 8 warps x 4 rows

struct Geometry {
  int Qp, Pp, N1;  // rows rounded to 32, x columns rounded to 32, B/h stride N + 1
  size_t x, b, c, h, w, vec;  // float offsets
  size_t bytes;
};

__host__ __device__ inline Geometry geometry(int Q, int P, int N, int PC) {
  Geometry g;
  g.Qp = (Q + 31) / 32 * 32;
  g.Pp = PC * 32;
  g.N1 = N + 1;
  g.x = 0;
  g.b = g.x + static_cast<size_t>(g.Qp) * g.Pp;
  g.c = g.b + static_cast<size_t>(g.Qp) * g.N1;
  g.h = g.c + static_cast<size_t>(g.Qp) * N;
  g.w = g.h + static_cast<size_t>(g.Pp) * g.N1;
  g.vec = g.w + static_cast<size_t>(kRows) * g.Qp;
  g.bytes = (g.vec + 4 * static_cast<size_t>(g.Qp)) * sizeof(float);
  return g;
}

// PC = ceil(P / 32) and NC = ceil(N / 32), each 1, 2 or 4.
template <int PC, int NC>
__global__ void __launch_bounds__(kThreads)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ Dv,
                    float* __restrict__ y, float* __restrict__ h_final, int S, int H,
                    int P, int G, int N, int Q) {
  extern __shared__ float smem[];
  const Geometry geo = geometry(Q, P, N, PC);
  const int Qp = geo.Qp, Pp = geo.Pp, N1 = geo.N1;
  float* x_s = smem + geo.x;
  float* b_s = smem + geo.b;
  float* c_s = smem + geo.c;
  float* h_s = smem + geo.h;
  float* w_s = smem + geo.w;
  float* dt_s = smem + geo.vec;
  float* cs_s = dt_s + Qp;
  float* ea_s = cs_s + Qp;
  float* wt_s = ea_s + Qp;

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float a_h = A[h];
  const float d_h = Dv[h];
  const size_t xrow = static_cast<size_t>(H) * P;
  const size_t brow = static_cast<size_t>(G) * N;
  const float* xb = x + (static_cast<size_t>(b) * S * H + h) * P;
  float* yb = y + (static_cast<size_t>(b) * S * H + h) * P;
  const float* bb = Bm + (static_cast<size_t>(b) * S * G + g) * N;
  const float* cb = Cm + (static_cast<size_t>(b) * S * G + g) * N;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;

  for (int e = tid; e < Pp * N1; e += kThreads) h_s[e] = 0.0f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = ci * Q;
    __syncthreads();  // the previous chunk's state update is done
    for (int e = tid; e < Qp * Pp; e += kThreads) {
      const int r = e / Pp, c = e - r * Pp;
      const int s = s0 + r;
      x_s[e] = (r < Q && s < S && c < P) ? xb[s * xrow + c] : 0.0f;
    }
    for (int e = tid; e < Qp * N; e += kThreads) {
      const int r = e / N, c = e - r * N;
      const int s = s0 + r;
      const bool in = r < Q && s < S;
      b_s[r * N1 + c] = in ? bb[s * brow + c] : 0.0f;
      c_s[e] = in ? cb[s * brow + c] : 0.0f;
    }
    for (int r = tid; r < Qp; r += kThreads) {
      const int s = s0 + r;
      dt_s[r] = (r < Q && s < S) ? dtb[static_cast<size_t>(s) * H] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.0f;
      for (int r = 0; r < Qp; ++r) {
        acc += dt_s[r] * a_h;
        cs_s[r] = acc;
      }
    }
    __syncthreads();
    const float cs_last = cs_s[Q - 1];
    for (int r = tid; r < Qp; r += kThreads) {
      ea_s[r] = expf(cs_s[r]);
      wt_s[r] = expf(cs_last - cs_s[r]) * dt_s[r];
    }
    __syncthreads();

    for (int rt = 0; rt < Qp / kRows; ++rt) {
      const int r0 = rt * kRows;
      const int c_max = rt;  // column groups 0..rt hold every j <= i of the tile
      // (1) decay-weighted scores of the tile's rows against columns j <= i
      float sc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = c_s[(r0 + ty * 4 + a) * N + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = c <= c_max ? b_s[(tx + 32 * c) * N1 + n] : 0.0f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(cv[a], bv[c], sc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = r0 + ty * 4 + a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c > c_max) continue;
          const int j = tx + 32 * c;
          w_s[(ty * 4 + a) * Qp + j] =
              j <= i ? sc[a][c] * expf(cs_s[i] - cs_s[j]) * dt_s[j] : 0.0f;
        }
      }
      __syncthreads();

      // (2) y rows of the tile: intra-chunk + carried state + D x
      float yv[4][PC], ch[4][PC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < PC; ++c) yv[a][c] = ch[a][c] = 0.0f;
      const int j_end = r0 + kRows;
      for (int j = 0; j < j_end; ++j) {
        float wv[4], xv[PC];
#pragma unroll
        for (int a = 0; a < 4; ++a) wv[a] = w_s[(ty * 4 + a) * Qp + j];
#pragma unroll
        for (int c = 0; c < PC; ++c) xv[c] = x_s[j * Pp + tx + 32 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < PC; ++c) yv[a][c] = fmaf(wv[a], xv[c], yv[a][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[PC];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = c_s[(r0 + ty * 4 + a) * N + n];
#pragma unroll
        for (int c = 0; c < PC; ++c) hv[c] = h_s[(tx + 32 * c) * N1 + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < PC; ++c) ch[a][c] = fmaf(cv[a], hv[c], ch[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = r0 + ty * 4 + a;
        const int s = s0 + i;
        if (i >= Q || s >= S) continue;
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int p = tx + 32 * c;
          if (p >= P) continue;
          const float out = yv[a][c] + ch[a][c] * ea_s[i] + x_s[i * Pp + p] * d_h;
          yb[s * xrow + p] = out;
        }
      }
      __syncthreads();
    }

    // (3) h <- exp(cs_last) h + Σ_j wt_j x_j ⊗ B_j
    const float decay = expf(cs_last);
    float ns[4 * PC][NC];
#pragma unroll
    for (int a = 0; a < 4 * PC; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) ns[a][c] = 0.0f;
    for (int j = 0; j < Q; ++j) {
      const float wj = wt_s[j];
      float xv[4 * PC], bv[NC];
#pragma unroll
      for (int a = 0; a < 4 * PC; ++a) xv[a] = wj * x_s[j * Pp + ty + 8 * a];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = tx + 32 * c;
        bv[c] = n < N ? b_s[j * N1 + n] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < 4 * PC; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) ns[a][c] = fmaf(xv[a], bv[c], ns[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4 * PC; ++a) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = tx + 32 * c;
        if (n >= N) continue;
        float* hp = h_s + (ty + 8 * a) * N1 + n;
        *hp = *hp * decay + ns[a][c];
      }
    }
  }
  __syncthreads();
  float* hb = h_final + (static_cast<size_t>(b) * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    hb[e] = h_s[p * N1 + n];
  }
}

// ---- bfloat16 inputs: chunk-parallel, tensor-core tiles ----

using tc::bf16;

constexpr int kCpThreads = 256;  // 8 warps, 16 rows each: chunks up to 128

// Shared layout of the two passes: bf16 tiles (rows padded to a multiple
// of 16, each row by 8 more elements so that ldmatrix rows hit distinct
// banks), then float vectors.  Offsets in bf16 elements, sizes in bytes.
struct CpGeometry {
  int Qp, Pp, Np, LDP, LDN;
  size_t x, b, c, h_hi, h_lo;    // output pass
  size_t xw_lo;  // state pass: x (then the weighted x's high parts), B, the low parts
  size_t out_floats, state_floats;  // byte offsets of the float vectors
  size_t out_bytes, state_bytes;
};

__host__ __device__ inline CpGeometry cp_geometry(int Q, int P, int N) {
  CpGeometry g;
  g.Qp = (Q + 15) / 16 * 16;
  g.Pp = (P + 15) / 16 * 16;
  g.Np = (N + 15) / 16 * 16;
  g.LDP = g.Pp + 8;
  g.LDN = g.Np + 8;
  const size_t xt = static_cast<size_t>(g.Qp) * g.LDP;
  const size_t nt = static_cast<size_t>(g.Qp) * g.LDN;
  const size_t ht = static_cast<size_t>(g.Pp) * g.LDN;
  // dt, cs, w (state pass only) and the warp sums of the scan
  const size_t floats = (3 * static_cast<size_t>(g.Qp) + 8) * sizeof(float);
  g.x = 0;
  g.b = xt;
  g.c = g.b + nt;
  g.h_hi = g.c + nt;
  g.h_lo = g.h_hi + ht;
  g.out_floats = (g.h_lo + ht) * sizeof(bf16);
  g.out_bytes = g.out_floats + floats;
  g.xw_lo = g.b + nt;
  g.state_floats = (g.xw_lo + xt) * sizeof(bf16);
  g.state_bytes = g.state_floats + floats;
  return g;
}

// The chunk's dt into shared memory, 0 past its valid rows.
__device__ __forceinline__ void stage_dt(float* dt_s, const float* dt, size_t first, int H,
                                         int Qp, int valid, int tid) {
  for (int r = tid; r < Qp; r += kCpThreads) {
    dt_s[r] = r < valid ? dt[first + static_cast<size_t>(r) * H] : 0.0f;
  }
}

// cs_s[i] = Σ_{j<=i} dt_s[j]·a over Qp <= 128 rows, by warp shuffles;
// begins and ends with __syncthreads.
__device__ __forceinline__ void chunk_cumsum(const float* dt_s, float* cs_s, float* sums,
                                             float a, int Qp, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  float v = tid < Qp ? dt_s[tid] * a : 0.0f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) sums[warp] = v;
  __syncthreads();
  float base = 0.0f;
  for (int w = 0; w < warp; ++w) base += sums[w];
  if (tid < Qp) cs_s[tid] = base + v;
  __syncthreads();
}

__global__ void __launch_bounds__(kCpThreads)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ decays, int S, int H,
                       int P, int G, int N, int Q, int vec_x, int vec_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CpGeometry geo = cp_geometry(Q, P, N);
  const int Qp = geo.Qp, Pp = geo.Pp, Np = geo.Np, LDP = geo.LDP, LDN = geo.LDN;
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* x_s = sm + geo.x;  // x, then the high parts of the weighted x in place
  bf16* b_s = sm + geo.b;
  bf16* xl_s = sm + geo.xw_lo;
  float* dt_s = reinterpret_cast<float*>(smem_raw + geo.state_floats);
  float* cs_s = dt_s + Qp;
  float* w_s = cs_s + Qp;
  float* sums = w_s + Qp;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int s0 = c * Q;
  const int valid = min(Q, S - s0);
  const size_t xrow = static_cast<size_t>(H) * P, brow = static_cast<size_t>(G) * N;
  const size_t first = static_cast<size_t>(b) * S + s0;
  tc::stage_rows(x_s, LDP, x + first * xrow + static_cast<size_t>(h) * P, xrow, Qp, valid, P, Pp,
                 vec_x, tid, kCpThreads);
  tc::stage_rows(b_s, LDN, Bm + first * brow + static_cast<size_t>(g) * N, brow, Qp, valid, N, Np,
                 vec_b, tid, kCpThreads);
  tc::cp_async_commit();
  stage_dt(dt_s, dt, first * H + h, H, Qp, valid, tid);
  chunk_cumsum(dt_s, cs_s, sums, A[h], Qp, tid);
  const float cs_last = cs_s[Qp - 1];
  for (int j = tid; j < Qp; j += kCpThreads) w_s[j] = expf(cs_last - cs_s[j]) * dt_s[j];
  tc::cp_async_wait<0>();
  __syncthreads();
  // the weighted x, split into bf16 hi + lo
  for (int e = tid; e < Qp * Pp; e += kCpThreads) {
    const int j = e / Pp, p = e - j * Pp;
    float hi, lo;
    tc::split_bf16(w_s[j] * __bfloat162float(x_s[j * LDP + p]), hi, lo);
    x_s[j * LDP + p] = __float2bfloat16_rn(hi);
    xl_s[j * LDP + p] = __float2bfloat16_rn(lo);
  }
  __syncthreads();

  // state (P x N) = (w ⊙ x)ᵀ·B in 16 x 16 output tiles spread over the warps
  float* st = states + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N;
  const int n16 = Np / 16;
  const int g4 = lane >> 2, t4 = lane & 3;
  for (int item = warp; item < (Pp / 16) * n16; item += kCpThreads / 32) {
    const int p0 = item / n16 * 16, n0 = item % n16 * 16;
    float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kk = 0; kk < Qp / 16; ++kk) {
      uint32_t ah[4], al[4], bq[4];
      const int a_off = (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * LDP + p0 + ((lane >> 3) & 1) * 8;
      tc::ldmatrix_x4_trans(ah, x_s + a_off);
      tc::ldmatrix_x4_trans(al, xl_s + a_off);
      tc::ldmatrix_x4_trans(bq, b_s + (kk * 16 + (lane & 15)) * LDN + n0 + (lane >> 4) * 8);
      tc::mma_bf16(d0, ah, bq[0], bq[1]);
      tc::mma_bf16(d0, al, bq[0], bq[1]);
      tc::mma_bf16(d1, ah, bq[2], bq[3]);
      tc::mma_bf16(d1, al, bq[2], bq[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g4 + (e >> 1) * 8;
      const int n = n0 + 2 * t4 + (e & 1);
      if (p < P && n < N) st[p * N + n] = d0[e];
      if (p < P && n + 8 < N) st[p * N + n + 8] = d1[e];
    }
  }
  if (tid == 0) decays[(static_cast<size_t>(b) * nc + c) * H + h] = expf(cs_last);
}

// PW and NW: P and N rounded up to 16, at most 64 or 128 (the register
// arrays' compile-time widths).  At 64 x 64 (the serve shape) registers are
// capped for 3 blocks per SM, which fits without spills; the wider
// instantiations would spill under that cap.
template <int PW, int NW>
__global__ void __launch_bounds__(kCpThreads, PW == 64 && NW == 64 ? 3 : 1)
ssd_chunk_output_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm, const float* __restrict__ Dv,
                        const float* __restrict__ states, const float* __restrict__ decays,
                        bf16* __restrict__ y, float* __restrict__ h_final, int S, int H, int P,
                        int G, int N, int Q, int vec_x, int vec_b) {
  constexpr int PT = PW / 8, NK = NW / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CpGeometry geo = cp_geometry(Q, P, N);
  const int Qp = geo.Qp, Pp = geo.Pp, Np = geo.Np, LDP = geo.LDP, LDN = geo.LDN;
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* x_s = sm + geo.x;
  bf16* b_s = sm + geo.b;
  bf16* c_s = sm + geo.c;
  bf16* hh_s = sm + geo.h_hi;
  bf16* hl_s = sm + geo.h_lo;
  float* dt_s = reinterpret_cast<float*>(smem_raw + geo.out_floats);
  float* cs_s = dt_s + Qp;
  float* sums = cs_s + 2 * Qp;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int s0 = c * Q;
  const int valid = min(Q, S - s0);
  const size_t xrow = static_cast<size_t>(H) * P, brow = static_cast<size_t>(G) * N;
  const size_t first = static_cast<size_t>(b) * S + s0;
  tc::stage_rows(x_s, LDP, x + first * xrow + static_cast<size_t>(h) * P, xrow, Qp, valid, P, Pp,
                 vec_x, tid, kCpThreads);
  tc::stage_rows(b_s, LDN, Bm + first * brow + static_cast<size_t>(g) * N, brow, Qp, valid, N, Np,
                 vec_b, tid, kCpThreads);
  tc::stage_rows(c_s, LDN, Cm + first * brow + static_cast<size_t>(g) * N, brow, Qp, valid, N, Np,
                 vec_b, tid, kCpThreads);
  tc::cp_async_commit();
  stage_dt(dt_s, dt, first * H + h, H, Qp, valid, tid);

  // h_c, the state entering this chunk, while the copies are in flight:
  // kHv elements per thread at a time, their loads of one chunk issued together
  constexpr int kHv = 16;
  const size_t PN = static_cast<size_t>(P) * N;
  const size_t c_stride = static_cast<size_t>(H) * PN;
  const float* st = states + (static_cast<size_t>(b) * nc * H + h) * PN;
  const float* dec = decays + static_cast<size_t>(b) * nc * H + h;
  for (int base = 0; base < Pp * Np; base += kHv * kCpThreads) {
    float hv[kHv];
    int at[kHv];  // offset in a P x N state, -1 in the zero padding
#pragma unroll
    for (int i = 0; i < kHv; ++i) {
      const int e = base + i * kCpThreads + tid;
      const int p = e / Np, n = e - p * Np;
      at[i] = e < Pp * Np && p < P && n < N ? p * N + n : -1;
      hv[i] = 0.0f;
    }
    for (int cc = 0; cc < c; ++cc) {
      const float d = dec[cc * H];
      const float* sc = st + cc * c_stride;
#pragma unroll
      for (int i = 0; i < kHv; ++i) {
        if (at[i] >= 0) hv[i] = hv[i] * d + sc[at[i]];
      }
    }
#pragma unroll
    for (int i = 0; i < kHv; ++i) {
      const int e = base + i * kCpThreads + tid;
      if (e >= Pp * Np) continue;
      const int p = e / Np, n = e - p * Np;
      float hi, lo;
      tc::split_bf16(hv[i], hi, lo);
      hh_s[p * LDN + n] = __float2bfloat16_rn(hi);
      hl_s[p * LDN + n] = __float2bfloat16_rn(lo);
      if (c == nc - 1 && at[i] >= 0) {
        h_final[(static_cast<size_t>(b) * H + h) * PN + at[i]] =
            hv[i] * dec[c * H] + st[c * c_stride + at[i]];
      }
    }
  }
  chunk_cumsum(dt_s, cs_s, sums, A[h], Qp, tid);
  tc::cp_async_wait<0>();
  __syncthreads();

  const int i0 = warp * 16;
  if (i0 >= Qp) return;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int pt_n = Pp / 8, nk_n = Np / 16;
  uint32_t cf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if (kk < nk_n) {
      tc::ldmatrix_x4(cf[kk], c_s + (i0 + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8);
    }
  }
  float acc[PT][4];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[pt][e] = 0.0f;
  const float cs_r[2] = {cs_s[i0 + g4], cs_s[i0 + g4 + 8]};

  // carried state: acc = exp(cs_i)·C_i·h_cᵀ
  if (c > 0) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk >= nk_n) continue;
#pragma unroll
      for (int pt = 0; pt < PT; pt += 2) {
        if (pt >= pt_n) continue;
        uint32_t bh[4], bl[4];
        const int off =
            (pt * 8 + (lane & 7) + (lane >> 4) * 8) * LDN + kk * 16 + ((lane >> 3) & 1) * 8;
        tc::ldmatrix_x4(bh, hh_s + off);
        tc::ldmatrix_x4(bl, hl_s + off);
        tc::mma_bf16(acc[pt], cf[kk], bh[0], bh[1]);
        tc::mma_bf16(acc[pt], cf[kk], bl[0], bl[1]);
        tc::mma_bf16(acc[pt + 1], cf[kk], bh[2], bh[3]);
        tc::mma_bf16(acc[pt + 1], cf[kk], bl[2], bl[3]);
      }
    }
    const float ea[2] = {expf(cs_r[0]), expf(cs_r[1])};
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pt][e] *= ea[e >> 1];
  }

  // intra-chunk: acc += (C·Bᵀ ⊙ L ⊙ dt)·x over the key blocks up to the diagonal
  for (int kk = 0; kk <= warp; ++kk) {
    float s0f[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s1f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int nk = 0; nk < NK; ++nk) {
      if (nk >= nk_n) continue;
      uint32_t bq[4];
      tc::ldmatrix_x4(bq, b_s + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LDN + nk * 16 +
                              ((lane >> 3) & 1) * 8);
      tc::mma_bf16(s0f, cf[nk], bq[0], bq[1]);
      tc::mma_bf16(s1f, cf[nk], bq[2], bq[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g4 + (e >> 1) * 8;
      const int j0 = kk * 16 + 2 * t4 + (e & 1);
      const int j1 = j0 + 8;
      s0f[e] = j0 <= i ? s0f[e] * expf(cs_r[e >> 1] - cs_s[j0]) * dt_s[j0] : 0.0f;
      s1f[e] = j1 <= i ? s1f[e] * expf(cs_r[e >> 1] - cs_s[j1]) * dt_s[j1] : 0.0f;
    }
    uint32_t ah[4], al[4];
    tc::split_fragment(s0f, s1f, ah, al);
#pragma unroll
    for (int pt = 0; pt < PT; pt += 2) {
      if (pt >= pt_n) continue;
      uint32_t bx[4];
      tc::ldmatrix_x4_trans(bx, x_s + (kk * 16 + (lane & 15)) * LDP + pt * 8 + (lane >> 4) * 8);
      tc::mma_bf16(acc[pt], ah, bx[0], bx[1]);
      tc::mma_bf16(acc[pt], al, bx[0], bx[1]);
      tc::mma_bf16(acc[pt + 1], ah, bx[2], bx[3]);
      tc::mma_bf16(acc[pt + 1], al, bx[2], bx[3]);
    }
  }

  // y = acc + D·x, rounded to bf16
  const float d_h = Dv[h];
  const bool pairs = (P & 1) == 0;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int i = i0 + g4 + r2 * 8;
    if (i >= valid) continue;
    bf16* yr = y + (first + i) * xrow + static_cast<size_t>(h) * P;
    const bf16* xr = x_s + i * LDP;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      const int p = pt * 8 + 2 * t4;
      if (pt >= pt_n || p >= P) continue;
      const float v0 = acc[pt][2 * r2] + d_h * __bfloat162float(xr[p]);
      const float v1 = acc[pt][2 * r2 + 1] + d_h * __bfloat162float(xr[p + 1]);
      if (pairs) {
        *reinterpret_cast<uint32_t*>(yr + p) = tc::pack_bf16(v0, v1);
      } else {
        yr[p] = __float2bfloat16_rn(v0);
        if (p + 1 < P) yr[p + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int PW, int NW>
int launch_output(const bf16* x, const float* dt, const float* A, const bf16* B, const bf16* C,
                  const float* D, const float* states, const float* decays, bf16* y,
                  float* h_final, int Bt, int S, int H, int P, int G, int N, int Q, int nc,
                  int vec_x, int vec_b, cudaStream_t stream) {
  const CpGeometry geo = cp_geometry(Q, P, N);
  auto kernel = ssd_chunk_output_kernel<PW, NW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(geo.out_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nc, H, Bt), kCpThreads, geo.out_bytes, stream>>>(
      x, dt, A, B, C, D, states, decays, y, h_final, S, H, P, G, N, Q, vec_x, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// Two launches: the chunk states into `scratch` (Bt·nc·H·P·N floats, then
// Bt·nc·H decays), then the outputs.
int launch_chunked(const bf16* x, const float* dt, const float* A, const bf16* B, const bf16* C,
                   const float* D, bf16* y, float* h_final, float* scratch, int Bt, int S, int H,
                   int P, int G, int N, int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  float* states = scratch;
  float* decays = scratch + static_cast<size_t>(Bt) * nc * H * P * N;
  const int vec_x = P % 8 == 0 && aligned16(x);
  const int vec_b = N % 8 == 0 && aligned16(B) && aligned16(C);
  const CpGeometry geo = cp_geometry(Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(geo.state_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_state_kernel<<<dim3(nc, H, Bt), kCpThreads, geo.state_bytes, stream>>>(
      x, dt, A, B, states, decays, S, H, P, G, N, Q, vec_x, vec_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool wide_p = geo.Pp > 64, wide_n = geo.Np > 64;
#define SSD_OUTPUT(pw, nw)                                                                    \
  launch_output<pw, nw>(x, dt, A, B, C, D, states, decays, y, h_final, Bt, S, H, P, G, N, Q, \
                        nc, vec_x, vec_b, stream)
  if (wide_p) return wide_n ? SSD_OUTPUT(128, 128) : SSD_OUTPUT(128, 64);
  return wide_n ? SSD_OUTPUT(64, 128) : SSD_OUTPUT(64, 64);
#undef SSD_OUTPUT
}

// ---- bfloat16 on Hopper: one launch, a cluster of blocks per head ----

constexpr int kHopQ = 128;        // chunk rows (the kernel takes chunk 128 only)
constexpr int kHopThreads = 256;  // two warpgroups
constexpr int kMaxCluster = 8;    // blocks a cluster holds (the portable cluster size)
constexpr int kRegion = kHopQ * 128;  // a 64-column region of a Q-row tile: Q rows of 128 bytes

// The launch's own error code for a cluster the card cannot schedule (no
// cluster of that many blocks with this much shared memory fits).
constexpr int kErrCluster = 30000;

// Shared layout (bytes from a 1024-aligned base).  x, C and B as TMA wrote
// them: 64-column regions of Q rows x 128 bytes, 128-byte swizzle.  Once
// the block's own products have read B, its region takes the state that
// enters the chunk, h (P x N, K-major for C·hᵀ: N/64 regions of P rows x
// 128 bytes), as bf16 high then low parts, written there by the
// cluster's blocks.  The weighted x's high and low parts (the layout of x)
// later hold the chunk's own float32 state (P x N, pairs swizzled), which
// the cluster's blocks read.  Then the float32 h that this block's
// threads carry from one group of chunks to the next (the eighth of the
// P·N elements the block owns), dt, cs, w, k = log2(dt) - cs·log2(e), the
// scan's warp sums, the chunk's decay and two mbarriers: x, B and C
// landed; h landed.
template <int P, int N>
struct HopSsd {
  static constexpr uint32_t kX = kHopQ * P * 2;
  static constexpr uint32_t kBC = kHopQ * N * 2;
  static constexpr uint32_t kH = 2 * P * N * 2;
  static constexpr uint32_t kBH = kBC > kH ? kBC : kH;
  static constexpr uint32_t kWX = 2 * kX;
  static constexpr uint32_t kCarry = P * N * 4 / kMaxCluster;
  static constexpr uint32_t kXOff = 0;
  static constexpr uint32_t kCOff = kXOff + kX;
  static constexpr uint32_t kBOff = kCOff + kBC;
  static constexpr uint32_t kWXOff = kBOff + kBH;
  static constexpr uint32_t kCarryOff = kWXOff + kWX;
  static constexpr uint32_t kVecOff = kCarryOff + kCarry;
  static constexpr uint32_t kBarOff = kVecOff + (4 * kHopQ + 8 + 2) * 4;
  static constexpr size_t kSmem = kBarOff + 16 + 1024;  // 1 KB to align the base
  static constexpr uint32_t kTxBytes = kX + 2 * kBC;
  static_assert(P % 64 == 0 && N % 64 == 0, "whole 64-column regions");
  static_assert(P * N * 4 <= kWX, "the state fits where the weighted x was");
};

// Byte offset of element (row r, column col) in a tile of 64-column regions
// of `rows` rows x 128 bytes with the 128-byte swizzle (16-byte chunk k of
// row r at chunk k ^ (r % 8)).
__device__ __forceinline__ uint32_t sw128(int r, int col, int rows) {
  return static_cast<uint32_t>((col >> 6) * rows * 128 + r * 128 +
                               ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2);
}

// The float32 state's pair (p, cp) (columns 2cp, 2cp + 1), in float2
// units: rows of N / 2 pairs, the pair index XOR-ed with 4·(p % 8) so that
// a warp's stores of its accumulator fragments spread over the banks.
template <int N>
__device__ __forceinline__ uint32_t state_pair(int p, int cp) {
  return static_cast<uint32_t>(p * (N / 2) + (cp ^ ((p & 7) << 2)));
}

// Two floats split into bf16 hi (round to nearest) and lo = bf16(v - hi),
// each pair packed, the lower column in the low half: tc::split_bf16's
// roundings, two values an instruction where it can.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

using hopper::exp2_ftz;
using hopper::kLog2e;

// One warpgroup's work on one group of chunks: rows 64·wg .. 64·wg + 63
// of chunk c against keys 0 .. KEYS - 1 (KEYS = 64 for rows 0-63, which
// need no later key; 128 for rows 64-127), the state's rows 64·wg' .. (P =
// 128: both warpgroups; P = 64: the lighter warpgroup 0 alone), the cluster's
// exchange over the group's chunks, from chunk `first` on, and the
// outputs.  `h_parity` is the phase of the h barrier this chunk waits
// for; `last` marks the last group, after which the owners write h_final.
template <int P, int N, int KEYS>
__device__ __forceinline__ void ssd_hopper_group(unsigned char* sm, uint32_t base, int tid, int c,
                                                 int first, bool last, uint32_t h_parity, int b,
                                                 int h, int S, int H, int valid, float d_h,
                                                 bf16* __restrict__ y, float* __restrict__ h_final) {
  using L = HopSsd<P, N>;
  constexpr bool kState = P == 128 || KEYS == 64;
  constexpr int wg = KEYS == 64 ? 0 : 1;
  constexpr int wr = P == 128 ? wg : 0;  // the 64 state rows this group computes
  const float* dt_s = reinterpret_cast<const float*>(sm + L::kVecOff);
  const float* cs_s = dt_s + kHopQ;
  const float* k_s = cs_s + 2 * kHopQ;  // log2(dt_j) - cs_j·log2(e)
  float* decay_s = const_cast<float*>(k_s) + kHopQ + 8;
  float4* carry_s = reinterpret_cast<float4*>(sm + L::kCarryOff);
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31, g4 = lane >> 2, t4 = lane & 3;
  const int row0 = 64 * wg + 16 * warp + g4;  // this thread's rows: row0, row0 + 8
  const uint32_t x_s = base + L::kXOff, c_s = base + L::kCOff, b_s = base + L::kBOff;
  const uint32_t wx_s = base + L::kWXOff;
  const uint32_t hh_s = b_s, hl_s = b_s + P * N * 2;
  const uint32_t h_bar = base + L::kBarOff + 8;
  const uint32_t sw_hi = hopper::desc_hi(1024, 1);  // 8-row groups 1024 bytes apart, 128-byte swizzle
  // k-step kk of a K-major operand: column region (16 kk) / 64, then 32
  // bytes a step within it
  auto kmaj = [](uint32_t tile, int kk, int rows) -> uint32_t {
    return tile + static_cast<uint32_t>((kk * 16 >> 6) * rows * 128 + (kk * 16 & 63) * 2);
  };

  // S = C·Bᵀ (both K-major, as Q·Kᵀ) and the state (w ⊙ x)ᵀ·B (both
  // MN-major: A is the weighted x, P along its rows' columns; B is B, N
  // along them), hi then lo
  float s[KEYS / 2];
  float st[kState ? N / 2 : 1];
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    hopper::WgmmaSS<KEYS>::run(s, hopper::desc(hopper::desc_lo(kmaj(c_s + 64 * wg * 128, kk, kHopQ), 16), sw_hi),
                               hopper::desc(hopper::desc_lo(kmaj(b_s, kk, kHopQ), 16), sw_hi), kk > 0);
  if constexpr (kState) {
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const uint32_t a_tile = wx_s + part * L::kX + wr * kRegion;
#pragma unroll
      for (int kk = 0; kk < kHopQ / 16; ++kk)
        hopper::WgmmaSS<N, 1, 1>::run(st, hopper::desc(hopper::desc_lo(a_tile + kk * 2048, kRegion), sw_hi),
                                      hopper::desc(hopper::desc_lo(b_s + kk * 2048, kRegion), sw_hi),
                                      part > 0 || kk > 0);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  if constexpr (kState) hopper::fence_regs(st);

  // the state, float32, where the weighted x was: once both groups' products
  // have read it (P = 128)
  if constexpr (P == 128) hopper::named_bar_sync<1>(kHopThreads);
  if constexpr (kState) {
    float2* st_s = reinterpret_cast<float2*>(sm + L::kWXOff);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
        st_s[state_pair<N>(64 * wr + 16 * warp + g4 + 8 * r2, 4 * j + t4)] =
            make_float2(st[4 * j + 2 * r2], st[4 * j + 2 * r2 + 1]);
  }
  if (tid == 0) *decay_s = expf(cs_s[kHopQ - 1]);
  // This block is done with B, whose region the cluster's blocks may now
  // fill with h, and its state is in place for them to read.
  hopper::cluster_arrive();

  // The recurrence h_{c+1} = decay_c·h_c + state_c, in float32 and in the
  // plain version's order, element-wise, by warpgroup 0 (whose intra-chunk
  // work is the lighter) while warpgroup 1 runs its intra-chunk product:
  // the cluster's blocks split the P·N elements in fours, each block owning
  // the same elements in every group of chunks.  The owner starts from the
  // h it carried out of the previous group of chunks (zero in the first),
  // reads its elements' states from the cluster's blocks, stores each
  // block's h_c, as bf16 hi and lo in its K-major layout, into that block's
  // shared memory (st.async, whose bytes complete on that block's h
  // barrier), and keeps h after the group's last chunk: in its carry, or,
  // after the last group, as h_final.  Warpgroup 0 issues the loads of its
  // first four elements, scales its S and issues its Y while they are in
  // flight, then finishes the recurrence while Y runs.  Both warpgroups
  // then arrive at the second cluster barrier (relaxed: it orders reads),
  // whose wait, at the end, keeps this block's state and decay in place
  // until every block is done with them, before the next group of chunks
  // overwrites them.
  const int K = static_cast<int>(gridDim.x);  // blocks in the cluster
  const uint32_t rank = hopper::cluster_ctarank();
  float dec[kMaxCluster];
  float4 sv[kMaxCluster];
  auto load_states = [&](int e4) {
    const int p = e4 / (N / 4), n = 4 * (e4 % (N / 4));
    const uint32_t so = state_pair<N>(p, n / 2) * 8;  // pairs n/2 and n/2 + 1: 16 bytes
#pragma unroll
    for (int cc = 0; cc < kMaxCluster; ++cc)
      if (cc < K) sv[cc] = hopper::ld_cluster_f32x4(hopper::mapa(wx_s + so, cc));
  };
  auto finish_states = [&](int e4, int own) {
    const int p = e4 / (N / 4), n = 4 * (e4 % (N / 4));
    const uint32_t ho = sw128(p, n, P);
    float4 hv = first > 0 ? carry_s[own * 128 + wt] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int cc = 0; cc < kMaxCluster; ++cc) {
      if (cc >= K) break;
      if (first + cc > 0) {
        uint32_t hi[2], lo[2];
        split2(hv.x, hv.y, hi[0], lo[0]);
        split2(hv.z, hv.w, hi[1], lo[1]);
        const uint32_t bar_cc = hopper::mapa(h_bar, cc);
        hopper::st_async_u32x2(hopper::mapa(hh_s + ho, cc), hi[0], hi[1], bar_cc);
        hopper::st_async_u32x2(hopper::mapa(hl_s + ho, cc), lo[0], lo[1], bar_cc);
      }
      hv.x = hv.x * dec[cc] + sv[cc].x;
      hv.y = hv.y * dec[cc] + sv[cc].y;
      hv.z = hv.z * dec[cc] + sv[cc].z;
      hv.w = hv.w * dec[cc] + sv[cc].w;
    }
    if (last) {
      *reinterpret_cast<float4*>(h_final + ((static_cast<size_t>(b) * H + h) * P + p) * N + n) = hv;
    } else {
      carry_s[own * 128 + wt] = hv;
    }
  };
  const int e4_first = static_cast<int>(rank) * 128 + wt;
  if constexpr (wg == 0) {
    hopper::cluster_wait();
#pragma unroll
    for (int cc = 0; cc < kMaxCluster; ++cc)
      dec[cc] = cc < K ? hopper::ld_cluster_f32(hopper::mapa(hopper::smem_addr(decay_s), cc)) : 0.0f;
    if (e4_first < P * N / 4) load_states(e4_first);
  }

  // the intra-chunk term: Y = (S ⊙ L ⊙ dt)·x, L_ij = exp(cs_i - cs_j) for
  // j <= i, each factor one exp2: L_ij·dt_j = 2^(cs_i·log2(e) + k_j).  A
  // warp's rows are 16w' .. 16w' + 15 of the group's: key blocks of 8 after
  // its last row are zero, those before its first row need no mask.  S is
  // split into bf16 hi and lo pairs, the A fragments as they stand.
  const float csl[2] = {cs_s[row0] * kLog2e, cs_s[row0 + 8] * kLog2e};
  const int warp_first = 64 * wg + 16 * warp;
  uint32_t ah[KEYS / 4], al[KEYS / 4];
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    if (8 * j > warp_first + 15) {
      ah[2 * j] = ah[2 * j + 1] = al[2 * j] = al[2 * j + 1] = 0u;
      continue;
    }
    const float2 kj = *reinterpret_cast<const float2*>(k_s + 8 * j + 2 * t4);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = s[4 * j + e] * exp2_ftz(csl[e >> 1] + ((e & 1) ? kj.y : kj.x));
    if (8 * j + 7 >= warp_first) {  // the diagonal block: keys after the row are 0
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t4 + (e & 1) > row0 + 8 * (e >> 1)) v[e] = 0.0f;
    }
    split2(v[0], v[1], ah[2 * j], al[2 * j]);
    split2(v[2], v[3], ah[2 * j + 1], al[2 * j + 1]);
  }
  float yacc[P / 2];
#pragma unroll
  for (int i = 0; i < P / 2; ++i) yacc[i] = 0.0f;
  hopper::fence_regs(yacc);
  hopper::fence_regs(ah);
  hopper::fence_regs(al);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    const uint64_t xd = hopper::desc(hopper::desc_lo(x_s + kk * 2048, kRegion), sw_hi);
    hopper::WgmmaRS<P>::run(yacc, ah[4 * kk], ah[4 * kk + 1], ah[4 * kk + 2], ah[4 * kk + 3], xd);
    hopper::WgmmaRS<P>::run(yacc, al[4 * kk], al[4 * kk + 1], al[4 * kk + 2], al[4 * kk + 3], xd);
  }
  hopper::wgmma_commit();
  if constexpr (wg == 0) {
    if (e4_first < P * N / 4) finish_states(e4_first, 0);
    int own = 1;
    for (int e4 = e4_first + K * 128; e4 < P * N / 4; e4 += K * 128, ++own) {
      load_states(e4);
      finish_states(e4, own);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(yacc);
  hopper::fence_regs(ah);
  hopper::fence_regs(al);
  if constexpr (wg == 1) hopper::cluster_wait();
  hopper::cluster_arrive_relaxed();

  // the carried state, once its P·N·4 bytes have landed: Z = C·h_cᵀ (both
  // K-major), hi then lo; none in chunk 0
  float zacc[P / 2];
#pragma unroll
  for (int i = 0; i < P / 2; ++i) zacc[i] = 0.0f;
  if (c > 0) {
    hopper::mbar_wait(h_bar, h_parity);
    hopper::fence_proxy_async_cta();
    hopper::fence_regs(zacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t cd = hopper::desc(hopper::desc_lo(kmaj(c_s + 64 * wg * 128, kk, kHopQ), 16), sw_hi);
      hopper::WgmmaSS<P>::run(zacc, cd, hopper::desc(hopper::desc_lo(kmaj(hh_s, kk, P), 16), sw_hi), kk > 0);
      hopper::WgmmaSS<P>::run(zacc, cd, hopper::desc(hopper::desc_lo(kmaj(hl_s, kk, P), 16), sw_hi), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(zacc);
  }

  // y = Y + exp(cs_i)·Z + D·x, rounded to bf16
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int i = row0 + 8 * r2;
    if (i >= valid) continue;
    const float ea = expf(cs_s[i]);
    bf16* yr = y + ((static_cast<size_t>(b) * S + c * kHopQ + i) * H + h) * P;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const int p = 8 * j + 2 * t4;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sm + L::kXOff + sw128(i, p, kHopQ)));
      const float v0 = yacc[4 * j + 2 * r2] + zacc[4 * j + 2 * r2] * ea + xv.x * d_h;
      const float v1 = yacc[4 * j + 2 * r2 + 1] + zacc[4 * j + 2 * r2 + 1] * ea + xv.y * d_h;
      *reinterpret_cast<uint32_t*>(yr + p) = tc::pack_bf16(v0, v1);
    }
  }
  hopper::cluster_wait();
}

// One block per (cluster rank, head, batch row); the blocks of a (batch
// row, head) form one cluster of K = min(nc, 8) along the chunks, and the
// block of rank r takes chunks r, r + K, r + 2K, ...: the cluster walks
// the chunks in groups of K, one group after another, and its blocks carry
// the state across groups (`ssd_hopper_group`).  Where nc is not a
// multiple of K, the last group's later blocks take chunks past the end:
// TMA fills their x, B and C with zeros and dt is 0 there, so their state
// is 0 and their decay exp(0) = 1, which leaves h as it was (h·1 + 0 is
// exact), and they store no y.  For each of its chunks, 256 threads:
// thread 0 issues the TMA loads of x, B and C, all threads build the
// weighted x, then each warpgroup runs `ssd_hopper_group`; the next
// group's dt is loaded under the group's work.  kWalk = false (nc <= 8)
// fixes one group at compile time: the walk's loop and carry fold away,
// and with them registers that the one-group calls, every main-path call
// at 1024 tokens, would otherwise pay (tools/ssd_trace.py --ab: at
// zamba2's serve shape the walk spills 192 bytes a thread and takes
// 0.0365 against 0.0332 ms on an NVIDIA H100 80GB HBM3 at 700 W).  Two blocks share an SM
// at P = N = 64 (85 KB of shared memory, 128 registers a thread).
template <int P, int N, bool kWalk>
__global__ void __launch_bounds__(kHopThreads, P == 64 && N == 64 ? 2 : 1)
ssd_scan_hopper_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                       const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ dt,
                       const float* __restrict__ A, const float* __restrict__ Dv, bf16* __restrict__ y,
                       float* __restrict__ h_final, int S, int H, int G) {
  using L = HopSsd<P, N>;
  extern __shared__ __align__(16) unsigned char ssd_hop_raw[];
  const uint32_t raw = hopper::smem_addr(ssd_hop_raw);
  unsigned char* sm = ssd_hop_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = hopper::smem_addr(sm);
  float* dt_s = reinterpret_cast<float*>(sm + L::kVecOff);
  float* cs_s = dt_s + kHopQ;
  float* w_s = cs_s + kHopQ;
  float* k_s = w_s + kHopQ;
  float* sums = k_s + kHopQ;
  const uint32_t bar = base + L::kBarOff;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int K = gridDim.x;  // the cluster's size
  const int nc = (S + kHopQ - 1) / kHopQ;
  const int n_groups = kWalk ? (nc + K - 1) / K : 1;
  const int g = h / (H / G);
  // dt of row `tid` of chunk c (0 past S)
  auto load_dt = [&](int c) -> float {
    const int s = c * kHopQ + tid;
    return tid < kHopQ && s < S ? dt[(static_cast<size_t>(b) * S + s) * H + h] : 0.0f;
  };
  // the global loads first, their latency under the barriers' set-up
  float dt_t = load_dt(rank);
  const float a_h = A[h], d_h = Dv[h];

  if (tid == 0) {
    hopper::prefetch_tensormap(&tm_x);
    hopper::prefetch_tensormap(&tm_b);
    hopper::prefetch_tensormap(&tm_c);
    hopper::mbar_init(bar, 1);
    hopper::mbar_init(bar + 8, 1);
    hopper::mbar_init_fence();
  }
  // warp-uniform, so that each group's branch is taken by whole warps
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  for (int grp = 0; grp < n_groups; ++grp) {
    const int first = grp * K;
    const int c = first + rank;
    const int s0 = c * kHopQ;
    const int valid = min(kHopQ, S - s0);  // at most 0 past the end
    // the barriers are initialised, and every thread is done with the
    // previous group's x, C, dt and cs (its stores of y read them after
    // the cluster barrier's arrival)
    __syncthreads();
    if (tid == 0) {
      // h, from the cluster's blocks: P·N bf16 high and low parts
      if (c > 0) hopper::mbar_expect_tx(bar + 8, P * N * 4);
      // the previous group's generic reads of x and C before TMA rewrites them
      if (grp > 0) hopper::fence_proxy_async_cta();
      // rows past S come back as zeros: x = B = C = 0 there
      hopper::mbar_expect_tx(bar, L::kTxBytes);
#pragma unroll
      for (int r = 0; r < P / 64; ++r)
        hopper::tma_load_4d(base + L::kXOff + r * kRegion, &tm_x, bar, 64 * r, h, s0, b);
#pragma unroll
      for (int r = 0; r < N / 64; ++r) {
        hopper::tma_load_4d(base + L::kBOff + r * kRegion, &tm_b, bar, 64 * r, g, s0, b);
        hopper::tma_load_4d(base + L::kCOff + r * kRegion, &tm_c, bar, 64 * r, g, s0, b);
      }
    }
    if (tid < kHopQ) dt_s[tid] = dt_t;
    if (grp + 1 < n_groups) dt_t = load_dt(c + K);
    chunk_cumsum(dt_s, cs_s, sums, a_h, kHopQ, tid);
    if (tid < kHopQ) {
      w_s[tid] = expf(cs_s[kHopQ - 1] - cs_s[tid]) * dt_s[tid];
    } else {
      const int j = tid - kHopQ;  // log2(0) = -inf: a padded key's factor is 0
      k_s[j] = __log2f(dt_s[j]) - cs_s[j] * kLog2e;
    }
    __syncthreads();
    hopper::mbar_wait(bar, grp & 1);

    // the weighted x w_j·x_j, split into bf16 hi + lo, in x's layout
#pragma unroll
    for (int k = tid; k < kHopQ * P / 8; k += kHopThreads) {
      const uint32_t off = k * 16;
      const float wj = w_s[(off % kRegion) >> 7];
      const uint4 v = *reinterpret_cast<const uint4*>(sm + L::kXOff + off);
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[q]));
        split2(wj * xf.x, wj * xf.y, hi[q], lo[q]);
      }
      *reinterpret_cast<uint4*>(sm + L::kWXOff + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sm + L::kWXOff + L::kX + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    hopper::fence_proxy_async_cta();
    __syncthreads();

    const bool last = grp == n_groups - 1;
    const uint32_t h_parity = (c > 0 ? grp - (rank == 0) : 0) & 1;  // h phases waited for before this one
    if (wg == 0) {
      ssd_hopper_group<P, N, 64>(sm, base, tid, c, first, last, h_parity, b, h, S, H, valid, d_h, y, h_final);
    } else {
      ssd_hopper_group<P, N, 128>(sm, base, tid, c, first, last, h_parity, b, h, S, H, valid, d_h, y, h_final);
    }
  }
}

// The launch of the Hopper kernel at widths (P, N): a grid of (K, H, Bt)
// blocks in clusters of K = min(nc, 8) along the chunks.
struct HopperLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  HopperLaunch(size_t smem, int K, int H, int Bt, cudaStream_t stream) {
    cfg.gridDim = dim3(K, H, Bt);
    cfg.blockDim = dim3(kHopThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of K blocks of the Hopper kernel the card holds at once, after
// setting its shared-memory attribute, or minus a CUDA error code.
template <int P, int N, bool kWalk>
int hopper_clusters(int K) {
  using L = HopSsd<P, N>;
  auto kernel = ssd_scan_hopper_kernel<P, N, kWalk>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kSmem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  HopperLaunch launch(L::kSmem, K, 1, 1, nullptr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

constexpr int kMaxDevices = 64;

template <int P, int N>
int launch_hopper(const bf16* x, const float* dt, const float* A, const bf16* B, const bf16* C,
                  const float* D, bf16* y, float* h_final, int Bt, int S, int H, int G,
                  cudaStream_t stream) {
  using L = HopSsd<P, N>;
  const int nc = (S + kHopQ - 1) / kHopQ;
  const int K = nc < kMaxCluster ? nc : kMaxCluster;
  const bool walk = nc > K;
  if (!aligned16(x) || !aligned16(B) || !aligned16(C)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_b, tm_c;
  int err = hopper::encode_map(&tm_x, x, Bt, S, H, P, 64, kHopQ, 128);
  if (err == 0) err = hopper::encode_map(&tm_b, B, Bt, S, G, N, 64, kHopQ, 128);
  if (err == 0) err = hopper::encode_map(&tm_c, C, Bt, S, G, N, 64, kHopQ, 128);
  if (err != 0) return err;
  // the cluster check, once a (device, cluster size, kernel): at least one
  // cluster of K blocks fits on the card
  static bool checked[kMaxDevices][kMaxCluster + 1][2] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= kMaxDevices || !checked[device][K][walk]) {
    const int clusters = walk ? hopper_clusters<P, N, true>(K) : hopper_clusters<P, N, false>(K);
    if (clusters < 0) return -clusters;
    if (clusters < 1) return kErrCluster;
    if (device < kMaxDevices) checked[device][K][walk] = true;
  }
  HopperLaunch launch(L::kSmem, K, H, Bt, stream);
  e = walk ? cudaLaunchKernelEx(&launch.cfg, ssd_scan_hopper_kernel<P, N, true>, tm_x, tm_b, tm_c, dt, A, D, y,
                                h_final, S, H, G)
           : cudaLaunchKernelEx(&launch.cfg, ssd_scan_hopper_kernel<P, N, false>, tm_x, tm_b, tm_c, dt, A, D, y,
                                h_final, S, H, G);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool hopper_widths(int P, int N) { return (P == 64 || P == 128) && (N == 64 || N == 128); }

size_t hopper_smem(int P, int N) {
  return P == 64 ? (N == 64 ? HopSsd<64, 64>::kSmem : HopSsd<64, 128>::kSmem)
                 : (N == 64 ? HopSsd<128, 64>::kSmem : HopSsd<128, 128>::kSmem);
}

int dispatch_hopper(const bf16* x, const float* dt, const float* A, const bf16* B, const bf16* C,
                    const float* D, bf16* y, float* hf, int Bt, int S, int H, int P, int G, int N,
                    cudaStream_t st) {
  if (P == 64 && N == 64) return launch_hopper<64, 64>(x, dt, A, B, C, D, y, hf, Bt, S, H, G, st);
  if (P == 64 && N == 128) return launch_hopper<64, 128>(x, dt, A, B, C, D, y, hf, Bt, S, H, G, st);
  if (P == 128 && N == 64) return launch_hopper<128, 64>(x, dt, A, B, C, D, y, hf, Bt, S, H, G, st);
  if (P == 128 && N == 128) return launch_hopper<128, 128>(x, dt, A, B, C, D, y, hf, Bt, S, H, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int PC, int NC>
int launch_f32(const float* x, const float* dt, const float* A, const float* B, const float* C,
               const float* D, float* y, float* h_final, int Bt, int S, int H, int P, int G,
               int N, int Q, cudaStream_t stream) {
  const Geometry geo = geometry(Q, P, N, PC);
  auto kernel = ssd_scan_f32_kernel<PC, NC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(geo.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Bt);
  kernel<<<grid, kThreads, geo.bytes, stream>>>(x, dt, A, B, C, D, y, h_final, S, H, P, G, N, Q);
  return static_cast<int>(cudaGetLastError());
}

int groups(int v) { return v <= 32 ? 1 : v <= 64 ? 2 : v <= 128 ? 4 : 0; }

template <int PC>
int dispatch_n(int NC, const float* x, const float* dt, const float* A, const float* B,
               const float* C, const float* D, float* y, float* hf, int Bt, int S, int H, int P,
               int G, int N, int Q, cudaStream_t st) {
  switch (NC) {
    case 1: return launch_f32<PC, 1>(x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    case 2: return launch_f32<PC, 2>(x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    case 4: return launch_f32<PC, 4>(x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_f32(const float* x, const float* dt, const float* A, const float* B, const float* C,
                 const float* D, float* y, float* hf, int Bt, int S, int H, int P, int G, int N,
                 int Q, cudaStream_t st) {
  const int NC = groups(N);
  switch (groups(P)) {
    case 1: return dispatch_n<1>(NC, x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    case 2: return dispatch_n<2>(NC, x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    case 4: return dispatch_n<4>(NC, x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernels, as the wrapper's `kernel_path` names them: 0 "cuda_core"
// (float32), 1 "mma_sync" (bf16, two launches), 2 "wgmma_tma" (bf16, one
// launch of clusters of up to 8 blocks that walk any number of chunks;
// chunk 128, P and N 64 or 128, 16-byte aligned x, B and C).
enum Path { kCudaCore = 0, kMmaSync = 1, kWgmmaTma = 2 };

}  // namespace

// Shared-memory bytes one block of the kernel `path` needs (0 for a shape
// the path does not take), so the wrapper can refuse a shape before
// launching.
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N, int path) {
  const int PC = groups(P);
  if (PC == 0 || groups(N) == 0) return 0;
  if (path == kWgmmaTma) {
    return Q == kHopQ && hopper_widths(P, N) ? static_cast<long long>(hopper_smem(P, N)) : 0;
  }
  if (path == kMmaSync) {
    const CpGeometry geo = cp_geometry(Q, P, N);
    return static_cast<long long>(geo.out_bytes > geo.state_bytes ? geo.out_bytes
                                                                   : geo.state_bytes);
  }
  if (path == kCudaCore) return static_cast<long long>(geometry(Q, P, N, PC).bytes);
  return 0;
}

// Clusters of the wgmma_tma kernel at widths (P, N) for `nc` chunks (each
// of min(nc, 8) blocks) that the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int ssd_scan_hopper_clusters(int P, int N, int nc, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (nc < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const int K = nc < kMaxCluster ? nc : kMaxCluster;
#define SSD_CLUSTERS(p, n) (nc > K ? hopper_clusters<p, n, true>(K) : hopper_clusters<p, n, false>(K))
  if (P == 64 && N == 64) return SSD_CLUSTERS(64, 64);
  if (P == 64 && N == 128) return SSD_CLUSTERS(64, 128);
  if (P == 128 && N == 64) return SSD_CLUSTERS(128, 64);
  if (P == 128 && N == 128) return SSD_CLUSTERS(128, 128);
#undef SSD_CLUSTERS
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry for ctypes.  `path` picks the kernel (above; x, B, C and y
// are float32 for path 0, bfloat16 otherwise).  Path 1 takes `scratch`,
// Bt·nc·H·(P·N + 1) floats, nc = ceil(S / Q); the others do not use it.
// Returns the CUDA error code of the launches (0 on success), or the
// launch's own codes (hopper.cuh's tensor-map codes, kErrCluster); a shape
// the path does not take (P or N above 128, Q above 128, H not a multiple
// of G; for path 2 also the limits above) returns cudaErrorInvalidValue.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A, const void* B,
                               const void* C, const float* D, void* y, float* h_final,
                               float* scratch, int Bt, int S, int H, int P, int G, int N, int Q,
                               int path, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q < 1 || Q > 128 || G < 1 || H % G != 0 || S < 1 || groups(P) == 0 || groups(N) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == kCudaCore) {
    return dispatch_f32(static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
                        static_cast<const float*>(C), D, static_cast<float*>(y), h_final, Bt, S,
                        H, P, G, N, Q, st);
  }
  if (path == kMmaSync) {
    return launch_chunked(static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B),
                          static_cast<const bf16*>(C), D, static_cast<bf16*>(y), h_final,
                          scratch, Bt, S, H, P, G, N, Q, st);
  }
  if (path == kWgmmaTma && Q == kHopQ) {
    return dispatch_hopper(static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B),
                           static_cast<const bf16*>(C), D, static_cast<bf16*>(y), h_final, Bt, S,
                           H, P, G, N, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
