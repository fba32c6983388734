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
// input 0, which leaves h as the TPU wrapper's zero padding does).
//
// bfloat16 (what serving runs): chunk-parallel, two launches.  The TPU
// kernel carries h along a sequential grid axis; here the chunks of one
// head run in parallel, split as the plain version (ssd_scan_plain) and the
// reference's ssd_chunked split them:
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
// accumulators.  C·Bᵀ has two bf16 operands: one MMA, exact per product.
// The other three have a float32 operand, split as hi + lo with hi =
// bf16(v) and lo = bf16(v - hi) (16 significant bits, relative error
// 2^-18), two MMAs each: the gated scores times x, the weighted x
// (exp(cs_last - cs_j)·dt_j·x_j) times B for the state, and C times h_c.
// Widths are padded to multiples of 16 with zeros in shared memory.  At
// the serve shape the grid is Bt·H·nc = 512 blocks per launch for 132 SMs.
//
// float32 (1e-3 tolerance, exact float32 arithmetic): one block of 256
// threads per (b, h) that loops over the chunks with the (P, N) state in
// shared memory; 32-row tiles of the Q x Q score matrix against their
// causal columns only; products on the CUDA cores.
//
// What bounds it on an H100.  At the serve shape (1, 1024, 64, 64), N = 64,
// G = 1, Q = 128, bf16: x and y 8.4 MB each, B, C, dt and h_final 1.6 MB,
// about 18 MB, 5.5 µs at 3.35 TB/s; 2.16 GFLOP, 2.2 µs at the bf16 rate.
// On an NVIDIA H100 80GB HBM3 at 700.00 W the two launches take 0.074 ms
// there (PERF.md; the sequential kernel, bound by its 64 blocks, took
// 0.464 ms): about 48 µs the output pass and 20 µs the state pass.  Both
// are latency-bound inside a block at 3-4 blocks per SM: staged loads,
// the recurrence's reads of up to 7 earlier states from L2 (issued 16 at
// a time per thread), and the triangular split of the rows over the warps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

}  // namespace

// Shared-memory bytes the kernels need for one block (0 where P or N is
// above 128), so the wrapper can refuse a shape before launching.  dtype 0
// is float32, 1 is bfloat16.
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N, int dtype) {
  const int PC = groups(P);
  if (PC == 0 || groups(N) == 0) return 0;
  if (dtype == 1) {
    const CpGeometry geo = cp_geometry(Q, P, N);
    return static_cast<long long>(geo.out_bytes > geo.state_bytes ? geo.out_bytes
                                                                   : geo.state_bytes);
  }
  return static_cast<long long>(geometry(Q, P, N, PC).bytes);
}

// Plain C entry for ctypes.  dtype 0 is float32 (one launch; `scratch` is
// not used), 1 is bfloat16 (x, B, C and y; two launches, `scratch` holding
// Bt·nc·H·(P·N + 1) floats, nc = ceil(S / Q)).  Returns the CUDA error code
// of the launches (0 on success); a shape the kernels do not take (P or N
// above 128, Q above 128, H not a multiple of G) returns
// cudaErrorInvalidValue.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A, const void* B,
                               const void* C, const float* D, void* y, float* h_final,
                               float* scratch, int Bt, int S, int H, int P, int G, int N, int Q,
                               int dtype, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q < 1 || Q > 128 || G < 1 || H % G != 0 || S < 1 || groups(P) == 0 || groups(N) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_f32(static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
                        static_cast<const float*>(C), D, static_cast<float*>(y), h_final, Bt, S,
                        H, P, G, N, Q, st);
  }
  if (dtype == 1) {
    return launch_chunked(static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B),
                          static_cast<const bf16*>(C), D, static_cast<bf16*>(y), h_final,
                          scratch, Bt, S, H, P, G, N, Q, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
