// Online-softmax attention over (B, S, H, D) tensors, fp32 softmax state.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas body `_kernel`).  For each (b, h) and query row i:
// s_j = (q_i · k_j) · scale, masked to NEG_INF = -2^30 where j >= Sk or
// (causal) j > i; o_i = Σ_j softmax(s)_j v_j.  Positions count from 0 for
// both q and k.  m, l and the accumulator stay float32 until the final
// store, which rounds to the input type; l is clamped to 1e-30 before the
// divide.  Two kernels, picked by dtype:
//
// bfloat16 (what serving runs): tensor-core tiles in the style of
// FlashAttention-2.  One block of 8 warps takes a 128-row query tile of
// one (b, h); each warp owns 16 query rows, so every K and V tile brought
// into shared memory serves 128 rows.  S = Q·Kᵀ and O += P·V are
// mma.sync.m16n8k16 products on bf16 operands with float32 accumulators,
// the operands read from shared memory by ldmatrix (.trans for V).  Q·Kᵀ
// is exact per product, as in the TPU kernel, which widens to float32.
// P is rounded to bf16 before P·V, as FlashAttention-2/3 do (the TPU kernel
// keeps it in float32); l sums the float32 p.  The online softmax (m, l)
// lives in float32 registers on the accumulator fragments: a row's max is
// reduced over its quad of 4 lanes by two xor-shuffles, its sum once at
// the end.  K and V tiles of 64 rows (32 at D = 256, for registers) move
// by 16-byte cp.async into a ring of two stages, the next tile in flight
// while the current one is multiplied.  Shared rows are padded by 16
// bytes, so the 8 rows of each ldmatrix hit distinct banks.  The causal
// key walk stops at the diagonal tile, and blockIdx.x is mapped so that the
// query tiles with the most key tiles start first.  The (B, S, H, D)
// layout is read by strides; ragged ends are zero-filled by the copies and
// masked.  Head dims 64, 80, 128 and 256 (Q in registers up to 128; at 256
// read again from shared memory); 55 KB of shared memory at D = 64, 135 KB
// at D = 256.  mma.sync and not wgmma: at the serve shape the operations
// take 4.3 µs even at the full wgmma rate, against 5.0 µs for the bytes,
// so the instruction is not what limits it, and mma.sync keeps P in
// registers between the two products without a trip through shared memory.
//
// float32 (2e-5 tolerance, which rules out TF32 and bf16 products): one
// block of 256 threads per 64-row query tile, products on the CUDA cores.
// A 16 x 16 thread grid gives thread (ty, tx) query rows 4·ty .. 4·ty + 3,
// keys tx + 16·j and output columns tx + 16·c, so a row's max and sum
// reduce over a 16-lane half warp; Q and K rows padded to D + 1 floats.
//
// What bounds it on an H100.  At the serve shape (1, 1024, 32, 64),
// causal, bf16: 4·S²·H·D/2 = 4.3 GFLOP against 16.8 MB of q, k, v and o:
// 4.3 µs at the bf16 tensor-core rate (989 TFLOP/s), 5.0 µs for the bytes
// at 3.35 TB/s.  On an NVIDIA H100 80GB HBM3 at 700.00 W the bf16 kernel
// takes 0.050 ms there (PERF.md; CUDA-core products took 0.299 ms,
// scaled_dot_product_attention 0.028 ms).  At 338 GB/s and 86 TFLOP/s it
// is bound by neither: all 256 blocks are resident at once, so it lasts as
// long as the heaviest query tiles' 16 key-tile steps in sequence, each
// a chain of mma.sync, softmax and mma.sync; halving the K/V traffic
// (64- to 128-row query tiles) gained only 4%.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, as the TPU kernel

// ---- float32 inputs: CUDA-core products ----

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                           int H, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * DP;
  float* v_s = k_s + kBK * DP;
  float* p_s = v_s + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row = static_cast<size_t>(H) * D;
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;
  float* ob = o + (static_cast<size_t>(b) * Sq * H + h) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int s = q0 + r;
    q_s[r * DP + c] = s < Sq ? qb[s * row + c] : 0.0f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.0f;
  }

  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const int s = k0 + r;
      const bool in = s < Sk;
      k_s[r * DP + c] = in ? kb[s * row + c] : 0.0f;
      v_s[r * D + c] = in ? vb[s * row + c] : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < Sk && (!causal || kj <= qi);
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        mc = fmaxf(mc, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[i], mc);
      const float corr = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(ty * 4 + i) * PP + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = v_s[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c) ob[qi * row + tx + 16 * c] = acc[i][c] / li;
  }
}


// ---- bfloat16 inputs: tensor-core tiles ----

using tc::bf16;

constexpr int kTcThreads = 256;  // 8 warps x 16 query rows
constexpr int kTcBQ = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcTile {
  static constexpr int BK = D <= 128 ? 64 : 32;  // key rows per stage
  static constexpr int LD = D + 8;               // shared row, padded by 16 bytes
  static constexpr bool kQInRegs = D <= 128;
  static constexpr size_t kSmem = sizeof(bf16) * LD * static_cast<size_t>(kTcBQ + 4 * BK);
};

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk,
                            int H, int BH, int n_qt, float scale, int causal, int vec) {
  using Tile = TcTile<D>;
  constexpr int BK = Tile::BK, LD = Tile::LD;
  constexpr int KD = D / 16;  // k-steps of Q·Kᵀ
  constexpr int NS = BK / 8;  // 8-column tiles of S
  constexpr int NO = D / 8;   // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTcBQ * LD;  // two stages of BK rows each
  bf16* v_s = k_s + 2 * BK * LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t4 = lane & 3;
  // heaviest first: the last query tiles have the most key tiles under causal
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qt * kTcBQ;
  const size_t row = static_cast<size_t>(H) * D;
  const bf16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;
  bf16* ob = o + (static_cast<size_t>(b) * Sq * H + h) * D;

  const int k_end = causal ? min(Sk, q0 + kTcBQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  tc::stage_rows(q_s, LD, qb + q0 * row, row, kTcBQ, Sq - q0, D, D, vec, tid, kTcThreads);
  tc::stage_rows(k_s, LD, kb, row, BK, Sk, D, D, vec, tid, kTcThreads);
  tc::stage_rows(v_s, LD, vb, row, BK, Sk, D, D, vec, tid, kTcThreads);
  tc::cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.0f, 0.0f};  // this lane's share of each row's sum
  uint32_t qf[Tile::kQInRegs ? KD : 1][4];
  const int row0 = q0 + warp * 16 + (lane >> 2);  // rows row0 and row0 + 8 of this lane
  const bf16* q_w = q_s + warp * 16 * LD;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // the next tile into the other stage, in flight meanwhile
      const int k1 = (t + 1) * BK;
      tc::stage_rows(k_s + (st ^ 1) * BK * LD, LD, kb + k1 * row, row, BK, Sk - k1, D, D, vec,
                     tid, kTcThreads);
      tc::stage_rows(v_s + (st ^ 1) * BK * LD, LD, vb + k1 * row, row, BK, Sk - k1, D, D, vec,
                     tid, kTcThreads);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    if constexpr (Tile::kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          tc::ldmatrix_x4(qf[kk], q_w + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }

    // S = Q·Kᵀ for this warp's 16 rows against the tile's BK keys
    const bf16* ks = k_s + st * BK * LD;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (Tile::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        tc::ldmatrix_x4(a, q_w + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[j], a, bk[0], bk[1]);
        tc::mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // mask, online softmax on the fragments
    const int k0 = t * BK;
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + warp * 16);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int col = k0 + j * 8 + 2 * t4 + (e & 1);
          if (col >= Sk || (causal && col > row0 + (e >> 1) * 8)) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      corr[i] = exp2f((m_r[i] - m_new) * kLog2e);
      m_r[i] = m_new;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m_r[e >> 1]) * kLog2e);
        s[j][e] = p;
        ps[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + ps[i];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P·V, P rounded to bf16 straight from the S fragments
    const bf16* vs = v_s + st * BK * LD;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]), tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bv[4];
        tc::ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 15)) * LD + n * 8 + (lane >> 4) * 8);
        tc::mma_bf16(acc[n], a, bv[0], bv[1]);
        tc::mma_bf16(acc[n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next copy into it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int r = row0 + i * 8;
    if (r >= Sq) continue;
    bf16* orow = ob + r * row + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          tc::pack_bf16(acc[n][2 * i] / l, acc[n][2 * i + 1] / l);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
               int H, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  auto kernel = flash_attention_f32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const float*>(q),
                                            static_cast<const float*>(k),
                                            static_cast<const float*>(v), static_cast<float*>(o),
                                            Sq, Sk, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                int H, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = TcTile<D>::kSmem;
  auto kernel = flash_attention_bf16_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Sq + kTcBQ - 1) / kTcBQ;
  const long long blocks = static_cast<long long>(n_qt) * B * H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned16(q) && aligned16(k) && aligned16(v);
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, H, B * H, n_qt, scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int dispatch(int D, const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
             int H, float scale, int causal, cudaStream_t st) {
#define FLASH_CASE(d)                                                       \
  case d:                                                                   \
    return kBf16 ? launch_bf16<d>(q, k, v, o, B, Sq, Sk, H, scale, causal, st) \
                 : launch_f32<d>(q, k, v, o, B, Sq, Sk, H, scale, causal, st);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// Plain C entry for ctypes.  dtype 0 is float32, 1 is bfloat16.  Returns
// the CUDA error code of the launch (0 on success); an unsupported head
// dim or dtype returns cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Sk, int H, int D, float scale,
                                      int causal, int dtype, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<false>(D, q, k, v, o, B, Sq, Sk, H, scale, causal, st);
  if (dtype == 1) return dispatch<true>(D, q, k, v, o, B, Sq, Sk, H, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
