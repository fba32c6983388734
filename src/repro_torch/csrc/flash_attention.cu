// Online-softmax attention over (B, S, H, D) tensors, fp32 softmax state.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas body `_kernel`).  For each (b, h) and query row i:
// s_j = (q_i · k_j) · scale, masked to NEG_INF = -2^30 where j >= Sk or
// (causal) j > i; o_i = Σ_j softmax(s)_j v_j.  Positions count from 0 for
// both q and k.  m, l and the accumulator stay float32 until the final
// store, which rounds to the input type; l is clamped to 1e-30 before the
// divide.  Three kernels; the wrapper's `kernel_path` picks one.
//
// bfloat16, head dims 64, 80, 128, 256, 16-byte aligned inputs (every
// main-path call): a Hopper kernel in the shape of FlashAttention-3.
// - Work.  A work item is two 64-row query tiles of one (b, h), the
//   heavier (more key tiles under causal) for consumer warpgroup 1.  The
//   grid has one block an SM (at most one an item) and each block works
//   through its share of the items.  Where all items fit on the SMs at
//   once (moonshot's and gemma-2b's prefills: 128 and 64 items), the
//   heaviest item sets the time, so item j pairs the heaviest tile left
//   with the lightest and every item carries about the same key tiles;
//   otherwise an item takes neighbouring tiles, the heaviest items first,
//   a block taking heavy and light items in turn.
// - Loads.  A block has three warpgroups.  Warpgroup 0 gives its registers
//   to the others (setmaxnreg), and one of its threads loads, by TMA, each
//   item's two query tiles, then its key tiles' K and V into rings of two
//   stages (counted on over the items), each stage guarded by a full and
//   an empty mbarrier, Q by its own pair.  The tensor maps view the
//   (B, S, H, D) tensors as (D, H, S, B), read by strides, in boxes of
//   (SW / 2, 1, rows, 1): 128-byte swizzled boxes of 64 columns for D = 64,
//   128, 256, and 32-byte swizzled boxes of 16 columns for D = 80, whose
//   160-byte rows no 128-byte box holds.  Rows past S come back as zeros
//   and are masked.  The maps are encoded on the host at every call,
//   through libcuda's entry point that the runtime hands out, passed as
//   __grid_constant__.
// - Products.  Warpgroups 1 and 2 each own one query tile of the item.
//   S = Q·Kᵀ is wgmma.m64nBNk16 with both operands K-major in shared
//   memory; P·V is wgmma.m64nDk16 with P from registers: the float32 S
//   fragments, rounded pairwise to bf16, are the A operand as they stand,
//   so P never goes through shared memory; V is the MN-major B operand.  P
//   is rounded to bf16 before P·V, as FlashAttention-2/3 do (the TPU kernel
//   keeps it in float32); l sums the float32 p.  Key tiles are 128 rows (64
//   at D = 256, for registers), so a 1024-token prefill's heaviest query
//   tile takes 8 serial steps (16 with the mma.sync kernel's 64-row tiles).
// - Each step issues Q·K_tᵀ, then tile t-1's P·V, and runs tile t's mask
//   and softmax (ex2.approx, one SFU instruction an element) while P·V
//   still runs; the mask runs only on diagonal and ragged tiles.  The two
//   warpgroups take turns issuing (named barriers).  ptxas (12.9) gave the
//   consumers no more registers for setmaxnreg than the launch bound's 168,
//   so the tiles hold at most about 140 wgmma operand registers a thread.
//
// bfloat16 otherwise (head dim 16, the reduced configs'; inputs that are
// not 16-byte aligned, which no TMA map can describe): tensor-core tiles in
// the style of FlashAttention-2.  One block of 8 warps takes a 128-row
// query tile; each warp owns 16 query rows.  S = Q·Kᵀ and O += P·V are
// mma.sync.m16n8k16 products with float32 accumulators, the operands read
// by ldmatrix (.trans for V); P stays in registers between the two.  K and
// V tiles of 64 rows (32 at D = 256) move by 16-byte cp.async (or element
// by element where the inputs are not 16-byte aligned) into a ring of two
// stages; shared rows are padded by 16 bytes.
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
// at 3.35 TB/s.  The Hopper kernel is bound by neither.  On the card
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md) it takes about 0.024 ms there
// and 0.022 ms at moonshot's (1, 1024, 16, 128), against 0.028 and 0.025
// ms for scaled_dot_product_attention (a cuDNN Hopper kernel): the launch
// and the first loads, then each block's chain of key steps, each waiting
// on its Q·Kᵀ and then on a softmax whose exponentials alone take 1024 SFU
// cycles a 128 x 128 tile (tools/flash_trace.py times a step's phases).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"
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
using hopper::kLog2e;

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

// ---- bfloat16 inputs on Hopper: TMA, wgmma, a producer warp ----

constexpr int kHopRows = 64;      // query rows a consumer warpgroup owns
constexpr int kHopThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int kHopConsumerWarps = 8;

// Tile shapes by head dim: BN key rows a stage, SW the swizzle width in
// bytes (a TMA box is SW / 2 columns wide; 80 = 5 x 16 takes 32-byte
// boxes, the others 128-byte ones), ST stages of the K and V rings.
template <int D>
struct HopTile {
  static constexpr int BN = D <= 128 ? 128 : 64;
  static constexpr int SW = D % 64 == 0 ? 128 : 32;
  static constexpr int ST = 2;
  static constexpr int kBoxCols = SW / 2;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr uint32_t kLayout = SW == 128 ? 1 : 3;
  static constexpr uint32_t kQTileBytes = kHopRows * D * 2;  // one warpgroup's Q
  static constexpr uint32_t kKVBytes = BN * D * 2;
  // Q of both warpgroups, ST K stages, ST V stages, then the barriers; 1 KB
  // to align the base to the 128-byte swizzle's 1024-byte period
  static constexpr uint32_t kBarOffset = 2 * kQTileBytes + 2 * ST * kKVBytes;
  static constexpr size_t kSmem = kBarOffset + 8 * (2 + 4 * ST) + 1024;
  static_assert(D % kBoxCols == 0, "head dim splits into whole boxes");
};

// 2^x flushing results below 2^-126 to 0: a probability that small adds
// nothing to a row's sum of at least 1.
using hopper::exp2_ftz;

// One block's work: two 64-row query tiles of one (b, h), the heavier
// (more key tiles under causal) for warpgroup 1, and the number of key
// tiles each reads (the first n_kt[w] of the heavier one's).  With
// `balance` (one item a block: a grid that fits on the SMs at once, so the
// heaviest block sets the time) item j of a (b, h) pairs tile n_qt - 1 - j
// with tile j, so that every item carries about the same number of key
// tiles.  Otherwise item j takes neighbours, the heaviest pair first, and
// the blocks, each working through a share of the items, even the load
// out.  A tile left without a partner (n_qt odd) is an item of its own,
// in which warpgroup 2 idles.
struct HopItem {
  int b, h, tile[2], n_kt[2];
};

__device__ __forceinline__ HopItem hop_item(int it, int BH, int H, int n_qt, int Sk, int BN,
                                            int causal, int balance) {
  HopItem w;
  const int j = it / BH, bh = it % BH;
  w.h = bh % H;
  w.b = bh / H;
  const int pair = (n_qt + 1) / 2 - 1 - j;
  w.tile[0] = balance ? n_qt - 1 - j : min(2 * pair + 1, n_qt - 1);
  w.tile[1] = balance ? j : 2 * pair;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int k_end = causal ? min(Sk, (w.tile[g] + 1) * kHopRows) : Sk;
    w.n_kt[g] = g == 0 || w.tile[1] != w.tile[0] ? (k_end + BN - 1) / BN : 0;
  }
  return w;
}

// The items block `blk` of `grid` takes, in rounds: item r·grid + blk in
// even rounds, r·grid + grid - 1 - blk in odd ones, so that a block that
// took one of the heaviest items of a round takes one of the lightest of
// the next.
__device__ __forceinline__ int hop_item_index(int r, int blk, int grid) {
  return r * grid + ((r & 1) ? grid - 1 - blk : blk);
}

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_attention_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                              int Sq, int Sk, int H, int BH, int n_qt, float scale_log2,
                              int causal, int balance) {
  using T = HopTile<D>;
  constexpr int BN = T::BN, SW = T::SW, ST = T::ST;
  constexpr int NS = BN / 2;  // S floats a thread
  constexpr int NO = D / 2;   // O floats a thread
  extern __shared__ __align__(16) unsigned char hop_smem_raw[];
  const uint32_t base = (hopper::smem_addr(hop_smem_raw) + 1023u) & ~1023u;
  // Q region c holds 128 rows of SW bytes: warpgroup w's 64 at row 64 w
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + 2 * T::kQTileBytes;  // stage st at k_s + st * kKVBytes
  const uint32_t v_s = k_s + ST * T::kKVBytes;
  const uint32_t bar = base + T::kBarOffset;      // 8 bytes each:
  const uint32_t q_full = bar;                    //   an item's Q landed
  const uint32_t q_empty = bar + 8;               //   both warpgroups done with it
  const uint32_t full_k = bar + 16;               //   K stage st landed: full_k + 8 st
  const uint32_t full_v = full_k + 8 * ST;
  const uint32_t empty_k = full_v + 8 * ST;       //   K stage st read by every warp
  const uint32_t empty_v = empty_k + 8 * ST;
  const int n_items = (n_qt + 1) / 2 * BH;
  const int blk = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);

  // warp-uniform by construction, so that each role's branch is taken by
  // whole warps
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, kHopConsumerWarps);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      hopper::mbar_init(full_k + 8 * st, 1);
      hopper::mbar_init(full_v + 8 * st, 1);
      hopper::mbar_init(empty_k + 8 * st, kHopConsumerWarps);
      hopper::mbar_init(empty_v + 8 * st, kHopConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warpgroup == 0) {
    // producer: one thread issues every load; the group gives up registers
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int g = 0;  // position in the K and V rings, counted over the items
      for (int r = 0;; ++r) {
        const int it = hop_item_index(r, blk, grid);
        if (it >= n_items) break;
        const HopItem w = hop_item(it, BH, H, n_qt, Sk, BN, causal, balance);
        const bool paired = w.n_kt[1] > 0;
        hopper::mbar_wait(q_empty, (r & 1) ^ 1);  // the last item's Q read
        hopper::mbar_expect_tx(q_full, (paired ? 2 : 1) * T::kQTileBytes);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == 1 && !paired) break;
#pragma unroll
          for (int c = 0; c < T::kBoxes; ++c)
            hopper::tma_load_4d(q_s + (2 * c + q) * kHopRows * SW, &tm_q, q_full,
                                c * T::kBoxCols, w.h, w.tile[q] * kHopRows, w.b);
        }
        for (int t = 0; t < w.n_kt[0]; ++t, ++g) {
          const int st = g % ST;
          const uint32_t phase = ((g / ST) & 1) ^ 1;
          hopper::mbar_wait(empty_k + 8 * st, phase);
          hopper::mbar_expect_tx(full_k + 8 * st, T::kKVBytes);
#pragma unroll
          for (int c = 0; c < T::kBoxes; ++c)
            hopper::tma_load_4d(k_s + st * T::kKVBytes + c * BN * SW, &tm_k, full_k + 8 * st,
                                c * T::kBoxCols, w.h, t * BN, w.b);
          hopper::mbar_wait(empty_v + 8 * st, phase);
          hopper::mbar_expect_tx(full_v + 8 * st, T::kKVBytes);
#pragma unroll
          for (int c = 0; c < T::kBoxes; ++c)
            hopper::tma_load_4d(v_s + st * T::kKVBytes + c * BN * SW, &tm_v, full_v + 8 * st,
                                c * T::kBoxCols, w.h, t * BN, w.b);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int cw = warpgroup - 1;  // this warpgroup: query tile tile[cw] of each item
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const bool arrive = lane == 0;

    // descriptors, split into the low word (start address and leading
    // offset, which a k-step advances) and the constant high word
    const uint32_t kmaj_hi = hopper::desc_hi(8 * SW, T::kLayout);  // Q and K: K-major
    const uint32_t v_hi = hopper::desc_hi(8 * SW, T::kLayout);     // V: MN-major
    const uint32_t q_lo0 = hopper::desc_lo(q_s + cw * kHopRows * SW, 16);
    const uint32_t k_lo0 = hopper::desc_lo(k_s, 16);
    const uint32_t v_lo0 = hopper::desc_lo(v_s, BN * SW);
    // k-step kk of Q·Kᵀ in 16-byte units: column region (16 kk) / (SW / 2),
    // then 32 bytes a step within it
    auto qk_off = [](int kk, int rows) -> uint32_t {
      return static_cast<uint32_t>(((kk * 16) / T::kBoxCols * rows * T::SW +
                                    (kk * 16) % T::kBoxCols * 2) >> 4);
    };

    float s[NS], acc[NO];
    uint32_t p[NS / 2];
    // running max of the raw scores q·k; this lane's share of each row's sum
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};
    int warp_row = 0, row0 = 0;

    auto fence_all = [&]() {
      hopper::fence_regs(s);
      hopper::fence_regs(acc);
      hopper::fence_regs(p);
    };
    // S = Q·K_stᵀ, after the fence that orders every earlier register
    // write before the products; committed, not waited for
    auto issue_qk = [&](int st) {
      fence_all();
      hopper::wgmma_fence();
      uint32_t q_lo = q_lo0;
      asm volatile("" : "+r"(q_lo));  // recomputed at each issue, not held
      const uint32_t k_lo = k_lo0 + st * (T::kKVBytes >> 4);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::WgmmaSS<BN>::run(s, hopper::desc(q_lo + qk_off(kk, 2 * kHopRows), kmaj_hi),
                                 hopper::desc(k_lo + qk_off(kk, BN), kmaj_hi), kk > 0);
      hopper::wgmma_commit();
    };
    // O += P·V_st, committed, not waited for
    auto issue_pv = [&](int st) {
      const uint32_t v_lo = v_lo0 + st * (T::kKVBytes >> 4);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hopper::WgmmaRS<D>::run(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                                hopper::desc(v_lo + kk * SW, v_hi));
      hopper::wgmma_commit();
    };
    // mask key tile t, then the online softmax: s becomes exp2 of the scaled
    // scores less the new max; corr is the old state's correction per row
    auto softmax = [&](int t, float (&corr)[2]) {
      const int k0 = t * BN;
      if (k0 + BN > Sk || (causal && k0 + BN - 1 > warp_row)) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int col = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
          const int row = row0 + ((i >> 1) & 1) * 8;
          if (col >= Sk || (causal && col > row)) s[i] = kNegInf;
        }
      }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float neg[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2_ftz((m_r[r] - mx[r]) * scale_log2);
        m_r[r] = mx[r];
        neg[r] = -mx[r] * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2_ftz(fmaf(s[i], scale_log2, neg[r]));
        ps[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + ps[r];
    };
    // P rounded to bf16, pairwise: the A fragments of P·V as they stand
    auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) p[i] = tc::pack_bf16(s[2 * i], s[2 * i + 1]);
    };

    int g = 0;  // position in the K and V rings, counted over the items
    for (int r = 0;; ++r) {
      const int it = hop_item_index(r, blk, grid);
      if (it >= n_items) break;
      const HopItem w = hop_item(it, BH, H, n_qt, Sk, BN, causal, balance);
      const int n_tiles = w.n_kt[cw];  // key tiles this warpgroup computes
      const int n_both = w.n_kt[1];    // ... and both do
      // On its block's last item warpgroup 2 leaves once its own tiles are
      // done, and warpgroup 1 frees the later stages for both; on earlier
      // items it passes those tiles through its hands (below), so that its
      // place in the rings never falls behind the barriers' phases.
      const bool last = hop_item_index(r + 1, blk, grid) >= n_items;
      const uint32_t frees = cw == 0 && last ? 2 : 1;
      warp_row = w.tile[cw] * kHopRows + (tid >> 5) * 16;  // this warp's first row
      row0 = warp_row + (lane >> 2);                        // and row0 + 8
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) p[i] = 0u;
      m_r[0] = m_r[1] = kNegInf;
      l_r[0] = l_r[1] = 0.0f;

      // The two warpgroups take turns at the tensor cores (FlashAttention-3's
      // ping-pong) while both have key tiles: warpgroup cw issues its
      // products after waiting on named barrier 1 + cw, then passes the turn
      // on, so that one group's softmax runs on the CUDA cores while the
      // other's products run.  Group 0 starts; group 1 does not pass its
      // last turn, which no one awaits; past n_both group 0 runs alone.
      auto take_turn = [&](int t) {
        if (cw == 0) {
          if (t < n_both) hopper::named_bar_sync<1>(256);
        } else {
          hopper::named_bar_sync<2>(256);
        }
      };
      auto pass_turn = [&](int t) {
        if (cw == 0) {
          if (t < n_both) hopper::named_bar_arrive<2>(256);
        } else if (t < n_both - 1) {
          hopper::named_bar_arrive<1>(256);
        }
      };
      // ring stage and phase parity of the item's key tile t
      auto stage = [&](int t) { return (g + t) % ST; };
      auto parity = [&](int t) { return static_cast<uint32_t>(((g + t) / ST) & 1); };

      hopper::mbar_wait(q_full, r & 1);
      if (n_tiles > 0) {
        if (cw == 1) hopper::named_bar_arrive<1>(256);
        float corr[2];
        hopper::mbar_wait(full_k + 8 * stage(0), parity(0));
        take_turn(0);
        issue_qk(stage(0));
        pass_turn(0);
        hopper::wgmma_wait<0>();
        fence_all();
        if (arrive) {
          hopper::mbar_arrive(empty_k + 8 * stage(0), 0 < n_both ? 1 : frees);
          if (n_tiles == 1) hopper::mbar_arrive(q_empty);
        }
        softmax(0, corr);
        pack_p();
        for (int t = 1; t < n_tiles; ++t) {
          hopper::mbar_wait(full_k + 8 * stage(t), parity(t));
          hopper::mbar_wait(full_v + 8 * stage(t - 1), parity(t - 1));
          take_turn(t);
          issue_qk(stage(t));
          issue_pv(stage(t - 1));  // P·V of tile t - 1 runs while tile t's softmax does
          pass_turn(t);
          hopper::wgmma_wait<1>();
          fence_all();
          if (arrive) {
            hopper::mbar_arrive(empty_k + 8 * stage(t), t < n_both ? 1 : frees);
            if (t == n_tiles - 1) hopper::mbar_arrive(q_empty);
          }
          softmax(t, corr);
          hopper::wgmma_wait<0>();
          fence_all();
          if (arrive) hopper::mbar_arrive(empty_v + 8 * stage(t - 1), t - 1 < n_both ? 1 : frees);
#pragma unroll
          for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];
          pack_p();
        }
        hopper::mbar_wait(full_v + 8 * stage(n_tiles - 1), parity(n_tiles - 1));
        fence_all();
        hopper::wgmma_fence();
        issue_pv(stage(n_tiles - 1));
        hopper::wgmma_wait<0>();
        fence_all();
        if (arrive) hopper::mbar_arrive(empty_v + 8 * stage(n_tiles - 1), n_tiles - 1 < n_both ? 1 : frees);

        const size_t row_stride = static_cast<size_t>(H) * D;
        bf16* ob = out + (static_cast<size_t>(w.b) * Sq * H + w.h) * D;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float l = l_r[i];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          l = fmaxf(l, 1e-30f);
          const int row = row0 + 8 * i;
          if (row >= Sq) continue;
          bf16* orow = ob + row * row_stride + 2 * t4;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            *reinterpret_cast<uint32_t*>(orow + 8 * jj) =
                tc::pack_bf16(acc[4 * jj + 2 * i] / l, acc[4 * jj + 2 * i + 1] / l);
        }
      } else if (arrive) {
        hopper::mbar_arrive(q_empty);  // an item whose second tile is missing
      }
      if (last) break;
      for (int t = n_tiles; t < w.n_kt[0]; ++t) {
        hopper::mbar_wait(full_k + 8 * stage(t), parity(t));
        if (arrive) hopper::mbar_arrive(empty_k + 8 * stage(t));
        hopper::mbar_wait(full_v + 8 * stage(t), parity(t));
        if (arrive) hopper::mbar_arrive(empty_v + 8 * stage(t));
      }
      g += w.n_kt[0];
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

using hopper::encode_map;

template <int D>
int launch_hopper(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                  int H, float scale, int causal, cudaStream_t stream) {
  using T = HopTile<D>;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_map(&tm_q, q, B, Sq, H, D, T::kBoxCols, kHopRows, T::SW);
  if (err == 0) err = encode_map(&tm_k, k, B, Sk, H, D, T::kBoxCols, T::BN, T::SW);
  if (err == 0) err = encode_map(&tm_v, v, B, Sk, H, D, T::kBoxCols, T::BN, T::SW);
  if (err != 0) return err;
  auto kernel = flash_attention_hopper_kernel<D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_qt = (Sq + kHopRows - 1) / kHopRows;
  const long long items = static_cast<long long>((n_qt + 1) / 2) * B * H;
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one block an SM, each working through its share of the items
  const int balance = causal && items <= sms;
  const long long blocks = items < sms ? items : sms;
  kernel<<<static_cast<unsigned>(blocks), kHopThreads, T::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), Sq, Sk, H, B * H, n_qt, scale * kLog2e, causal,
      balance);
  return static_cast<int>(cudaGetLastError());
}

// path 0: float32 on the CUDA cores; 1: bf16 mma.sync tiles; 2: bf16 TMA and
// wgmma (head dims 64, 80, 128, 256, 16-byte aligned inputs).
int dispatch(int path, int D, const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, float scale, int causal, cudaStream_t st) {
#define FLASH_CASE(d)                                                     \
  case d:                                                                 \
    if (path == 0) return launch_f32<d>(q, k, v, o, B, Sq, Sk, H, scale, causal, st); \
    if (path == 1) return launch_bf16<d>(q, k, v, o, B, Sq, Sk, H, scale, causal, st); \
    break;
#define HOPPER_CASE(d)                                                    \
  case d:                                                                 \
    if (path == 2) return launch_hopper<d>(q, k, v, o, B, Sq, Sk, H, scale, causal, st); \
    break;
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default: break;
  }
  switch (D) {
    HOPPER_CASE(64)
    HOPPER_CASE(80)
    HOPPER_CASE(128)
    HOPPER_CASE(256)
    default: break;
  }
#undef FLASH_CASE
#undef HOPPER_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry for ctypes.  `path` picks the kernel (see `dispatch`; the
// wrapper's `kernel_path` chooses it).  Returns the CUDA error code of the
// launch (0 on success), cudaErrorInvalidValue for a head dim or path the
// kernels do not take, or one of the launch's own codes above.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Sk, int H, int D, float scale,
                                      int causal, int path, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch(path, D, q, k, v, o, B, Sq, Sk, H, scale, causal,
                  static_cast<cudaStream_t>(stream));
}
