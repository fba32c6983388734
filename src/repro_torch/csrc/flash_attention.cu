// Online-softmax attention over (B, S, H, D) tensors, fp32 softmax state.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas body `_kernel`).  For each (b, h) and query row i:
// s_j = (q_i · k_j) · scale, masked to NEG_INF = -2^30 where j >= Sk or
// (causal) j > i; o_i = Σ_j softmax(s)_j v_j.  Positions count from 0 for
// both q and k.  Inputs are float32 or bfloat16, read as stored and widened
// to float32; m, l and the accumulator stay float32 until the final store,
// which rounds to the input type.  l is clamped to 1e-30 before the divide.
//
// Design.  One block of 256 threads takes a 64-row query tile of one (b, h)
// and walks the key tiles of 64 rows: with `causal` the walk stops at the
// tile holding the tile's last query row, so nothing above the diagonal is
// loaded or computed (the TPU kernel's `pl.when` skip, as a loop bound).
// The tensors are read in their (B, S, H, D) layout by strides; ragged
// ends (S not a multiple of 64) are masked in the kernel, so the wrapper
// makes no transposed or padded copies.  Q, K, V and the probability tile
// sit in dynamic shared memory (Q and K rows padded to D + 1 floats so that
// the 16 threads reading 16 different rows hit 16 banks).  Thread (ty, tx)
// of a 16 x 16 grid owns query rows 4·ty .. 4·ty + 3: it computes the
// scores of those rows against keys tx, tx + 16, tx + 32, tx + 48, and the
// output columns tx, tx + 16, … of the same rows, so a row's max and sum
// are reduced with four xor-shuffles inside a 16-lane half warp and the
// accumulator (4 x D/16 floats) lives in registers: 64 floats at D = 256.
// Head dims 64, 80, 128 and 256 are compiled; shared memory is 66 KB at
// D = 64 and 209 KB at D = 256, opened past 48 KB with
// cudaFuncSetAttribute.
//
// What bounds it on an H100.  At the serve shape (1, 1024, 32, 64),
// causal, bf16: 4·S²·H·D/2 = 4.3 GFLOP against 16.8 MB of q, k, v and o.
// At the bf16 tensor-core rate (989 TFLOP/s) the operations take 4.3 µs and
// the bytes 5.0 µs at 3.35 TB/s, so the function is byte-bound at the
// card's peaks.  This kernel does its products in float32 on the CUDA
// cores (67 TFLOP/s), where the same work takes 64 µs: it is bound by
// the FP32 pipes and by shared-memory reads (two floats per two FMAs).
// Tensor-core tiles (mma / wgmma) and TMA are a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kNegInf = -1073741824.0f;  // -2^30, as the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
                       float scale, int causal) {
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
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;
  T* ob = o + (static_cast<size_t>(b) * Sq * H + h) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int s = q0 + r;
    q_s[r * DP + c] = s < Sq ? to_f32(qb[s * row + c]) : 0.0f;
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
      k_s[r * DP + c] = in ? to_f32(kb[s * row + c]) : 0.0f;
      v_s[r * D + c] = in ? to_f32(vb[s * row + c]) : 0.0f;
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
    for (int c = 0; c < DPT; ++c) store(ob + qi * row + tx + 16 * c, acc[i][c] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           float scale, int causal, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                            static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk,
                                            H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
             int H, float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, scale, causal, st);
    case 80: return launch<T, 80>(q, k, v, o, B, Sq, Sk, H, scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, scale, causal, st);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (dtype == 0) return dispatch<float>(D, q, k, v, o, B, Sq, Sk, H, scale, causal, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
