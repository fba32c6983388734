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
// x, B and C are float32 or bfloat16 (one type), dt, A and D float32; all
// arithmetic is float32, y is stored in x's type and h_final in float32.
//
// Design.  The TPU grid's sequential chunk axis, with h in VMEM scratch,
// becomes one block of 256 threads per (b, h) that loops over the chunks;
// the (P, N) float32 state stays in shared memory for the whole sequence.
// Each chunk's x (Q x P), B and C (Q x N) and dt are staged in shared
// memory, read from the (Bt, S, H, P) / (Bt, S, G, N) layouts by strides:
// the group index replaces the TPU wrapper's per-head copies of B and C,
// and the ragged last chunk is masked (x = dt = B = C = 0 beyond S, which
// leaves h exactly as the TPU wrapper's zero padding does: the step's
// decay is exp(0) = 1 and its input term is 0).  One thread runs the
// chunk's cumsum in order.  The Q x Q decay-weighted score matrix is never
// held whole: rows go in tiles of 32 (a 32 x Q tile, 16 KB at Q = 128),
// each thread computing a 4 x 4 patch of scores against the tile's causal
// columns only, then the same thread grid produces the tile's y rows.  The
// state update reads the staged x and B once more.  Shared memory rows
// read across lanes are padded to an odd stride.
//
// What bounds it on an H100.  At the serve shape (1, 1024, 64, 64), N = 64,
// G = 1, Q = 128, bf16: x and y 8.4 MB each, B, C, dt and h_final 1.6 MB,
// about 18 MB, 5.5 µs at 3.35 TB/s; the work is about 2.3 M FMAs per chunk
// and head, 2.4 GFLOP in all, 36 µs at the FP32 peak.  The kernel is bound
// by its parallelism first: the grid is B·H = 64 blocks on 132 SMs, one
// per SM, each walking its 8 chunks in order with float32 CUDA-core
// arithmetic.  Splitting P across blocks, tensor-core tiles and double
// buffering the chunk loads are later steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows of y per tile: 8 warps x 4 rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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
template <typename T, int PC, int NC>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv, T* __restrict__ y,
                float* __restrict__ h_final, int S, int H, int P, int G, int N, int Q) {
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
  const T* xb = x + (static_cast<size_t>(b) * S * H + h) * P;
  T* yb = y + (static_cast<size_t>(b) * S * H + h) * P;
  const T* bb = Bm + (static_cast<size_t>(b) * S * G + g) * N;
  const T* cb = Cm + (static_cast<size_t>(b) * S * G + g) * N;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;

  for (int e = tid; e < Pp * N1; e += kThreads) h_s[e] = 0.0f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = ci * Q;
    __syncthreads();  // the previous chunk's state update is done
    for (int e = tid; e < Qp * Pp; e += kThreads) {
      const int r = e / Pp, c = e - r * Pp;
      const int s = s0 + r;
      x_s[e] = (r < Q && s < S && c < P) ? to_f32(xb[s * xrow + c]) : 0.0f;
    }
    for (int e = tid; e < Qp * N; e += kThreads) {
      const int r = e / N, c = e - r * N;
      const int s = s0 + r;
      const bool in = r < Q && s < S;
      b_s[r * N1 + c] = in ? to_f32(bb[s * brow + c]) : 0.0f;
      c_s[e] = in ? to_f32(cb[s * brow + c]) : 0.0f;
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
          store(yb + s * xrow + p, out);
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

template <typename T, int PC, int NC>
int launch(const void* x, const float* dt, const float* A, const void* B, const void* C,
           const float* D, void* y, float* h_final, int Bt, int S, int H, int P, int G, int N,
           int Q, cudaStream_t stream) {
  const Geometry geo = geometry(Q, P, N, PC);
  auto kernel = ssd_scan_kernel<T, PC, NC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(geo.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Bt);
  kernel<<<grid, kThreads, geo.bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<T*>(y), h_final, S, H, P, G, N, Q);
  return static_cast<int>(cudaGetLastError());
}

int groups(int v) { return v <= 32 ? 1 : v <= 64 ? 2 : v <= 128 ? 4 : 0; }

template <typename T, int PC>
int dispatch_n(int NC, const void* x, const float* dt, const float* A, const void* B,
               const void* C, const float* D, void* y, float* hf, int Bt, int S, int H, int P,
               int G, int N, int Q, cudaStream_t st) {
  switch (NC) {
    case 1: return launch<T, PC, 1>(x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    case 2: return launch<T, PC, 2>(x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    case 4: return launch<T, PC, 4>(x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* B, const void* C,
             const float* D, void* y, float* hf, int Bt, int S, int H, int P, int G, int N,
             int Q, cudaStream_t st) {
  const int NC = groups(N);
  switch (groups(P)) {
    case 1: return dispatch_n<T, 1>(NC, x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    case 2: return dispatch_n<T, 2>(NC, x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    case 4: return dispatch_n<T, 4>(NC, x, dt, A, B, C, D, y, hf, Bt, S, H, P, G, N, Q, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared-memory bytes the kernel needs for one block (0 where P or N is
// above 128), so the wrapper can refuse a shape before launching.
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N) {
  const int PC = groups(P);
  if (PC == 0 || groups(N) == 0) return 0;
  return static_cast<long long>(geometry(Q, P, N, PC).bytes);
}

// Plain C entry for ctypes.  dtype 0 is float32, 1 is bfloat16 (x, B, C and
// y).  Returns the CUDA error code of the launch (0 on success); a shape
// the kernel does not take (P or N above 128, Q above 128, H not a
// multiple of G) returns cudaErrorInvalidValue.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A, const void* B,
                               const void* C, const float* D, void* y, float* h_final, int Bt,
                               int S, int H, int P, int G, int N, int Q, int dtype, void* stream,
                               int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q < 1 || Q > 128 || G < 1 || H % G != 0 || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, dt, A, B, C, D, y, h_final, Bt, S, H, P, G, N, Q, st);
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(x, dt, A, B, C, D, y, h_final, Bt, S, H, P, G, N, Q, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
