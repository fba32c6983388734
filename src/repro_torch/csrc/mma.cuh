// Tensor-core and asynchronous-copy helpers shared by the bf16 kernels
// (flash_attention.cu, ssd_scan.cu), for sm_80 and later (built for sm_90a).
//
// Fragments follow PTX's mma.m16n8k16 layouts, with g = lane / 4 and
// t = lane % 4:
//   A (16 x 16, row-major), 4 registers of two bf16 each:
//     a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, k x n), 2 registers:  b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C (16 x 8, float32), 4 floats:  c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..)
// ldmatrix x4 loads four 8 x 8 bf16 matrices; lanes 8i .. 8i+7 give the
// row addresses of matrix i, and lane l receives row l / 4, columns
// 2(l % 4) and 2(l % 4) + 1 of each (with .trans: column l / 4, rows 2(l % 4)
// and 2(l % 4) + 1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a · b on the tensor cores, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo exactly, hi = bf16(x).  Rounded to bf16 as well, lo leaves
// hi + lo within 2^-18·|x| of x (16 significant bits against float32's 24).
__device__ __forceinline__ void split_bf16(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = x - hi;
}

// A fragment of a 16 x 16 float tile held as two C fragments (columns 0-7
// in c0, 8-15 in c1), split into its bf16 high and low parts.
__device__ __forceinline__ void split_fragment(const float (&c0)[4], const float (&c1)[4],
                                               uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  float h[8], l[8];
  const float v[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 8; ++i) split_bf16(v[i], h[i], l[i]);
  hi[0] = pack_bf16(h[0], h[1]);
  hi[1] = pack_bf16(h[2], h[3]);
  hi[2] = pack_bf16(h[4], h[5]);
  hi[3] = pack_bf16(h[6], h[7]);
  lo[0] = pack_bf16(l[0], l[1]);
  lo[1] = pack_bf16(l[2], l[3]);
  lo[2] = pack_bf16(l[4], l[5]);
  lo[3] = pack_bf16(l[6], l[7]);
}

// The first `rows` rows of a strided bf16 matrix (row i at src + i·stride,
// `width` valid columns) into a shared tile with `ld` elements per row and
// `wpad` (a multiple of 8) columns; rows at or past `valid` and columns at
// or past `width` are zero.  With `vec` (width a multiple of 8, src 16-byte
// aligned) the copies are 16-byte cp.async, to be waited for by the caller;
// otherwise element by element.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, size_t stride,
                                           int rows, int valid, int width, int wpad, bool vec,
                                           int tid, int nthreads) {
  const int chunks = wpad / 8;
  for (int e = tid; e < rows * chunks; e += nthreads) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 8;
    bf16* d = dst + r * ld + c;
    const bf16* s = src + static_cast<size_t>(r) * stride + c;
    if (r < valid && c < width) {
      if (vec) {
        cp_async16(d, s);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = c + i < width ? s[i] : __float2bfloat16_rn(0.0f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

}  // namespace tc
