// Tensor-core and async-copy building blocks (PTX for sm_80 and later, built
// for sm_90a): cp.async with zero fill, ldmatrix, and mma.sync m16n8k16 with
// bf16 operands and f32 accumulators.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for lane
// l of a warp with g = l / 4 and t = l % 4:
// - A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//   a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9],
//   a3 = A[g+8][2t+8, 2t+9].
// - B (16 x 8, k x n), two registers: b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g].
// - C (16 x 8, f32), four floats: c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// So the C fragments of two neighbouring n-tiles (columns 16kk .. 16kk+15)
// packed to bf16 pairs are exactly the A fragment of k-chunk kk of the next
// product (a_from_c), and a row's values sit in the four lanes of one quad.
#pragma once

#include "common.cuh"

namespace climb {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (L2 only); valid false reads nothing and zero-fills
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
// 4 bytes, for rows whose starts are not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + 64) x 64 bf16 columns of a slice whose rows are
// `row_stride` elements apart, into a tile whose rows are LD elements apart:
// 16-byte cp.async, 512 / THREADS per thread; rows at or past `rows` are
// zero-filled (a zero times P = 0 stays 0, garbage might be a NaN)
template <int THREADS, int LD>
__device__ __forceinline__ void cp_async_tile64(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int row0, int rows,
                                                int tid) {
#pragma unroll
  for (int e = 0; e < 512 / THREADS; ++e) {
    const int chunk = tid + e * THREADS, r = chunk >> 3, c = (chunk & 7) << 3;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * LD + c, ok ? src + (row0 + r) * row_stride + c : src, ok);
  }
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b on the tensor cores
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (lo in the low half, as the fragments want)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// the A fragment of k-chunk kk from the C fragments of n-tiles 2kk and 2kk+1
template <int NT>
__device__ __forceinline__ void a_from_c(unsigned (&a)[4], const float (&c)[NT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Products of one warp's 16 rows against a bf16 tile in shared memory whose
// rows are `ld` elements apart (ld * 2 bytes a multiple of 16, and not of 128,
// so the eight rows of one ldmatrix fall in distinct banks).
//
// acc (16 x 8 NT) = A (16 x 16 KC) . T^T, with T's rows 0 .. 8 NT - 1 the n
// axis and its columns 0 .. 16 KC - 1 the k axis (q.k^T with T = K).
template <int NT, int KC>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const unsigned (&a)[KC][4],
                                        const __nv_bfloat16* T, int ld, int lane) {
  const int row = (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk)
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      unsigned b[4];
      ldmatrix_x4(b, T + (16 * p + row) * ld + 16 * kk + col);
      mma_bf16(acc[2 * p], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[kk], b[2], b[3]);
    }
}
// acc (16 x 8 NT) += A (16 x 16 KC) . T, with T's rows 0 .. 16 KC - 1 the k
// axis and its columns 0 .. 8 NT - 1 the n axis (p.v with T = V).
template <int NT, int KC>
__device__ __forceinline__ void mma_ab(float (&acc)[NT][4], const unsigned (&a)[KC][4],
                                       const __nv_bfloat16* T, int ld, int lane) {
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3), col = (lane >> 4) << 3;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk)
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      unsigned b[4];
      ldmatrix_x4_trans(b, T + (16 * kk + row) * ld + 16 * p + col);
      mma_bf16(acc[2 * p], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[kk], b[2], b[3]);
    }
}
// the A fragments of rows 0 .. 15 of a row-major tile, KC chunks of 16 columns
template <int KC>
__device__ __forceinline__ void load_a(unsigned (&a)[KC][4], const __nv_bfloat16* T, int ld,
                                       int lane) {
  const int row = lane & 15, col = (lane >> 4) << 3;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) ldmatrix_x4(a[kk], T + row * ld + 16 * kk + col);
}

// max and sum over the four lanes of a quad (one row of a C fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace climb
