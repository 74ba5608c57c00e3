// Block-tile GEMM mainloops shared by mlp.cu and block.cu:
//   C (M, N) = epilogue(A (M, K) . W (N, K)^T)
// A and W are row-major and contiguous along the reduction axis (W is in
// torch.nn.Linear's (out, in) layout). A kernel picks its operands and its
// block's (m0, n0) and calls one of the two tile functions with an epilogue
// functor `float epi(int row, int col, float acc)`, which turns the f32
// accumulator of C[row][col] into the value that is stored (cast to C's type).
//
// - gemm_bf16_wmma_tile: tensor cores through WMMA 16x16x16 tiles with f32
//   accumulation: a 128x128 block tile, 8 warps of 64x32, K staged 32 at a time
//   in a two-stage cp.async ring in shared memory. K % 32 == 0 and 16-byte
//   aligned operands (the wrappers check both).
// - gemm_f32_simt_tile: a plain CUDA-core tiled GEMM (64x64 tile, K 16 at a
//   time), so f32 results match a full-precision f32 matmul, not TF32.
#pragma once

#include <mma.h>

#include "tc.cuh"

namespace climb {

// ---- bf16: tensor cores through WMMA -------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLds = kBK + 8;  // smem row stride in elements (16-byte multiple)
constexpr int kWmmaThreads = 256;

// One 128 x 32 tile of a row-major (rows, K) operand into smem; rows past
// `rows` are zero-filled. 512 16-byte chunks, two per thread.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int rows, int K, int k0, int tid) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int chunk = tid + e * kWmmaThreads;
    const int r = chunk >> 2, c = (chunk & 3) * 8;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* g = ok ? src + static_cast<size_t>(row0 + r) * K + k0 + c : src;
    cp_async16(dst + r * kLds + c, g, ok);
  }
}

// The block's 128 x 128 tile of C at (m0, n0); call from all kWmmaThreads
// threads of the block.
template <typename Epilogue>
__device__ __forceinline__ void gemm_bf16_wmma_tile(const __nv_bfloat16* __restrict__ A,
                                                    const __nv_bfloat16* __restrict__ W,
                                                    __nv_bfloat16* __restrict__ C, int M, int N,
                                                    int K, int m0, int n0, Epilogue epi) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[2][kBM * kLds];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][kBN * kLds];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = K / kBK;
  load_tile(As[0], A, m0, M, K, 0, tid);
  load_tile(Bs[0], W, n0, N, K, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_tile(As[buf ^ 1], A, m0, M, K, (kt + 1) * kBK, tid);
      load_tile(Bs[buf ^ 1], W, n0, N, K, (kt + 1) * kBK, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &As[buf][(wm * 64 + i * 16) * kLds + kk], kLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[buf][(wn * 32 + j * 16) * kLds + kk], kLds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue through a per-warp 16x16 f32 scratch carved from As
  float* scratch = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 64 + i * 16 + r;
      const int gn = n0 + wn * 32 + j * 16 + c0;
      if (gm < M) {
        const float* acc_row = scratch + r * 16 + c0;
        __nv_bfloat16* dst = C + static_cast<size_t>(gm) * N + gn;
        if (gn + 8 <= N) {  // the whole 16-byte group is inside the row
          __align__(16) __nv_bfloat16 vals[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            vals[e] = __float2bfloat16_rn(epi(gm, gn + e, acc_row[e]));
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
        } else {
          for (int e = 0; e < 8 && gn + e < N; ++e)
            dst[e] = __float2bfloat16_rn(epi(gm, gn + e, acc_row[e]));
        }
      }
      __syncwarp();
    }
  }
}

// ---- f32: CUDA-core tiled GEMM ---------------------------------------------

constexpr int kSM = 64, kSN = 64, kSK = 16, kSimtThreads = 256;

// The block's 64 x 64 tile of C at (m0, n0); call from all kSimtThreads
// threads of the block.
template <typename Epilogue>
__device__ __forceinline__ void gemm_f32_simt_tile(const float* __restrict__ A,
                                                   const float* __restrict__ W,
                                                   float* __restrict__ C, int M, int N, int K,
                                                   int m0, int n0, Epilogue epi) {
  __shared__ float As[kSK][kSM + 4];
  __shared__ float Bs[kSK][kSN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kSimtThreads;
      const int r = idx / kSK, kk = idx % kSK;
      const int gm = m0 + r, gn = n0 + r;
      As[kk][r] = gm < M ? A[static_cast<size_t>(gm) * K + k0 + kk] : 0.f;
      Bs[kk][r] = gn < N ? W[static_cast<size_t>(gn) * K + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      C[static_cast<size_t>(gm) * N + gn] = epi(gm, gn, acc[i][j]);
    }
  }
}

}  // namespace climb
