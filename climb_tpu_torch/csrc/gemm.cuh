// Block-tile GEMM mainloops shared by mlp.cu and block.cu:
//   C (M, N) = epilogue(A (M, K) . W (N, K)^T)
// A and W are row-major and contiguous along the reduction axis (W is in
// torch.nn.Linear's (out, in) layout). A kernel picks its operands and its
// block's (m0, n0) and calls one of the two tile functions with an epilogue
// functor `float epi(int row, int col, float acc)`, which turns the f32
// accumulator of C[row][col] into the value that is stored (cast to C's type).
//
// The GEMMs of mlp.cu (pallas_mlp.py::_mlp_kernel) and block.cu
// (pallas_block.py::_kernel) are bound by operations on the H100: 0.1716 ms
// for the FFN and 0.1015 ms for the attention sublayer at the ViLT-B/32
// serving shapes in bf16 (989 TFLOP/s). What the bf16 tile does about it:
// - gemm_bf16_wgmma_tile: a 256 x 128 block tile on wgmma m64n128k16 (bf16
//   operands from shared memory, f32 accumulators in registers), four
//   consumer warpgroups of 64 rows each and one producer warp, one block an
//   SM. The producer streams 64-deep K slices of A and W by TMA (hopper.cuh;
//   128-byte swizzle, rows past M or N zero-filled) into a 4-stage ring in
//   dynamic shared memory, with a full and an empty mbarrier per stage; no
//   thread computes a copy address. The 256-row tile reads 48 KB from L2 for
//   each 4.2 MFLOP slice, where a 128 x 128 tile reads 32 KB for 2.1. Each
//   consumer keeps one wgmma group in flight and releases a stage once the
//   group that read it has completed. The epilogue stages the f32
//   accumulators in the (then idle) ring, from the wgmma fragment layout;
//   each thread then applies the functor to 8 neighbouring accumulators of a
//   row, rounds each once to bf16 and writes them in one 16-byte store. (The
//   functor applied in the fragment layout kept the residual's loads live
//   beside the accumulators and spilled at the 120 registers a thread that
//   this block size leaves.) K % 64 == 0 and 16-byte aligned operands with
//   N % 8 == 0 (the wrappers check them); the kernel's block has
//   kGemmThreads threads and kGemmSmemBytes of dynamic shared memory.
// - gemm_f32_simt_tile: a plain CUDA-core tiled GEMM (64x64 tile, K 16 at a
//   time), so f32 results match a full-precision f32 matmul, not TF32.
#pragma once

#include "hopper.cuh"

namespace climb {

// ---- bf16: wgmma fed by TMA through an mbarrier ring -------------------------

constexpr int kConsumerWarpgroups = 4;  // 64 rows of the tile each
constexpr int kTileM = 64 * kConsumerWarpgroups, kTileN = 128;
constexpr int kTileK = 64;  // bf16: one 128-byte swizzle row
constexpr int kGemmStages = 4;  // 192 KB: one block an SM
constexpr int kGemmThreads = 128 * kConsumerWarpgroups + 32;  // + the producer warp
constexpr int kStageBytes = (kTileM + kTileN) * kTileK * 2;   // A then W, 48 KB
constexpr int kGemmSmemBytes = kGemmStages * kStageBytes + 2 * kGemmStages * 8 + 1024;
constexpr int kOutLd = kTileN + 8;  // f32 staging row stride: conflict-free float2 stores
static_assert(kConsumerWarpgroups * 64 * kOutLd * 4 <= kGemmStages * kStageBytes,
              "the epilogue stages the f32 tile in the ring");

// The block's kTileM x kTileN tile of C at (m0, n0), from the tensor maps of A
// (M, K) and W (N, K) (encode_kmajor_bf16 with boxes kTileK x kTileM and
// kTileK x kTileN); call from all kGemmThreads threads of the block.
template <typename Epilogue>
__device__ __forceinline__ void gemm_bf16_wgmma_tile(const CUtensorMap* a_map,
                                                     const CUtensorMap* w_map,
                                                     __nv_bfloat16* __restrict__ C, int M, int N,
                                                     int K, int m0, int n0, Epilogue epi) {
  extern __shared__ unsigned char gemm_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  const unsigned raw = smem_u32(gemm_smem);
  const unsigned ring = (raw + 1023u) & ~1023u;
  const unsigned full = ring + kGemmStages * kStageBytes, empty = full + kGemmStages * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = K / kTileK;

  if (tid == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full + 8 * s, 1);                         // the producer's expect_tx
      mbar_init(empty + 8 * s, 4 * kConsumerWarpgroups);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * kConsumerWarpgroups) {  // the producer warp: one thread issues the copies
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kGemmStages;
        mbar_wait(empty + 8 * s, ((i / kGemmStages) & 1) ^ 1);  // round 0 passes at once
        const unsigned a = ring + s * kStageBytes;
        mbar_arrive_expect_tx(full + 8 * s, kStageBytes);
        tma_load_2d(a, a_map, full + 8 * s, i * kTileK, m0);
        tma_load_2d(a + kTileM * kTileK * 2, w_map, full + 8 * s, i * kTileK, n0);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kGemmStages;
    mbar_wait(full + 8 * s, (i / kGemmStages) & 1);
    const unsigned a = ring + s * kStageBytes + wg * 64 * kTileK * 2;
    const unsigned w = ring + s * kStageBytes + kTileM * kTileK * 2;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      wgmma_m64n128k16(acc, sw128_desc(a + 32 * kk), sw128_desc(w + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the group of step i - 1 is done: its stage may be refilled
    if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % kGemmStages));
  }
  wgmma_wait<0>();

  // every warpgroup is done reading the ring before it holds the output
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumerWarpgroups) : "memory");
  float* out = reinterpret_cast<float*>(gemm_smem + (ring - raw)) + wg * 64 * kOutLd;
  const int r0 = (warp & 3) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (r0 + 8 * h) * kOutLd + 8 * j + c0) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");  // this warpgroup's rows
  // each thread: the functor on 8 neighbouring accumulators of a row, one
  // rounding each, one 16-byte store
  const int t = tid & 127;
#pragma unroll 2
  for (int e = 0; e < 64 * kTileN / 8 / 128; ++e) {
    const int chunk = t + 128 * e, r = chunk / (kTileN / 8), col = chunk % (kTileN / 8) * 8;
    const int gm = m0 + wg * 64 + r, gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(out + r * kOutLd + col);
    const float4 hi = *reinterpret_cast<const float4*>(out + r * kOutLd + col + 4);
    const float a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16_rn(epi(gm, gn + i, a[i]));
    *reinterpret_cast<uint4*>(C + static_cast<size_t>(gm) * N + gn) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// the dynamic shared memory a kernel on gemm_bf16_wgmma_tile needs, above the
// 48 KB default; returns a cudaError_t
template <typename Kernel>
inline int allow_gemm_smem(Kernel* kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmemBytes));
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
