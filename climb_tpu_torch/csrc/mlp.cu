// Transformer FFN forward as two GEMM launches with fused epilogues:
//   launch 1: h = GELU_exact(x . W1^T + b1), stored in x's type
//   launch 2: o = h . W2^T + b2
//
// Replaces climb_tpu/ops/pallas_mlp.py::_mlp_kernel (_fused_mlp_impl). The
// TPU kernel keeps a 256-row h tile in VMEM between its two products and
// casts h to x's type before the second (pallas_mlp.py:50); this port casts
// at the same place. It uses exact erff where the TPU kernel needed the A&S
// polynomial.
//
// Bound on the H100: operations. At the ViLT-B/32 serving shape (17,984 rows,
// 768 -> 3072 -> 768, bf16) one FFN is 169.7 GFLOP, 0.1716 ms at 989
// TFLOP/s, against 64.7 MB of compulsory traffic (19 us). What the design
// does about it:
// - bf16 products run on gemm.cuh's Hopper tile: wgmma m64n128k16 with f32
//   accumulators, 256 x 128 block tiles, 64-deep K slices of both operands
//   streamed by TMA through a 4-stage mbarrier ring by one producer warp
//   while four consumer warpgroups multiply (shared with block.cu).
// - Bias, GELU and the cast happen in the epilogue, on the f32 accumulators
//   staged in shared memory; the bf16 tile leaves in 16-byte stores.
// - h goes through device memory: a 256x3072 h tile does not fit the 227 KB
//   of shared memory beside the operand ring. That is 110 MB per FFN in bf16
//   written and 110 MB read back (66 us at 3.35 TB/s), spread under the
//   products. Fusing the two products is later work.
// - f32 products (the parity path) use a plain CUDA-core tiled GEMM, so f32
//   results match PyTorch's full-precision f32 matmul, not TF32.
// Weights are in torch.nn.Linear's (out, in) layout, so both operands of
// each product are contiguous along the reduction axis.
#include <math.h>

#include "gemm.cuh"

using namespace climb;

namespace {

__device__ __forceinline__ float gelu_exact(float y) {
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}

// acc + bias[col], then the exact GELU when asked
template <typename T>
struct BiasAct {
  const T* bias;
  int gelu;
  __device__ __forceinline__ float operator()(int, int col, float acc) const {
    const float y = acc + to_float(bias[col]);
    return gelu ? gelu_exact(y) : y;
  }
};

// The mainloops are gemm.cuh's: wgmma fed by TMA for bf16, a CUDA-core tiled
// GEMM for f32.
__global__ void __launch_bounds__(kGemmThreads, 1)
    linear_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap a,
                             const __grid_constant__ CUtensorMap w,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ C, int M, int N, int K, int gelu) {
  gemm_bf16_wgmma_tile(&a, &w, C, M, N, K, blockIdx.y * kTileM, blockIdx.x * kTileN,
                       BiasAct<__nv_bfloat16>{bias, gelu});
}

__global__ void __launch_bounds__(kSimtThreads)
    linear_f32_simt_kernel(const float* __restrict__ A, const float* __restrict__ W,
                           const float* __restrict__ bias, float* __restrict__ C, int M, int N,
                           int K, int gelu) {
  gemm_f32_simt_tile(A, W, C, M, N, K, blockIdx.y * kSM, blockIdx.x * kSN,
                     BiasAct<float>{bias, gelu});
}

}  // namespace

// out (M, N) = act(x (M, K) . w (N, K)^T + bias (N)); act = exact GELU when
// gelu != 0. All row-major and contiguous, one dtype; K % 64 == 0, N % 8 == 0
// and 16-byte aligned pointers (the wrapper checks them).
extern "C" int climb_linear_bias_act(const void* x, const void* w, const void* bias, void* out,
                                     int M, int N, int K, int gelu, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kTileK != 0 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == climb::kBFloat16) {
    // the operands' addresses change from call to call: encode their maps here
    CUtensorMap a_map, w_map;
    int err = encode_kmajor_bf16(&a_map, x, M, K, kTileK, kTileM);
    if (!err) err = encode_kmajor_bf16(&w_map, w, N, K, kTileK, kTileN);
    if (!err) err = allow_gemm_smem(linear_bf16_wgmma_kernel);
    if (err) return err;
    const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
    linear_bf16_wgmma_kernel<<<grid, kGemmThreads, kGemmSmemBytes, s>>>(
        a_map, w_map, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
        M, N, K, gelu);
  } else if (dtype == climb::kFloat32) {
    const dim3 grid((N + kSN - 1) / kSN, (M + kSM - 1) / kSM);
    linear_f32_simt_kernel<<<grid, kSimtThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K, gelu);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
