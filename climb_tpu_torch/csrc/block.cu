// The pre-norm attention sublayer of a ViLT block as one entry point:
//   h   = LayerNorm(x) * ln_scale + ln_bias        (f32 statistics, cast to x's type)
//   q   = h . Wq^T + bq  (k, v alike; f32 accumulation, f32 bias, then the cast)
//   ctx = softmax(q_h . k_h^T / sqrt(64) + key_bias) . v_h   per head
//   out = x + (ctx . Wo^T + bo)                     (sum in f32, then the cast)
// It writes out and, for the backward, h, q, k, v and ctx.
//
// Replaces climb_tpu/ops/pallas_block.py::_kernel (wrappers _fused_fwd,
// fused_attention_sublayer). The TPU program holds one batch row's (S_pad, D)
// tile and all four weight matrices in VMEM and walks the batch in its grid.
// A block of this card has 227 KB of shared memory and one block per batch
// row would leave half of the 132 SMs idle, so the work is cut by rows and
// tiles instead, in four launches on one stream:
//   1. layernorm_kernel: one warp per row of x, writes h;
//   2. qkv_*_kernel: one GEMM launch for q, k and v; each block computes a
//      tile of h . [Wq|Wk|Wv]^T (blockIdx.x picks the weight), bias and cast
//      in the epilogue;
//   3. the attention kernel of attention.cu (climb_attention_fwd) on the
//      (B, S, H, 64) view of the (B, S, D) q, k, v through their strides:
//      ragged S is masked in the kernel, nothing is padded to a multiple of
//      16 and no padded key enters the softmax;
//   4. out_*_kernel: the out-projection GEMM with + bo, + x (in f32) and the
//      cast in its epilogue.
// Every product is device code of this package (gemm.cuh's tiles, attention.cu).
//
// Bound on the H100: operations. At the ViLT-B/32 serving shape (B=64, S=281,
// D=768, bf16) the four projections are 84.9 GFLOP and the attention 15.5
// GFLOP, 0.1015 ms at 989 TFLOP/s, against 170 MB of compulsory traffic
// (x, out, h, q, k, v, the weights; 0.05 ms). What the design does about it:
// - the projections (launches 2 and 4) run on gemm.cuh's Hopper tile: wgmma
//   m64n128k16 with f32 accumulators on 256 x 128 tiles, operands streamed
//   by TMA through a 4-stage mbarrier ring (one tensor map per operand,
//   encoded here on every call), the bias, residual and cast applied to the
//   f32 accumulators and the tile written in 16-byte stores; f32 inputs (the
//   parity path) use the CUDA-core GEMM;
// - the attention (launch 3) is attention.cu's kernel: in bf16 wgmma
//   m64n64k16 for Q.K^T and P.V, Q, K and V tiles fed by TMA from these
//   (B, S, E) buffers read as (B, S, H, 64) through their strides; scores
//   and probabilities never reach device memory (online softmax per 64-key
//   tile); the only intermediate that does is ctx, 27.6 MB written and read
//   once at the serving shape in bf16, which the backward reads again
//   instead of recomputing it;
// - later work: the LayerNorm as the q/k/v GEMM's prologue, and attention
//   fused with the out-projection per (batch row, 64-query tile) so that ctx
//   stays in shared memory.
#include <math.h>

#include "gemm.cuh"

using namespace climb;

// attention.cu
extern "C" int climb_attention_fwd(const void* q, const void* k, const void* v,
                                   const float* bias, void* out, int B, int S, int H, int D,
                                   const long long* q_strides, const long long* k_strides,
                                   const long long* v_strides, const long long* o_strides,
                                   long long bias_sb, float scale, int dtype, void* stream);

namespace {

constexpr int kHeadDim = 64;
constexpr int kLnThreads = 128;  // four rows per block, one warp each

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// h[row] = ((x - mean) * rsqrt(var + eps) * scale + bias) cast to T, with the
// two-pass f32 statistics of _kernel (mean, then the mean of squared deviations)
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ h, int rows, int D,
                     float eps) {
  const int row = blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * D;
  T* hr = h + static_cast<size_t>(row) * D;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) sum += to_float(xr[c]);
  const float mu = warp_sum(sum) / D;
  float sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = to_float(xr[c]) - mu;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
  for (int c = lane; c < D; c += 32)
    hr[c] = from_float<T>((to_float(xr[c]) - mu) * rstd * scale[c] + bias[c]);
}

// acc + bias[col], bias in f32
struct BiasF32 {
  const float* bias;
  __device__ __forceinline__ float operator()(int, int col, float acc) const {
    return acc + bias[col];
  }
};

// x[row][col] + (acc + bias[col]), summed in f32; without x (a tensor-parallel
// rank that does not hold the residual) acc + bias[col]
template <typename T>
struct BiasResidual {
  const float* bias;
  const T* x;
  int ld;
  __device__ __forceinline__ float operator()(int row, int col, float acc) const {
    const float y = acc + bias[col];
    return x != nullptr ? to_float(x[static_cast<size_t>(row) * ld + col]) + y : y;
  }
};

// the three projections' operands, picked by blockIdx.x / tiles_per_weight
template <typename T>
struct Qkv {
  const T* w[3];
  const float* b[3];
  T* out[3];
  // selects, not a dynamic index, which would copy the struct to local memory
  __device__ __forceinline__ const T* weight(int i) const {
    return i == 0 ? w[0] : i == 1 ? w[1] : w[2];
  }
  __device__ __forceinline__ const float* bias(int i) const {
    return i == 0 ? b[0] : i == 1 ? b[1] : b[2];
  }
  __device__ __forceinline__ T* output(int i) const {
    return i == 0 ? out[0] : i == 1 ? out[1] : out[2];
  }
};

// blockIdx.x / tiles picks the weight's tensor map, bias and output
__global__ void __launch_bounds__(kGemmThreads, 1)
    qkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap h,
                          const __grid_constant__ CUtensorMap wq,
                          const __grid_constant__ CUtensorMap wk,
                          const __grid_constant__ CUtensorMap wv, Qkv<__nv_bfloat16> p, int M,
                          int D, int E, int tiles) {
  const int which = blockIdx.x / tiles;
  const CUtensorMap* w = which == 0 ? &wq : which == 1 ? &wk : &wv;
  gemm_bf16_wgmma_tile(&h, w, p.output(which), M, E, D, blockIdx.y * kTileM,
                       (blockIdx.x % tiles) * kTileN, BiasF32{p.bias(which)});
}

__global__ void __launch_bounds__(kSimtThreads)
    qkv_f32_kernel(const float* __restrict__ h, Qkv<float> p, int M, int D, int E, int tiles) {
  const int which = blockIdx.x / tiles;
  gemm_f32_simt_tile(h, p.weight(which), p.output(which), M, E, D, blockIdx.y * kSM,
                     (blockIdx.x % tiles) * kSN, BiasF32{p.bias(which)});
}

__global__ void __launch_bounds__(kGemmThreads, 1)
    out_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap ctx,
                          const __grid_constant__ CUtensorMap wo, const float* __restrict__ bo,
                          const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                          int M, int D, int E) {
  gemm_bf16_wgmma_tile(&ctx, &wo, out, M, D, E, blockIdx.y * kTileM, blockIdx.x * kTileN,
                       BiasResidual<__nv_bfloat16>{bo, x, D});
}

__global__ void __launch_bounds__(kSimtThreads)
    out_f32_kernel(const float* __restrict__ ctx, const float* __restrict__ wo,
                   const float* __restrict__ bo, const float* __restrict__ x,
                   float* __restrict__ out, int M, int D, int E) {
  gemm_f32_simt_tile(ctx, wo, out, M, D, E, blockIdx.y * kSM, blockIdx.x * kSN,
                     BiasResidual<float>{bo, x, D});
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <typename T>
int launch(const void* x, const float* lns, const float* lnb, const void* wq, const float* bq,
           const void* wk, const float* bk, const void* wv, const float* bv, const void* wo,
           const float* bo, const float* key_bias, void* out, void* h, void* q, void* k, void* v,
           void* ctx, int B, int S, int D, int H, bool residual, float eps, int dtype,
           cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int M = B * S, E = H * kHeadDim;
  const T* xt = static_cast<const T*>(x);
  T* ht = static_cast<T*>(h);

  layernorm_kernel<T><<<(M + kLnThreads / 32 - 1) / (kLnThreads / 32), kLnThreads, 0, stream>>>(
      xt, lns, lnb, ht, M, D, eps);
  int err = last_error();
  if (err) return err;

  Qkv<T> p;
  p.w[0] = static_cast<const T*>(wq), p.w[1] = static_cast<const T*>(wk);
  p.w[2] = static_cast<const T*>(wv);
  p.b[0] = bq, p.b[1] = bk, p.b[2] = bv;
  p.out[0] = static_cast<T*>(q), p.out[1] = static_cast<T*>(k), p.out[2] = static_cast<T*>(v);
  const int bm = kBf16 ? kTileM : kSM, bn = kBf16 ? kTileN : kSN;
  const int tiles = (E + bn - 1) / bn, out_tiles = (D + bn - 1) / bn;
  const dim3 qkv_grid(3 * tiles, (M + bm - 1) / bm), out_grid(out_tiles, (M + bm - 1) / bm);
  if constexpr (kBf16) {
    // the operands' addresses change from call to call: encode their maps here
    CUtensorMap h_map, w_map[3];
    err = encode_kmajor_bf16(&h_map, h, M, D, kTileK, kTileM);
    for (int i = 0; i < 3 && !err; ++i)
      err = encode_kmajor_bf16(&w_map[i], p.w[i], E, D, kTileK, kTileN);
    if (!err) err = allow_gemm_smem(qkv_bf16_wgmma_kernel);
    if (err) return err;
    qkv_bf16_wgmma_kernel<<<qkv_grid, kGemmThreads, kGemmSmemBytes, stream>>>(
        h_map, w_map[0], w_map[1], w_map[2], p, M, D, E, tiles);
  } else {
    qkv_f32_kernel<<<qkv_grid, kSimtThreads, 0, stream>>>(ht, p, M, D, E, tiles);
  }
  err = last_error();
  if (err) return err;

  // (B, S, E) read as (B, S, H, 64): element strides of the B, S and H axes
  const long long strides[3] = {static_cast<long long>(S) * E, E, kHeadDim};
  err = climb_attention_fwd(q, k, v, key_bias, ctx, B, S, H, kHeadDim, strides, strides, strides,
                            strides, S, 1.f / sqrtf(static_cast<float>(kHeadDim)), dtype, stream);
  if (err) return err;

  if constexpr (kBf16) {
    CUtensorMap ctx_map, wo_map;
    err = encode_kmajor_bf16(&ctx_map, ctx, M, E, kTileK, kTileM);
    if (!err) err = encode_kmajor_bf16(&wo_map, wo, D, E, kTileK, kTileN);
    if (!err) err = allow_gemm_smem(out_bf16_wgmma_kernel);
    if (err) return err;
    out_bf16_wgmma_kernel<<<out_grid, kGemmThreads, kGemmSmemBytes, stream>>>(
        ctx_map, wo_map, bo, residual ? xt : nullptr, static_cast<T*>(out), M, D, E);
  } else {
    out_f32_kernel<<<out_grid, kSimtThreads, 0, stream>>>(
        static_cast<const T*>(ctx), static_cast<const T*>(wo), bo, residual ? xt : nullptr,
        static_cast<T*>(out), M, D, E);
  }
  return last_error();
}

}  // namespace

// x, out, h: (B, S, D) and q, k, v, ctx: (B, S, E) with E = 64 * H, contiguous
// in one dtype; wq, wk, wv: (E, D) and wo: (D, E) in that dtype, torch.nn.Linear's
// (out, in) layout; lns, lnb, bo: (D) f32; bq, bk, bv: (E) f32; key_bias: (B, S)
// contiguous f32. E == D for the whole layer; a tensor-parallel rank passes its
// H heads (E < D) and, off the first rank, add_residual 0 (out = ctx . Wo^T + bo).
// D % 64 == 0 and 16-byte aligned pointers (the wrapper checks these).
extern "C" int climb_fused_attention_sublayer(
    const void* x, const float* lns, const float* lnb, const void* wq, const float* bq,
    const void* wk, const float* bk, const void* wv, const float* bv, const void* wo,
    const float* bo, const float* key_bias, void* out, void* h, void* q, void* k, void* v,
    void* ctx, int B, int S, int D, int H, int add_residual, float eps, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || H * kHeadDim > D || D % kTileK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool res = add_residual != 0;
  if (dtype == kFloat32)
    return launch<float>(x, lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo, key_bias, out, h, q, k, v,
                         ctx, B, S, D, H, res, eps, dtype, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo, key_bias, out, h, q,
                                 k, v, ctx, B, S, D, H, res, eps, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
