// The FFN backward's recompute of the (rows, F) intermediate, bf16, one launch:
//   h1  = x . W1^T + b1              (f32 accumulators)
//   g   = GELU_exact(h1)             rounded once to bf16
//   dg  = dy . W2                    (f32 accumulators)
//   dh1 = dg * GELU'(h1)             rounded once to bf16
// with GELU'(h) = 0.5 (1 + erf(h / sqrt 2)) + h phi(h): one erff and one expf
// an element. dx = dh1 . W1, dW1 = dh1^T . x and dW2 = dy^T . g are plain
// products that the wrapper (ops/mlp.py) leaves to torch.matmul.
//
// Replaces no TPU kernel: climb_tpu/ops/pallas_mlp.py::_fused_mlp_bwd (:83) is
// XLA, bf16 operands with preferred_element_type=f32, which the tensor cores
// compute exactly (bf16 x bf16 products summed in f32). The port's plain
// version (ops/mlp.py: mlp_bwd_recompute_plain) upcasts the operands to f32,
// which on the card runs both products on the CUDA cores and the GELU / GELU'
// chain as a dozen f32 elementwise passes over (rows, F) tensors.
//
// Bound on the H100: operations. At the ViLT-B/32 train shape (17,984 rows,
// D 768, F 3072) the two products are 169.7 GFLOP, 0.1716 ms at 989 TFLOP/s,
// against 115 MB of compulsory traffic (x and dy read, both weights and b1
// read, g and dh1 written: 34 us at 3.35 TB/s). What the design does about it:
// - Both products run on wgmma m64n128k16 with f32 accumulators, operands from
//   shared memory. A block owns a 128-row x 128-column tile of the
//   intermediate: two consumer warpgroups of 64 rows, each holding the h1 and
//   the dg accumulators of its rows (128 registers a thread), and a producer
//   warpgroup whose registers setmaxnreg hands to the consumers (232 a
//   consumer thread, 40 a producer thread). One block an SM.
// - A producer thread streams 64-deep slices of x, dy, W1 and W2 by TMA
//   (hopper.cuh; 128-byte swizzle, rows past the tensor zero-filled) into a
//   3-stage ring of 64 KB stages with a full and an empty mbarrier per stage.
//   W2 is (D, F) row-major, so its tile is the MN-major B operand of
//   dy . W2: two 64 x 64 boxes read with wgmma's transpose bit, no transposed
//   copy of W2. Each consumer keeps one wgmma group in flight and releases a
//   stage once the group that read it has completed.
// - The epilogue runs on the two accumulators in registers (the same fragment
//   layout, so element i of both is one (row, column)); no f32 (rows, F)
//   tensor reaches device memory. g and dh1 are each rounded once to bf16,
//   where the plain version rounds them, staged in the (then idle) ring and
//   written in 16-byte stores.
// - Every output element belongs to one block and no atomics are used: a
//   second call on the same inputs is bit-equal.
// D % 64 == 0 and F % 64 == 0, 16-byte aligned contiguous operands (the
// wrapper checks them through check_gemm_operands).
#include <math.h>

#include "hopper.cuh"

using namespace climb;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;    // rows of x and dy a block: two consumer warpgroups of 64
constexpr int kCols = 128;    // columns of the intermediate (F) a block
constexpr int kDepth = 64;    // D a stage: one 128-byte swizzle row of bf16
constexpr int kStages = 3;    // 192 KB: one block an SM
constexpr unsigned kXBytes = kRows * kDepth * 2;        // a slice of x or of dy, 16 KB
constexpr unsigned kWBytes = kCols * kDepth * 2;        // a slice of W1 or of W2, 16 KB
constexpr unsigned kHalfW2 = 64 * kDepth * 2;           // one 64 x 64 box of W2
constexpr unsigned kStageBytes = 2 * kXBytes + 2 * kWBytes;  // x, dy, W1, W2
constexpr int kThreads = 3 * 128;  // two consumer warpgroups and a producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "one block an SM");
constexpr unsigned kBarOffset = kStages * kStageBytes;  // full, then empty, per stage
constexpr size_t kSmemBytes = 1024 + kBarOffset + 2 * kStages * 8;
constexpr int kOutLd = kCols + 8;  // bf16 staging row stride: conflict-free 4-byte stores
static_assert(2 * kRows * kOutLd * 2 <= kBarOffset, "the epilogue stages g and dh1 in the ring");

__global__ void __launch_bounds__(kThreads, 1)
    mlp_bwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                              const __grid_constant__ CUtensorMap dy_map,
                              const __grid_constant__ CUtensorMap w1_map,
                              const __grid_constant__ CUtensorMap w2_map,
                              const bf16* __restrict__ b1, bf16* __restrict__ g,
                              bf16* __restrict__ dh1, int M, int D, int F) {
  unsigned ring;
  unsigned char* smem = aligned_smem(ring);
  const unsigned full = ring + kBarOffset, empty = full + 8 * kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * kCols;
  const int nk = D / kDepth;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread issues the copies
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages, k0 = i * kDepth;
        mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);  // round 0 passes at once
        const unsigned st = ring + s * kStageBytes, bar = full + 8 * s;
        const unsigned w2 = st + 2 * kXBytes + kWBytes;
        mbar_arrive_expect_tx(bar, kStageBytes);
        tma_load_2d(st, &x_map, bar, k0, m0);
        tma_load_2d(st + kXBytes, &dy_map, bar, k0, m0);
        tma_load_2d(st + 2 * kXBytes, &w1_map, bar, k0, n0);
        tma_load_2d(w2, &w2_map, bar, n0, k0);
        tma_load_2d(w2 + kHalfW2, &w2_map, bar, n0 + 64, k0);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  float acc_h[64], acc_d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_h[i] = acc_d[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const unsigned st = ring + s * kStageBytes;
    const unsigned xa = st + wg * (kXBytes / 2), da = xa + kXBytes;
    const unsigned w1 = st + 2 * kXBytes, w2 = w1 + kWBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk)
      wgmma_m64n128k16(acc_h, sw128_desc(xa + 32 * kk), sw128_desc(w1 + 32 * kk));
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk)
      wgmma_m64n128k16_mn(acc_d, sw128_desc(da + 32 * kk), sw128_mn_desc(w2 + 2048 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the group of step i - 1 is done: its stage may be refilled
    if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % kStages));
  }
  wgmma_wait<0>();

  // both warpgroups are done reading the ring before it holds the output
  bar_sync_named(1, 256);
  bf16* g_st = reinterpret_cast<bf16*>(smem) + wg * 64 * kOutLd;
  bf16* d_st = g_st + kRows * kOutLd;
  const int r0 = (warp & 3) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
    const int col = 8 * j + c0;
    const float2 bias = n0 + col < F
        ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + n0 + col))
        : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float gv[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = acc_h[4 * j + 2 * h + e] + (e ? bias.y : bias.x);
        const float cdf = 0.5f * (1.f + erff(y * 0.70710678118654752f));
        const float pdf = expf(-0.5f * y * y) * 0.3989422804014327f;
        gv[e] = y * cdf;
        dv[e] = acc_d[4 * j + 2 * h + e] * (cdf + y * pdf);
      }
      const int at = (r0 + 8 * h) * kOutLd + col;
      *reinterpret_cast<__nv_bfloat162*>(g_st + at) = __floats2bfloat162_rn(gv[0], gv[1]);
      *reinterpret_cast<__nv_bfloat162*>(d_st + at) = __floats2bfloat162_rn(dv[0], dv[1]);
    }
  }
  bar_sync_named(2 + wg, 128);  // this warpgroup's rows are staged
  // each thread: 16-byte chunks of this warpgroup's 64 rows, g then dh1
  const int t = tid & 127;
#pragma unroll 4
  for (int e = 0; e < 2 * 64 * kCols / 8 / 128; ++e) {
    const int chunk = t + 128 * e, which = chunk / (64 * kCols / 8);
    const int c = chunk % (64 * kCols / 8), r = c / (kCols / 8), col = c % (kCols / 8) * 8;
    const int gm = m0 + wg * 64 + r, gn = n0 + col;
    if (gm >= M || gn >= F) continue;
    const bf16* src = (which ? d_st : g_st) + r * kOutLd + col;
    bf16* dst = (which ? dh1 : g) + static_cast<size_t>(gm) * F + gn;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
}

}  // namespace

// g, dh1 (M, F) from x, dy (M, D), w1 (F, D), b1 (F), w2 (D, F), all bf16,
// row-major and contiguous; D % 64 == 0, F % 64 == 0 and 16-byte aligned
// pointers (the wrapper checks them).
extern "C" int climb_mlp_bwd_recompute(const void* x, const void* w1, const void* b1,
                                       const void* w2, const void* dy, void* g, void* dh1,
                                       int M, int D, int F, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || D % kDepth != 0 || F % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the operands' addresses change from call to call: encode their maps here
  CUtensorMap x_map, dy_map, w1_map, w2_map;
  int err = encode_kmajor_bf16(&x_map, x, M, D, kDepth, kRows);
  if (!err) err = encode_kmajor_bf16(&dy_map, dy, M, D, kDepth, kRows);
  if (!err) err = encode_kmajor_bf16(&w1_map, w1, F, D, kDepth, kCols);
  // W2 (D, F): boxes of 64 columns of F by 64 rows of D
  if (!err) err = encode_kmajor_bf16(&w2_map, w2, D, F, 64, kDepth);
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        mlp_bwd_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
  if (err) return err;
  const dim3 grid((F + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  mlp_bwd_bf16_wgmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, dy_map, w1_map, w2_map, static_cast<const bf16*>(b1), static_cast<bf16*>(g),
      static_cast<bf16*>(dh1), M, D, F);
  return static_cast<int>(cudaGetLastError());
}
