// Masked multi-head attention backward: dq, dk, dv from q, k, v, the key
// bias and the output gradient dO.
//
// Replaces climb_tpu/ops/pallas_attention.py::_bwd_kernel (:69, wrapper
// _fa_bwd; at S > 1024 also the XLA _bwd_blockwise_xla, :179): recompute P in
// f32; dV = P^T.dO with P rounded to dO's type; dP = dO.V^T in f32; delta =
// rowsum(dP o P); dS = P o (dP - delta) * scale rounded to q's type; dQ =
// dS.K; dK = dS^T.Q; every product accumulates in f32; results cast to the
// input type. The blockwise path keeps P and dS in f32 and takes delta =
// rowsum(dO o O); the port keeps _bwd_kernel's roundings at every S, within
// 1-2 bf16 ulps of it (tests/test_torch_language.py).
//
// Two launches, one deterministic result (no atomics: two calls on the same
// inputs give bit-equal dq, dk and dv):
//   1. dq kernel, one block per (batch, head, 192-query tile). Sweep 1 over
//      64-key tiles keeps the running row max m, row sum l and an unnormalized
//      delta (sum of exp(s - m) * dP, rescaled like l), so m, 1/l and delta =
//      rowsum(dP o P) come out of one pass over the keys without the forward's
//      output. Sweep 2 recomputes P and dP per key tile and accumulates dQ =
//      dS.K in registers. It writes (m, 1/l) and delta (B, H, S) f32 for
//      launch 2.
//   2. dkdv kernel, one block per (batch, head, 128-key tile), K and V tiles
//      resident; it loops over 64-query tiles, recomputes P and dP from the
//      row statistics and delta, and accumulates dK and dV in registers.
// delta is rowsum(dP o P), as _bwd_kernel computes it (not FlashAttention-2's
// rowsum(dO o O), which needs the saved output and rounds differently in
// bf16). P is exp(s - m) * (1 / l) with m and 1/l kept apart, not
// exp(s - lse): a row whose keys are all masked has m = -1e9, where
// m + log(l) rounds log(l) away in f32 and P would come out l times too large.
// That is nine 64x64x64 tile products per (query tile, key tile) pair where
// FlashAttention-2 needs five: QK^T and dO.V^T are computed three times. One
// launch that sums dQ over key tiles with f32 atomics (FlashAttention-3's
// way) would save four of them and give up determinism.
//
// Bound on the H100, bf16: the five products of the backward are
// 10 * B*H*S^2*D FLOP against 7 * B*S*H*D elements of compulsory traffic (q,
// k, v, dO read; dq, dk, dv written): at the training shape (B=32, S=281,
// H=12, D=64) 19.4 GFLOP (20 us of tensor-core time) against 96.7 MB (29
// us at 3.35 TB/s), bytes-bound; at the language driver's (16, 1057, 12, 64)
// 137.3 GFLOP (139 us) against 182 MB (54 us), operations-bound. In f32 the
// bound is the 67 TFLOP/s of the CUDA cores (0.29 ms at the training shape).
// What the design does about it:
// - It never writes the (B, H, S, S) probabilities or dS to device memory,
//   and reads q, k, v and dO in their (B, S, H, D) layout (strided views of a
//   fused QKV output included) with no transpose or padding copy.
// - bf16: every product runs on wgmma m64n64k16 with f32 accumulators
//   (hopper.cuh). S = Q.K^T and dP = dO.V^T (S^T = K.Q^T and dP^T = V.dO^T in
//   launch 2) take both operands from shared memory; dQ = dS.K, dV = P^T.dO
//   and dK = dS^T.Q take dS, P^T or dS^T from registers (the accumulator of
//   the products before, re-packed as bf16 pairs) and K, dO or Q as the
//   MN-major B operand: the same 128-byte-swizzled tile read transposed, so
//   each tile is loaded once for both of its products.
// - Tiles arrive by TMA: 4-D tensor maps over {D, H, S, B} with the tensors'
//   strides, so rows past S read as zeros within each example. In each block
//   one warp of a producer warpgroup keeps the streamed tiles (K and V, or Q
//   and dO) in flight through a 4-stage ring of full and empty mbarriers, and
//   writes beside each stage its 64 side values: the key bias (-inf past S)
//   or each query's (m, 1/l) and delta (+inf, 0, 0 past S), so that the
//   consumers need no mask test. setmaxnreg hands the producer's registers
//   to the consumer warpgroups of 64 rows each: three in the dq kernel (160
//   registers a thread), two in the dkdv kernel (232: the dK, dV, S^T and
//   dP^T accumulators alone are 128). One block an SM.
// - Each consumer warpgroup issues the next tile's S and dP products right
//   behind the current tile's dQ (or dV and dK) products, so the tensor
//   cores have them queued while it works on scores; the other warpgroups'
//   score work overlaps its products. Scores are kept in log2 units, so exp
//   is one ex2 of the SFU, as __expf computes it; its error is far below the
//   bf16 roundings of P and dS.
// - f32 keeps f32 FMAs on the CUDA cores (the tensor cores' f32 is TF32), each
//   thread of 256 owning 4 x 4 of a tile held in padded f32 shared memory.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;        // head_dim the kernel takes (ViLT-B/32: 768 / 12)
constexpr int kT = 64;        // query rows and keys per tile

using climb::Strides;
using climb::strides3;

// ---- f32: CUDA cores ---------------------------------------------------------

constexpr int kThreads = 256; // 16 x 16 threads, each owns 4 rows x 4 columns
constexpr int kPad = kD + 1;  // row stride of the padded tiles (no bank conflicts)
constexpr int kTile = kT * kPad;

constexpr size_t kDqSmemBytes = (5 * kTile + kT) * sizeof(float);      // Q dO K V dS, bias
// K V Q dO P dS tiles; bias, row max, 1 / row sum, delta
constexpr size_t kDkdvSmemBytes = (6 * kTile + 4 * kT) * sizeof(float);

// rows [row0, row0 + 64) of one (b, h) slice into a padded f32 tile; rows
// past S are zero
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, long long ss,
                                          int row0, int S, int tid) {
  for (int idx = tid; idx < kT * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD, s = row0 + r;
    dst[r * kPad + d] = s < S ? src[s * ss + d] : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two padded tiles
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * kPad + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * kPad + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// sum over the 16 threads that share a row (lanes tx = 0..15 of one ty)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ bias, float* __restrict__ dq,
                            float2* __restrict__ ml_out, float* __restrict__ delta_out, int S,
                            int H, Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
                            long long bias_sb, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile;
  float* Ks = dOs + kTile;
  float* Vs = Ks + kTile;
  float* dSs = Vs + kTile;
  float* Bs = dSs + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: keys / head dims tx + 16 j
  const int ty = tid >> 4;  // row group: query rows ty + 16 i
  const int q0 = blockIdx.x * kT;
  const long long b = blockIdx.z, h = blockIdx.y;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* ob = dout + b * dos.b + h * dos.h;
  float* dqb = dq + b * dqs.b + h * dqs.h;
  const float* biasb = bias + b * bias_sb;

  load_tile(Qs, qb, qs.s, q0, S, tid);
  load_tile(dOs, ob, dos.s, q0, S, tid);

  // sweep 1: row max, row sum and unnormalized delta, online over key tiles
  float m[4], l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    dl[i] = 0.f;
  }
  float sc[4][4], dp[4][4];
  for (int k0 = 0; k0 < S; k0 += kT) {
    __syncthreads();  // the previous tile's readers are done (and Q, dO are staged)
    load_tile(Ks, kb, ks.s, k0, S, tid);
    load_tile(Vs, vb, vs.s, k0, S, tid);
    if (tid < kT) Bs[tid] = (k0 + tid < S) ? biasb[k0 + tid] : 0.f;
    __syncthreads();
    tile_dot(sc, Qs, Ks, ty, tx);
    tile_dot(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        sc[i][j] = (k0 + c < S) ? sc[i][j] * scale + Bs[c] : -INFINITY;
      }
      const float mx = row_max(fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3])));
      // every tile holds at least one key < S, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f, rd = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(sc[i][j] - m_new);
        rs += e;
        rd += e * dp[i][j];
      }
      l[i] = l[i] * alpha + row_sum(rs);
      dl[i] = dl[i] * alpha + row_sum(rd);
      m[i] = m_new;
    }
  }
  float inv_l[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv_l[i] = 1.f / l[i];
    delta[i] = dl[i] * inv_l[i];
    const int s = q0 + ty + 16 * i;
    if (tx == 0 && s < S) {
      const long long at = (b * H + h) * S + s;
      ml_out[at] = make_float2(m[i], inv_l[i]);
      delta_out[at] = delta[i];
    }
  }

  // sweep 2: dS per key tile, dQ += dS.K
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kT) {
    __syncthreads();
    load_tile(Ks, kb, ks.s, k0, S, tid);
    load_tile(Vs, vb, vs.s, k0, S, tid);
    if (tid < kT) Bs[tid] = (k0 + tid < S) ? biasb[k0 + tid] : 0.f;
    __syncthreads();
    tile_dot(sc, Qs, Ks, ty, tx);
    tile_dot(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (k0 + c < S) ? expf(sc[i][j] * scale + Bs[c] - m[i]) * inv_l[i] : 0.f;
        dSs[(ty + 16 * i) * kPad + c] = p * (dp[i][j] - delta[i]) * scale;
      }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kT; ++c) {
      float dsv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[c * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) dqb[s * dqs.s + tx + 16 * j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ bias, const float2* __restrict__ ml_in,
                              const float* __restrict__ delta_in, float* __restrict__ dk,
                              float* __restrict__ dv, int S, int H, Strides qs, Strides ks,
                              Strides vs, Strides dos, Strides dks, Strides dvs,
                              long long bias_sb, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile;
  float* Qs = Vs + kTile;
  float* dOs = Qs + kTile;
  float* Ps = dOs + kTile;
  float* dSs = Ps + kTile;
  float* Bs = dSs + kTile;
  float* Ms = Bs + kT;
  float* Il = Ms + kT;
  float* Dl = Il + kT;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kT;
  const long long b = blockIdx.z, h = blockIdx.y;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* ob = dout + b * dos.b + h * dos.h;
  float* dkb = dk + b * dks.b + h * dks.h;
  float* dvb = dv + b * dvs.b + h * dvs.h;
  const float2* mlb = ml_in + (b * H + h) * S;
  const float* deltab = delta_in + (b * H + h) * S;

  load_tile(Ks, kb, ks.s, k0, S, tid);
  load_tile(Vs, vb, vs.s, k0, S, tid);
  if (tid < kT) Bs[tid] = (k0 + tid < S) ? bias[b * bias_sb + k0 + tid] : 0.f;

  // thread (ty, tx) accumulates keys ty + 16 i, head dims tx + 16 j
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dka[i][j] = 0.f;
      dva[i][j] = 0.f;
    }
  float sc[4][4], dp[4][4];
  for (int q0 = 0; q0 < S; q0 += kT) {
    __syncthreads();  // the previous tile's readers are done (and K, V are staged)
    load_tile(Qs, qb, qs.s, q0, S, tid);
    load_tile(dOs, ob, dos.s, q0, S, tid);
    if (tid < kT) {
      const bool ok = q0 + tid < S;
      const float2 ml = ok ? mlb[q0 + tid] : make_float2(0.f, 0.f);
      Ms[tid] = ml.x;
      Il[tid] = ml.y;
      Dl[tid] = ok ? deltab[q0 + tid] : 0.f;
    }
    __syncthreads();
    // scores with queries ty + 16 i as rows and keys tx + 16 j as columns
    tile_dot(sc, Qs, Ks, ty, tx);
    tile_dot(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool row_ok = q0 + r < S;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p =
            (row_ok && k0 + c < S) ? expf(sc[i][j] * scale + Bs[c] - Ms[r]) * Il[r] : 0.f;
        Ps[r * kPad + c] = p;
        dSs[r * kPad + c] = p * (dp[i][j] - Dl[r]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kT; ++r) {
      float pv[4], dsv[4], ov[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * kPad + ty + 16 * i];
        dsv[i] = dSs[r * kPad + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ov[j] = dOs[r * kPad + tx + 16 * j];
        qv[j] = Qs[r * kPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dva[i][j] = fmaf(pv[i], ov[j], dva[i][j]);
          dka[i][j] = fmaf(dsv[i], qv[j], dka[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dkb[s * dks.s + tx + 16 * j] = dka[i][j];
      dvb[s * dvs.s + tx + 16 * j] = dva[i][j];
    }
  }
}

// ---- bf16: wgmma fed by TMA -------------------------------------------------

using bf16 = __nv_bfloat16;
using namespace climb;  // hopper.cuh's mbarrier, TMA, wgmma and softmax helpers

constexpr int kStages = 4;                   // depth of the ring of streamed tiles
constexpr unsigned kTileBytes = kT * kD * 2; // one 64 x 64 bf16 tile
constexpr unsigned kRingBytes = kStages * 2 * kTileBytes;

// A block of WGS consumer warpgroups, 64 rows each, and one producer
// warpgroup, of which one warp issues the copies; setmaxnreg moves the
// producer's registers to the consumers. Dynamic shared memory, from a
// 1024-byte boundary (the swizzle's period): the resident tiles (dq: WGS of
// Q, then WGS of dO; dkdv: of K, then of V), the ring (two streamed tiles a
// stage: K and V, or Q and dO), per stage 64 values beside the tiles (dq: the
// key bias; dkdv: each query's (m, 1/l) and delta), then the barriers: full
// and empty per stage, and one for the resident tiles.
template <int WGS, unsigned SideBytes>
struct Block {
  static constexpr int kWgs = WGS;
  static constexpr int kRows = kT * WGS;  // query rows (dq) or keys (dkdv)
  static constexpr int kThreads = 128 * (WGS + 1);
  static constexpr int kProducerRegs = WGS == 2 ? 40 : 24;
  static constexpr int kConsumerRegs = WGS == 2 ? 232 : 160;
  static_assert(128 * kProducerRegs + 128 * WGS * kConsumerRegs <= 65536, "one block an SM");
  static constexpr unsigned kResidentBytes = 2 * WGS * kTileBytes;
  static constexpr unsigned kSideOffset = kResidentBytes + kRingBytes;
  static constexpr unsigned kBarOffset = kSideOffset + SideBytes;
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + RingBarriers<kStages>::kBytes;
};
using DqBlock = Block<3, kStages * kT * sizeof(float)>;
using DkdvBlock = Block<2, kStages * kT * (sizeof(float2) + sizeof(float))>;

// the ring's barriers: full and empty per stage, and one for the resident tiles
using Barriers = RingBarriers<kStages>;

// the accumulators of a 64 x 64 product, rounded to bf16 rows of a
// (B, S, H, D) slice; rows at or past S are not stored
__device__ __forceinline__ void store_rows(bf16* dst, long long ss, const float (&c)[32],
                                           int row0, int S, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + (lane >> 2) + 8 * r;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + s * ss + 8 * j + 2 * (lane & 3)) =
          __floats2bfloat162_rn(c[4 * j + 2 * r], c[4 * j + 2 * r + 1]);
  }
}

__global__ void __launch_bounds__(DqBlock::kThreads, 1)
    attention_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __grid_constant__ CUtensorMap omap,
                                 const float* __restrict__ bias, bf16* __restrict__ dq,
                                 float2* __restrict__ ml_out, float* __restrict__ delta_out,
                                 int S, int H, Strides dqs, long long bias_sb, float scale) {
  constexpr int WGS = DqBlock::kWgs;
  unsigned base;
  unsigned char* smem = aligned_smem(base);
  const unsigned ring = base + DqBlock::kResidentBytes;
  float* key_bias = reinterpret_cast<float*>(smem + DqBlock::kSideOffset);
  const Barriers bar(base + DqBlock::kBarOffset);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * DqBlock::kRows, h = blockIdx.y, b = blockIdx.z;
  const int n_wg = min(WGS, (S - q0 + kT - 1) / kT);  // warpgroups with a query row < S
  const int n_k = (S + kT - 1) / kT;

  if (tid == 0) bar.init(n_wg);
  __syncthreads();

  if (warp >= 4 * WGS) {  // the producer warpgroup: one warp issues the copies
    setmaxnreg_dec<DqBlock::kProducerRegs>();
    if (warp > 4 * WGS) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar.ready, 2 * n_wg * kTileBytes);
      for (int w = 0; w < n_wg; ++w) {
        tma_load_4d(base + w * kTileBytes, &qmap, bar.ready, 0, h, q0 + kT * w, b);
        tma_load_4d(base + (WGS + w) * kTileBytes, &omap, bar.ready, 0, h, q0 + kT * w, b);
      }
    }
    // K and V tiles with the tile's key bias, -inf past S (so a key past S
    // gets s = -inf with no test in the consumers); once for each sweep
    const float* biasb = bias + b * bias_sb;
    for (int i = 0; i < 2 * n_k; ++i) {
      const int s = i % kStages, k0 = (i < n_k ? i : i - n_k) * kT;
      mbar_wait(bar.empty + 8 * s, ((i / kStages) & 1) ^ 1);  // round 0 passes at once
      for (int c = lane; c < kT; c += 32)
        key_bias[s * kT + c] = k0 + c < S ? biasb[k0 + c] * kLog2e : -INFINITY;
      if (lane == 0) {
        const unsigned t = ring + s * 2 * kTileBytes;
        mbar_arrive_expect_tx(bar.full + 8 * s, 2 * kTileBytes);
        tma_load_4d(t, &kmap, bar.full + 8 * s, 0, h, k0, b);
        tma_load_4d(t + kTileBytes, &vmap, bar.full + 8 * s, 0, h, k0, b);
      } else {
        mbar_arrive(bar.full + 8 * s);
      }
    }
    return;
  }

  setmaxnreg_inc<DqBlock::kConsumerRegs>();
  const int wg = warp >> 2;
  if (wg >= n_wg) return;  // all its rows are past S
  const int t = lane & 3;
  const int row0 = q0 + kT * wg + 16 * (warp & 3);  // this warp's first query row
  const unsigned qt = base + wg * kTileBytes, ot = base + (WGS + wg) * kTileBytes;
  const float scale_log2 = scale * kLog2e;
  mbar_wait(bar.ready, 0);

  // Ring index i < n_k is key tile i of sweep 1, n_k + i key tile i of sweep
  // 2. S = Q.K^T and dP = dO.V^T of ring index i; those of index i + 1 are
  // issued behind index i's dS.K, so the tensor cores have them queued.
  float s[32], dp[32];
  auto issue_scores = [&](int i) {
    const int st = i % kStages;
    const unsigned kt = ring + st * 2 * kTileBytes, vt = kt + kTileBytes;
    mbar_wait(bar.full + 8 * st, (i / kStages) & 1);
    wgmma_fence();
    wgmma_m64n64k16_ss_first(s, sw128_desc(qt), sw128_desc(kt));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      wgmma_m64n64k16_ss(s, sw128_desc(qt + 32 * kk), sw128_desc(kt + 32 * kk));
    wgmma_m64n64k16_ss_first(dp, sw128_desc(ot), sw128_desc(vt));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      wgmma_m64n64k16_ss(dp, sw128_desc(ot + 32 * kk), sw128_desc(vt + 32 * kk));
    wgmma_commit();
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float inv_l[2], inv_l_scale[2], delta[2];
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_operand(acc);  // zeroed here, not next to its first wgmma
  issue_scores(0);
  for (int i = 0; i < 2 * n_k; ++i) {
    const int st = i % kStages;
    wgmma_wait<0>();  // index i's S and dP, and index i - 1's dS.K
    fence_operand(s);
    fence_operand(dp);
    fence_operand(acc);
    if (i > n_k) bar.release((i - 1) % kStages, lane);  // dS.K has read K
    const float* bt = key_bias + st * kT;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bc = bt[8 * j + 2 * t + e];
        s[4 * j + e] = fmaf(s[4 * j + e], scale_log2, bc);
        s[4 * j + 2 + e] = fmaf(s[4 * j + 2 + e], scale_log2, bc);
      }
    if (i < n_k) {
      bar.release(st, lane);
      // sweep 1: row max, row sum and unnormalized delta, online
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      float m_new[2], rs[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m[r], quad_max(mx[r]));  // finite
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        const float p = exp2_approx(s[e] - m_new[r]);
        rs[r] += p;
        rd[r] += p * dp[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = exp2_approx(m[r] - m_new[r]);
        l[r] = l[r] * alpha + quad_sum(rs[r]);
        dl[r] = dl[r] * alpha + quad_sum(rd[r]);
        m[r] = m_new[r];
      }
      if (i == n_k - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          inv_l[r] = 1.f / l[r];
          inv_l_scale[r] = inv_l[r] * scale;
          delta[r] = dl[r] * inv_l[r];
          const int row = row0 + (lane >> 2) + 8 * r;
          if (t == 0 && row < S) {
            const long long at = (static_cast<long long>(b) * H + h) * S + row;
            ml_out[at] = make_float2(m[r], inv_l[r]);
            delta_out[at] = delta[r];
          }
        }
      }
    } else {
      // sweep 2: dS, then dQ += dS.K with K as the MN-major B operand
      unsigned dsf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 8 * kk; e < 8 * kk + 8; ++e) {
          const int r = (e >> 1) & 1;
          // keys past S have s = -inf, so p = 0
          s[e] = exp2_approx(s[e] - m[r]) * inv_l_scale[r] * (dp[e] - delta[r]);
        }
        a_from_acc(dsf[kk], s, kk);
      }
      const unsigned kt = ring + st * 2 * kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs(acc, dsf[kk], sw128_mn_desc(kt + 2048 * kk));
      wgmma_commit();
    }
    if (i + 1 < 2 * n_k) issue_scores(i + 1);
  }
  wgmma_wait<0>();
  fence_operand(acc);
  bar.release((2 * n_k - 1) % kStages, lane);
  store_rows(dq + b * dqs.b + h * dqs.h, dqs.s, acc, row0, S, lane);
}

__global__ void __launch_bounds__(DkdvBlock::kThreads, 1)
    attention_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                                   const __grid_constant__ CUtensorMap kmap,
                                   const __grid_constant__ CUtensorMap vmap,
                                   const __grid_constant__ CUtensorMap omap,
                                   const float* __restrict__ bias,
                                   const float2* __restrict__ ml_in,
                                   const float* __restrict__ delta_in, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int S, int H, Strides dks,
                                   Strides dvs, long long bias_sb, float scale) {
  constexpr int WGS = DkdvBlock::kWgs;
  unsigned base;
  unsigned char* smem = aligned_smem(base);
  const unsigned ring = base + DkdvBlock::kResidentBytes;
  float2* q_ml = reinterpret_cast<float2*>(smem + DkdvBlock::kSideOffset);
  float* q_delta = reinterpret_cast<float*>(q_ml + kStages * kT);
  const Barriers bar(base + DkdvBlock::kBarOffset);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * DkdvBlock::kRows, h = blockIdx.y, b = blockIdx.z;
  const int n_wg = min(WGS, (S - k0 + kT - 1) / kT);  // warpgroups with a key < S
  const int n_q = (S + kT - 1) / kT;

  if (tid == 0) bar.init(n_wg);
  __syncthreads();

  if (warp >= 4 * WGS) {  // the producer warpgroup: one warp issues the copies
    setmaxnreg_dec<DkdvBlock::kProducerRegs>();
    if (warp > 4 * WGS) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar.ready, 2 * n_wg * kTileBytes);
      for (int w = 0; w < n_wg; ++w) {
        tma_load_4d(base + w * kTileBytes, &kmap, bar.ready, 0, h, k0 + kT * w, b);
        tma_load_4d(base + (WGS + w) * kTileBytes, &vmap, bar.ready, 0, h, k0 + kT * w, b);
      }
    }
    // Q and dO tiles with each query's (m, 1/l) and delta; a query past S
    // gets m = +inf and 1/l = 0, so its P and dS are 0 with no test in the
    // consumers
    const long long at = (static_cast<long long>(b) * H + h) * S;
    const float2* mlb = ml_in + at;
    const float* deltab = delta_in + at;
    for (int i = 0; i < n_q; ++i) {
      const int s = i % kStages, q0 = i * kT;
      mbar_wait(bar.empty + 8 * s, ((i / kStages) & 1) ^ 1);  // round 0 passes at once
      for (int c = lane; c < kT; c += 32) {
        const bool ok = q0 + c < S;
        q_ml[s * kT + c] = ok ? mlb[q0 + c] : make_float2(INFINITY, 0.f);
        q_delta[s * kT + c] = ok ? deltab[q0 + c] : 0.f;
      }
      if (lane == 0) {
        const unsigned t = ring + s * 2 * kTileBytes;
        mbar_arrive_expect_tx(bar.full + 8 * s, 2 * kTileBytes);
        tma_load_4d(t, &qmap, bar.full + 8 * s, 0, h, q0, b);
        tma_load_4d(t + kTileBytes, &omap, bar.full + 8 * s, 0, h, q0, b);
      } else {
        mbar_arrive(bar.full + 8 * s);
      }
    }
    return;
  }

  setmaxnreg_inc<DkdvBlock::kConsumerRegs>();
  const int wg = warp >> 2;
  if (wg >= n_wg) return;  // all its keys are past S
  const int t = lane & 3;
  const int row0 = k0 + kT * wg + 16 * (warp & 3);  // this warp's first key
  const unsigned kt = base + wg * kTileBytes, vt = base + (WGS + wg) * kTileBytes;
  const float scale_log2 = scale * kLog2e;
  // this thread's keys row0 + lane/4 and 8 on: their bias, -inf past S
  float key_bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = row0 + (lane >> 2) + 8 * r;
    key_bias[r] = key < S ? bias[b * bias_sb + key] * kLog2e : -INFINITY;
  }
  mbar_wait(bar.ready, 0);

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  fence_operand(dka);  // zeroed here, not next to their first wgmma
  fence_operand(dva);
  // S^T = K.Q^T and dP^T = V.dO^T of query tile i: keys as rows, queries as
  // columns. Tile i + 1's are issued right behind tile i's dV and dK, so the
  // tensor cores have the next products queued while those run.
  float sc[32], dpt[32];
  auto issue_scores = [&](int i) {
    const int st = i % kStages;
    const unsigned qs = ring + st * 2 * kTileBytes, os = qs + kTileBytes;
    mbar_wait(bar.full + 8 * st, (i / kStages) & 1);
    wgmma_fence();
    wgmma_m64n64k16_ss_first(sc, sw128_desc(kt), sw128_desc(qs));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      wgmma_m64n64k16_ss(sc, sw128_desc(kt + 32 * kk), sw128_desc(qs + 32 * kk));
    wgmma_m64n64k16_ss_first(dpt, sw128_desc(vt), sw128_desc(os));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      wgmma_m64n64k16_ss(dpt, sw128_desc(vt + 32 * kk), sw128_desc(os + 32 * kk));
    wgmma_commit();
  };
  issue_scores(0);
  for (int it = 0; it < n_q; ++it) {
    const int st = it % kStages;
    const unsigned qs = ring + st * 2 * kTileBytes, os = qs + kTileBytes;
    wgmma_wait<0>();  // tile it's S^T and dP^T, and tile it - 1's dV and dK
    fence_operand(sc);
    fence_operand(dpt);
    fence_operand(dka);
    fence_operand(dva);
    if (it > 0) bar.release((it - 1) % kStages, lane);
    const float2* mlt = q_ml + st * kT;
    const float* dlt = q_delta + st * kT;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float2 ml = mlt[c];
        const float dl = dlt[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float p = exp2_approx(fmaf(sc[i], scale_log2, key_bias[r]) - ml.x) * ml.y;
          sc[i] = p;
          dpt[i] = p * (dpt[i] - dl) * scale;
        }
      }
    // dV += P^T.dO and dK += dS^T.Q, with dO and Q as MN-major B operands
    unsigned pf[4][4], dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_from_acc(pf[kk], sc, kk);
      a_from_acc(dsf[kk], dpt, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs(dva, pf[kk], sw128_mn_desc(os + 2048 * kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs(dka, dsf[kk], sw128_mn_desc(qs + 2048 * kk));
    wgmma_commit();
    if (it + 1 < n_q) issue_scores(it + 1);
  }
  wgmma_wait<0>();
  fence_operand(dka);
  fence_operand(dva);
  bar.release((n_q - 1) % kStages, lane);
  store_rows(dk + b * dks.b + h * dks.h, dks.s, dka, row0, S, lane);
  store_rows(dv + b * dvs.b + h * dvs.h, dvs.s, dva, row0, S, lane);
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const float* bias,
                void* dq, void* dk, void* dv, float2* ml, float* delta, int B, int S, int H,
                const long long* qs, const long long* ks, const long long* vs,
                const long long* dos, const long long* dqs, const long long* dks,
                const long long* dvs, long long bias_sb, float scale, cudaStream_t stream) {
  // the wrapper checks these and says which tensor fails; TMA needs the same
  if (!aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs) || !aligned16(dout, dos) ||
      !aligned16(dq, dqs) || !aligned16(dk, dks) || !aligned16(dv, dvs))
    return static_cast<int>(cudaErrorMisalignedAddress);
  // the operands' addresses and strides change from call to call: encode here
  CUtensorMap qm, km, vm, om;
  int err = encode_bshd_bf16(&qm, q, B, S, H, qs);
  if (!err) err = encode_bshd_bf16(&km, k, B, S, H, ks);
  if (!err) err = encode_bshd_bf16(&vm, v, B, S, H, vs);
  if (!err) err = encode_bshd_bf16(&om, dout, B, S, H, dos);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(attention_bwd_dq_bf16_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(DqBlock::kSmemBytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaFuncSetAttribute(attention_bwd_dkdv_bf16_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(DkdvBlock::kSmemBytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 dq_grid((S + DqBlock::kRows - 1) / DqBlock::kRows, H, B);
  attention_bwd_dq_bf16_kernel<<<dq_grid, DqBlock::kThreads, DqBlock::kSmemBytes, stream>>>(
      qm, km, vm, om, bias, static_cast<bf16*>(dq), ml, delta, S, H, strides3(dqs), bias_sb,
      scale);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 dkdv_grid((S + DkdvBlock::kRows - 1) / DkdvBlock::kRows, H, B);
  attention_bwd_dkdv_bf16_kernel<<<dkdv_grid, DkdvBlock::kThreads, DkdvBlock::kSmemBytes,
                                   stream>>>(
      qm, km, vm, om, bias, ml, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H,
      strides3(dks), strides3(dvs), bias_sb, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, const void* dout, const float* bias,
               void* dq, void* dk, void* dv, float2* ml, float* delta, int B, int S, int H,
               const long long* qs, const long long* ks, const long long* vs,
               const long long* dos, const long long* dqs, const long long* dks,
               const long long* dvs, long long bias_sb, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kDqSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDkdvSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kT - 1) / kT, H, B);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* ot = static_cast<const float*>(dout);
  attention_bwd_dq_kernel<<<grid, kThreads, kDqSmemBytes, stream>>>(
      qt, kt, vt, ot, bias, static_cast<float*>(dq), ml, delta, S, H, strides3(qs),
      strides3(ks), strides3(vs), strides3(dos), strides3(dqs), bias_sb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<<<grid, kThreads, kDkdvSmemBytes, stream>>>(
      qt, kt, vt, ot, bias, ml, delta, static_cast<float*>(dk), static_cast<float*>(dv), S, H,
      strides3(qs), strides3(ks), strides3(vs), strides3(dos), strides3(dks), strides3(dvs),
      bias_sb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/dout/dq/dk/dv: (B, S, H, D) with D == 64 contiguous; *_strides =
// element strides of the B, S and H axes. bias: (B, S) f32 rows bias_sb apart.
// ml: (B, H, S, 2) contiguous f32 scratch holding each row's (max, 1 / sum),
// the max in log2 units for bf16; delta: (B, H, S) f32 scratch; both written
// by the first launch and read by the second.
extern "C" int climb_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   const float* bias, void* dq, void* dk, void* dv, float* ml,
                                   float* delta, int B, int S, int H, int D,
                                   const long long* q_strides, const long long* k_strides,
                                   const long long* v_strides, const long long* do_strides,
                                   const long long* dq_strides, const long long* dk_strides,
                                   const long long* dv_strides, long long bias_sb, float scale,
                                   int dtype, void* stream) {
  if (D != kD || B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* ml2 = reinterpret_cast<float2*>(ml);
  if (dtype == climb::kFloat32)
    return launch_f32(q, k, v, dout, bias, dq, dk, dv, ml2, delta, B, S, H, q_strides,
                         k_strides, v_strides, do_strides, dq_strides, dk_strides, dv_strides,
                         bias_sb, scale, s);
  if (dtype == climb::kBFloat16)
    return launch_bf16(q, k, v, dout, bias, dq, dk, dv, ml2, delta, B, S, H,
                                 q_strides, k_strides, v_strides, do_strides, dq_strides,
                                 dk_strides, dv_strides, bias_sb, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
