// Masked multi-head attention backward: dq, dk, dv from q, k, v, the key
// bias and the output gradient dO.
//
// Replaces climb_tpu/ops/pallas_attention.py::_bwd_kernel (:69, wrapper
// _fa_bwd; at S > 1024 also the XLA _bwd_blockwise_xla, :179): recompute P in
// f32; dV = P^T.dO with P rounded to dO's type; dP = dO.V^T in f32; delta =
// rowsum(dP o P); dS = P o (dP - delta) * scale rounded to q's type; dQ =
// dS.K; dK = dS^T.Q; every product accumulates in f32; results cast to the
// input type.
//
// Two launches, one deterministic result (no atomics):
//   1. dq kernel, one block per (batch, head, 64-query tile). Sweep 1 over
//      64-key tiles keeps the running row max m, row sum l and an unnormalized
//      delta (sum of exp(s - m) * dP, rescaled like l), so
//      m, 1/l and delta = rowsum(dP o P) come out of one pass over
//      the keys without the forward's output. Sweep 2 recomputes P and dP
//      per key tile and accumulates dQ = dS.K in registers. It writes (m, 1/l) and
//      delta (B, H, S) f32 for launch 2.
//   2. dkdv kernel, one block per (batch, head, 64-key tile), K and V tiles
//      staged once; it loops over 64-query tiles, recomputes P and dP from
//      the row statistics and delta, and accumulates dK and dV in registers.
// delta is rowsum(dP o P), as _bwd_kernel computes it (not FlashAttention-2's
// rowsum(dO o O), which needs the saved output and rounds differently in
// bf16). P is exp(s - m) * (1 / l) with m and 1/l kept apart, not
// exp(s - lse): a row whose keys are all masked has m = -1e9, where
// m + log(l) rounds log(l) away in f32 and P would come out l times too large.
// That is nine 64x64x64 tile products per (query tile, key tile) pair where
// FlashAttention-2 needs five: QK^T and dO.V^T are computed three times.
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
//   reads q, k, v and dO in their (B, S, H, D) layout through strides (no
//   transpose or padding copy), and masks the ragged end of S itself.
// - bf16: four warps per block, each owning 16 of its 64 rows, run every
//   product on the tensor cores (mma.sync m16n8k16, f32 accumulators). The
//   resident tiles (Q and dO, or K and V) are loaded once as A fragments; the
//   streamed tiles (K and V, or Q and dO) stay bf16 in shared memory with a
//   padded row stride and are double-buffered by 16-byte cp.async, rows past S
//   zero-filled. Scores never leave registers: the dq launch reduces rows
//   within a quad of lanes and re-packs dS's C fragments as the A operand of
//   dS.K; the dkdv launch computes S^T = K.Q^T and dP^T = V.dO^T with keys as
//   rows, so P^T and dS^T are A operands of P^T.dO and dS^T.Q, and reads each
//   query's (m, 1/l) and delta from shared memory; it re-reads K's and V's
//   fragments by ldmatrix rather than holding them, so three of its blocks fit
//   on an SM without spilling. exp is __expf (the SFU's
//   ex2; its error is far below the bf16 roundings of P and dS).
// - f32 keeps f32 FMAs on the CUDA cores (the tensor cores' f32 is TF32), each
//   thread of 256 owning 4 x 4 of a tile held in padded f32 shared memory.
#include <math.h>

#include "tc.cuh"

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

// ---- bf16: tensor cores -------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;     // four warps of 16 rows
constexpr int kLd = kD + 8;         // bf16 row stride of the tiles: 144 bytes
constexpr int kTcTile = kT * kLd;   // elements of one 64-row tile
// Q, dO, two K and two V tiles, two blocks of 64 key-bias values
constexpr size_t kDqTcSmemBytes = 6 * kTcTile * sizeof(bf16) + 2 * kT * sizeof(float);
// K, V, two Q and two dO tiles, two blocks of 64 (m, 1/l) and 64 delta
constexpr size_t kDkdvTcSmemBytes =
    6 * kTcTile * sizeof(bf16) + 2 * kT * (sizeof(float2) + sizeof(float));

__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// the warp's 16 x 64 f32 C fragments as bf16 rows of a (B, S, H, D) slice
__device__ __forceinline__ void store_rows(bf16* dst, long long ss, const float (&c)[8][4],
                                           int row0, int S, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + (lane >> 2) + 8 * r;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + s * ss + 8 * j + 2 * (lane & 3)) =
          __floats2bfloat162_rn(c[j][2 * r], c[j][2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kTcThreads)
    attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ bias, bf16* __restrict__ dq,
                                 float2* __restrict__ ml_out, float* __restrict__ delta_out,
                                 int S, int H, Strides qs, Strides ks, Strides vs, Strides dos,
                                 Strides dqs, long long bias_sb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTcTile;
  bf16* Ks = dOs + kTcTile;     // two buffers
  bf16* Vs = Ks + 2 * kTcTile;  // two buffers
  float* Bs = reinterpret_cast<float*>(Vs + 2 * kTcTile);  // two buffers of 64

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int q0 = blockIdx.x * kT;
  const long long b = blockIdx.z, h = blockIdx.y;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const float* biasb = bias + b * bias_sb;

  auto stage = [&](int buf, int k0) {
    climb::cp_async_tile64<kTcThreads, kLd>(Ks + buf * kTcTile, kb, ks.s, k0, S, tid);
    climb::cp_async_tile64<kTcThreads, kLd>(Vs + buf * kTcTile, vb, vs.s, k0, S, tid);
    if (tid < kT) {
      const bool ok = k0 + tid < S;
      climb::cp_async4(Bs + buf * kT + tid, ok ? biasb + k0 + tid : biasb, ok);
    }
  };
  climb::cp_async_tile64<kTcThreads, kLd>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S, tid);
  climb::cp_async_tile64<kTcThreads, kLd>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S, tid);
  stage(0, 0);
  climb::cp_async_commit();

  unsigned qf[4][4], of[4][4];  // A fragments of the warp's 16 rows of Q and dO
  const int n_tiles = (S + kT - 1) / kT;
  float s[8][4], dp[8][4];
  // scores of key tile `it` in s (masked, scaled, biased) and dP in dp
  auto scores = [&](int it) {
    const int buf = it & 1, k0 = it * kT;
    if (it + 1 < n_tiles) stage(buf ^ 1, k0 + kT);
    climb::cp_async_commit();
    climb::cp_async_wait<1>();
    __syncthreads();
    zero(s);
    zero(dp);
    climb::mma_abt(s, qf, Ks + buf * kTcTile, kLd, lane);
    climb::mma_abt(dp, of, Vs + buf * kTcTile, kLd, lane);
    const float* Bt = Bs + buf * kT;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const bool ok = k0 + c < S;
        const float bc = Bt[c];
        s[j][e] = ok ? s[j][e] * scale + bc : -INFINITY;
        s[j][2 + e] = ok ? s[j][2 + e] * scale + bc : -INFINITY;
      }
  };

  // sweep 1: row max, row sum and unnormalized delta, online over key tiles
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    if (it == 0) {
      climb::cp_async_wait<0>();
      __syncthreads();
      climb::load_a(qf, Qs + warp * 16 * kLd, kLd, lane);
      climb::load_a(of, dOs + warp * 16 * kLd, kLd, lane);
    }
    scores(it);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float m_new[2], rs[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m[r], climb::quad_max(mx[r]));  // finite
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m_new[e >> 1]);
        rs[e >> 1] += p;
        rd[e >> 1] += p * dp[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float alpha = __expf(m[r] - m_new[r]);
      l[r] = l[r] * alpha + climb::quad_sum(rs[r]);
      dl[r] = dl[r] * alpha + climb::quad_sum(rd[r]);
      m[r] = m_new[r];
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  float inv_l[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv_l[r] = 1.f / l[r];
    delta[r] = dl[r] * inv_l[r];
    const int s_row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (t == 0 && s_row < S) {
      const long long at = (b * H + h) * S + s_row;
      ml_out[at] = make_float2(m[r], inv_l[r]);
      delta_out[at] = delta[r];
    }
  }

  // sweep 2: dS per key tile, dQ += dS.K
  stage(0, 0);
  climb::cp_async_commit();
  float acc[8][4];
  zero(acc);
  for (int it = 0; it < n_tiles; ++it) {
    scores(it);
    unsigned dsf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        // masked keys have s = -inf, so p = 0
        const float p = __expf(s[j][e] - m[r]) * inv_l[r];
        s[j][e] = p * (dp[j][e] - delta[r]) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) climb::a_from_c(dsf[kk], s, kk);
    climb::mma_ab(acc, dsf, Ks + (it & 1) * kTcTile, kLd, lane);
    __syncthreads();
  }
  store_rows(dq + b * dqs.b + h * dqs.h, dqs.s, acc, q0 + warp * 16, S, lane);
}

// at most 168 registers a thread: three blocks an SM
__global__ void __launch_bounds__(kTcThreads, 3)
    attention_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const float* __restrict__ bias,
                                   const float2* __restrict__ ml_in,
                                   const float* __restrict__ delta_in, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int S, int H, Strides qs, Strides ks,
                                   Strides vs, Strides dos, Strides dks, Strides dvs,
                                   long long bias_sb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTcTile;
  bf16* Qs = Vs + kTcTile;       // two buffers
  bf16* dOs = Qs + 2 * kTcTile;  // two buffers
  float2* Ms = reinterpret_cast<float2*>(dOs + 2 * kTcTile);  // two buffers of 64 (m, 1/l)
  float* Ds = reinterpret_cast<float*>(Ms + 2 * kT);          // two buffers of 64 delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kT;
  const long long b = blockIdx.z, h = blockIdx.y;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* ob = dout + b * dos.b + h * dos.h;
  const float2* mlb = ml_in + (b * H + h) * S;
  const float* deltab = delta_in + (b * H + h) * S;

  auto stage = [&](int buf, int q0) {
    climb::cp_async_tile64<kTcThreads, kLd>(Qs + buf * kTcTile, qb, qs.s, q0, S, tid);
    climb::cp_async_tile64<kTcThreads, kLd>(dOs + buf * kTcTile, ob, dos.s, q0, S, tid);
    if (tid < kT) {
      const bool ok = q0 + tid < S;
      climb::cp_async8(Ms + buf * kT + tid, ok ? mlb + q0 + tid : mlb, ok);
    } else {
      const int r = tid - kT;
      const bool ok = q0 + r < S;
      climb::cp_async4(Ds + buf * kT + r, ok ? deltab + q0 + r : deltab, ok);
    }
  };
  climb::cp_async_tile64<kTcThreads, kLd>(Ks, k + b * ks.b + h * ks.h, ks.s, k0, S, tid);
  climb::cp_async_tile64<kTcThreads, kLd>(Vs, v + b * vs.b + h * vs.h, vs.s, k0, S, tid);
  stage(0, 0);
  climb::cp_async_commit();

  // this thread's key rows g and g + 8 of the warp's 16: validity and bias
  bool key_ok[2];
  float key_bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    key_ok[r] = key < S;
    key_bias[r] = key_ok[r] ? bias[b * bias_sb + key] : 0.f;
  }

  const bf16* Kw = Ks + warp * 16 * kLd;  // the warp's 16 rows of K and V
  const bf16* Vw = Vs + warp * 16 * kLd;
  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  const int n_tiles = (S + kT - 1) / kT;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, q0 = it * kT;
    if (it + 1 < n_tiles) stage(buf ^ 1, q0 + kT);
    climb::cp_async_commit();
    climb::cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + buf * kTcTile;
    const bf16* dOt = dOs + buf * kTcTile;
    const float2* Mt = Ms + buf * kT;
    const float* Dt = Ds + buf * kT;
    // two halves of 32 queries keep the score fragments at 16 registers each;
    // K's and V's A fragments are read from shared memory for each half
    // rather than held (32 registers), so three blocks fit on an SM
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;
      float st[4][4], dpt[4][4];  // S^T and dP^T: keys as rows, queries as columns
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      unsigned af[4][4];
      climb::load_a(af, Kw, kLd, lane);
      climb::mma_abt(st, af, Qt + c0 * kLd, kLd, lane);
      climb::load_a(af, Vw, kLd, lane);
      climb::mma_abt(dpt, af, dOt + c0 * kLd, kLd, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = c0 + 8 * j + 2 * t + (e & 1);
          const float2 ml = Mt[c];
          const float p = (key_ok[r] && q0 + c < S)
                              ? __expf(st[j][e] * scale + key_bias[r] - ml.x) * ml.y
                              : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Dt[c]) * scale;
        }
      unsigned pf[2][4], dsf[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        climb::a_from_c(pf[kk], st, kk);
        climb::a_from_c(dsf[kk], dpt, kk);
      }
      climb::mma_ab(dva, pf, dOt + c0 * kLd, kLd, lane);
      climb::mma_ab(dka, dsf, Qt + c0 * kLd, kLd, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  const int row0 = k0 + warp * 16;
  store_rows(dk + b * dks.b + h * dks.h, dks.s, dka, row0, S, lane);
  store_rows(dv + b * dvs.b + h * dvs.h, dvs.s, dva, row0, S, lane);
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const float* bias,
                void* dq, void* dk, void* dv, float2* ml, float* delta, int B, int S, int H,
                const long long* qs, const long long* ks, const long long* vs,
                const long long* dos, const long long* dqs, const long long* dks,
                const long long* dvs, long long bias_sb, float scale, cudaStream_t stream) {
  // the wrapper checks these and says which tensor fails
  using climb::aligned16;
  if (!aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs) || !aligned16(dout, dos) ||
      !aligned16(dq, dqs) || !aligned16(dk, dks) || !aligned16(dv, dvs))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kDqTcSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkdv_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDkdvTcSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kT - 1) / kT, H, B);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ot = static_cast<const bf16*>(dout);
  attention_bwd_dq_bf16_kernel<<<grid, kTcThreads, kDqTcSmemBytes, stream>>>(
      qt, kt, vt, ot, bias, static_cast<bf16*>(dq), ml, delta, S, H, strides3(qs),
      strides3(ks), strides3(vs), strides3(dos), strides3(dqs), bias_sb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_bf16_kernel<<<grid, kTcThreads, kDkdvTcSmemBytes, stream>>>(
      qt, kt, vt, ot, bias, ml, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H,
      strides3(qs), strides3(ks), strides3(vs), strides3(dos), strides3(dks), strides3(dvs),
      bias_sb, scale);
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
// ml: (B, H, S, 2) contiguous f32 scratch holding each row's (max, 1 / sum);
// delta: (B, H, S) f32 scratch; both written by the first launch and read by
// the second.
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
