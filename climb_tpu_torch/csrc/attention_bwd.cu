// Masked multi-head attention backward: dq, dk, dv from q, k, v, the key
// bias and the output gradient dO.
//
// Replaces climb_tpu/ops/pallas_attention.py::_bwd_kernel (wrapper _fa_bwd):
// recompute P in f32; dV = P^T.dO with P rounded to dO's type; dP = dO.V^T in
// f32; delta = rowsum(dP o P); dS = P o (dP - delta) * scale rounded to q's
// type; dQ = dS.K; dK = dS^T.Q; results cast to the input type.
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
//
// Bound on the H100: at the training shape (B=32, S=281, H=12, D=64) the five
// products of the backward are 10 * B*H*S^2*D = 19.4 GFLOP against 7 * B*S*H*D
// elements of compulsory traffic (q, k, v, dO read; dq, dk, dv written):
// 96.7 MB in bf16 (29 us at 3.35 TB/s, bytes-bound against 20 us of
// tensor-core time), 193 MB in f32 (0.29 ms, bound by 67 TFLOP/s of f32
// CUDA-core operations). What the design does about it:
// - It never writes the (B, H, S, S) probabilities or dS to device memory:
//   every 64x64 tile lives in shared memory, and the ragged end of S
//   (281 = 4 * 64 + 25) is masked in the kernel.
// - It reads q, k, v and dO in their (B, S, H, D) layout through strides, so
//   no transpose or padding copy precedes it.
// - All products are f32 FMAs on the CUDA cores (bf16 inputs widened as they
//   are staged), and it recomputes QK^T and dO.V^T in both launches: nine
//   64x64x64 tile products per (query tile, key tile) pair where FlashAttention-2
//   needs five. That is the simple first version, bound by the CUDA cores.
//   Tensor cores (mma/wgmma), TMA, and one launch with dQ accumulated across
//   key blocks are later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;        // head_dim the kernel takes (ViLT-B/32: 768 / 12)
constexpr int kT = 64;        // query rows and keys per tile
constexpr int kThreads = 256; // 16 x 16 threads, each owns 4 rows x 4 columns
constexpr int kPad = kD + 1;  // row stride of the padded tiles (no bank conflicts)
constexpr int kTile = kT * kPad;

constexpr size_t kDqSmemBytes = (5 * kTile + kT) * sizeof(float);      // Q dO K V dS, bias
// K V Q dO P dS tiles; bias, row max, 1 / row sum, delta
constexpr size_t kDkdvSmemBytes = (6 * kTile + 4 * kT) * sizeof(float);

struct Strides {
  long long b, s, h;  // element strides of the B, S and H axes
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return climb::to_float(climb::from_float<T>(x));
}

// rows [row0, row0 + 64) of one (b, h) slice into a padded f32 tile; rows
// past S are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long ss,
                                          int row0, int S, int tid) {
  for (int idx = tid; idx < kT * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD, s = row0 + r;
    dst[r * kPad + d] = s < S ? climb::to_float(src[s * ss + d]) : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ bias, T* __restrict__ dq,
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

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* ob = dout + b * dos.b + h * dos.h;
  T* dqb = dq + b * dqs.b + h * dqs.h;
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
        dSs[(ty + 16 * i) * kPad + c] = round_to<T>(p * (dp[i][j] - delta[i]) * scale);
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
    for (int j = 0; j < 4; ++j) dqb[s * dqs.s + tx + 16 * j] = climb::from_float<T>(acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ bias, const float2* __restrict__ ml_in,
                              const float* __restrict__ delta_in, T* __restrict__ dk,
                              T* __restrict__ dv, int S, int H, Strides qs, Strides ks,
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

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* ob = dout + b * dos.b + h * dos.h;
  T* dkb = dk + b * dks.b + h * dks.h;
  T* dvb = dv + b * dvs.b + h * dvs.h;
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
        Ps[r * kPad + c] = round_to<T>(p);
        dSs[r * kPad + c] = round_to<T>(p * (dp[i][j] - Dl[r]) * scale);
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
      dkb[s * dks.s + tx + 16 * j] = climb::from_float<T>(dka[i][j]);
      dvb[s * dvs.s + tx + 16 * j] = climb::from_float<T>(dva[i][j]);
    }
  }
}

Strides strides(const long long* s) { return Strides{s[0], s[1], s[2]}; }

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* bias,
           void* dq, void* dk, void* dv, float2* ml, float* delta, int B, int S, int H,
           const long long* qs, const long long* ks, const long long* vs, const long long* dos,
           const long long* dqs, const long long* dks, const long long* dvs, long long bias_sb,
           float scale, cudaStream_t stream) {
  auto dq_kernel = attention_bwd_dq_kernel<T>;
  auto dkdv_kernel = attention_bwd_dkdv_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kDqSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDkdvSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kT - 1) / kT, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  dq_kernel<<<grid, kThreads, kDqSmemBytes, stream>>>(
      qt, kt, vt, ot, bias, static_cast<T*>(dq), ml, delta, S, H, strides(qs), strides(ks),
      strides(vs), strides(dos), strides(dqs), bias_sb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<grid, kThreads, kDkdvSmemBytes, stream>>>(
      qt, kt, vt, ot, bias, ml, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      strides(qs), strides(ks), strides(vs), strides(dos), strides(dks), strides(dvs), bias_sb,
      scale);
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
    return launch<float>(q, k, v, dout, bias, dq, dk, dv, ml2, delta, B, S, H, q_strides,
                         k_strides, v_strides, do_strides, dq_strides, dk_strides, dv_strides,
                         bias_sb, scale, s);
  if (dtype == climb::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, dout, bias, dq, dk, dv, ml2, delta, B, S, H,
                                 q_strides, k_strides, v_strides, do_strides, dq_strides,
                                 dk_strides, dv_strides, bias_sb, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
