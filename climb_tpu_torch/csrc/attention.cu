// Masked multi-head attention forward, one (batch, head, 64-query tile) per block.
//
// Replaces climb_tpu/ops/pallas_attention.py::_fwd_kernel (:53, wrappers
// _prep, _fa_fwd) and ::_fwd_kernel_blocked (:104, _fa_fwd_blocked): the
// masked softmax(q.k^T * scale + key_bias).v. The bf16 kernel computes
// _fwd_kernel_blocked's online softmax over 64-key blocks: f32 scores from
// the bf16 inputs, the row max and row sum in f32, the unnormalised P rounded
// to bf16 for P.V, an f32 accumulator divided by max(l, 1e-30) at the end.
// The f32 kernel keeps P in f32 throughout.
//
// Bound on the H100 at the main paths' shapes, bf16:
// - serving (B=64, S=281, H=12, D=64): 15.5 GFLOP (16 us of tensor-core
//   time) against 110.6 MB of q, k, v read and o written once (33 us at
//   3.35 TB/s): bytes bind;
// - the language driver (16, 1057, 12, 64): 54.9 GFLOP (56 us) against
//   104 MB (31 us): operations bind.
// What the design does about it:
// - It never writes the (B, H, S, S) scores or probabilities to device
//   memory, reads q/k/v in their (B, S, H, D) layout through strides (no
//   transpose or padding copy), and masks the ragged end of S (281 = 4 * 64 +
//   25) itself: keys past S are excluded from the softmax entirely, which is
//   what the plain version (climb_tpu/ops/attention.py::_mha_core) computes;
//   masked keys inside S carry the caller's -1e9 bias as in the TPU kernel.
// - bf16: four warps, each owning 16 query rows, run every product on the
//   tensor cores (mma.sync m16n8k16, f32 accumulators). Q's fragments are
//   loaded once with ldmatrix; K and V tiles of 64 keys stay bf16 in shared
//   memory with a padded row stride (no ldmatrix bank conflicts) and are
//   double-buffered by 16-byte cp.async, so the next tile's copy overlaps
//   this tile's products. The score tile stays in registers: the row max and
//   sum reduce within a quad of lanes, and P's C fragments are re-packed to
//   bf16 as the A operand of P.V (V through ldmatrix.trans). exp is __expf
//   (the SFU's ex2; its error is far below P's bf16 rounding).
// - f32 keeps f32 FMAs on the CUDA cores (the tensor cores' f32 is TF32,
//   about three decimal digits), as gemm.cuh keeps its f32 GEMM.
#include <math.h>

#include "tc.cuh"

namespace {

constexpr int kD = 64;        // head_dim the kernel takes (ViLT-B/32: 768 / 12)
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per K/V tile

using climb::Strides;
using climb::strides3;

// ---- f32: CUDA cores ---------------------------------------------------------

constexpr int kThreads = 256; // 16 x 16 threads, each owns 4 rows x 4 columns
constexpr int kPad = kD + 1;  // row stride of the padded tiles (no bank conflicts)

constexpr size_t kSmemFloats = kBQ * kPad      // Q tile
                               + kBK * kPad    // K tile
                               + kBK * kD      // V tile
                               + kBQ * kPad    // probabilities
                               + kBK;          // key bias
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         float* __restrict__ out, int S, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                         long long o_ss, long long o_sh, long long bias_sb, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * kPad;
  float* Vs = Ks + kBK * kPad;
  float* Ps = Vs + kBK * kD;
  float* Bs = Ps + kBQ * kPad;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: keys / head dims tx + 16 j
  const int ty = tid >> 4;  // row group: query rows ty + 16 i
  const int q0 = blockIdx.x * kBQ;
  const long long b = blockIdx.z, h = blockIdx.y;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  float* ob = out + b * o_sb + h * o_sh;
  const float* biasb = bias + b * bias_sb;

  for (int idx = tid; idx < kBQ * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD, s = q0 + r;
    Qs[r * kPad + d] = s < S ? qb[s * q_ss + d] : 0.f;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done (and Q is staged)
    for (int idx = tid; idx < kBK * kD; idx += kThreads) {
      const int r = idx / kD, d = idx % kD, s = k0 + r;
      const bool ok = s < S;
      Ks[r * kPad + d] = ok ? kb[s * k_ss + d] : 0.f;
      Vs[r * kD + d] = ok ? vb[s * v_ss + d] : 0.f;
    }
    if (tid < kBK) Bs[tid] = (k0 + tid < S) ? biasb[k0 + tid] : 0.f;
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * kPad + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * kPad + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool ok = k0 + c < S;
      const float bj = Bs[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i][j] = ok ? sc[i][j] * scale + bj : -INFINITY;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one key < S, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sc[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= alpha;
        Ps[(ty + 16 * i) * kPad + tx + 16 * j] = sc[i][j];
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[c * kD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ob[s * o_ss + tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---- bf16: tensor cores -------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;      // four warps of 16 query rows
constexpr int kLd = kD + 8;          // bf16 row stride of the tiles: 144 bytes
constexpr int kTcTile = kBQ * kLd;   // elements of one 64-row tile
// Q, two K and two V tiles, two blocks of 64 key-bias values
constexpr size_t kTcSmemBytes = 5 * kTcTile * sizeof(bf16) + 2 * kBK * sizeof(float);

__global__ void __launch_bounds__(kTcThreads)
    attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const float* __restrict__ bias,
                              bf16* __restrict__ out, int S, Strides qs, Strides ks, Strides vs,
                              Strides os, long long bias_sb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTcTile;      // two buffers
  bf16* Vs = Ks + 2 * kTcTile;  // two buffers
  float* Bs = reinterpret_cast<float*>(Vs + 2 * kTcTile);  // two buffers of 64

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const long long b = blockIdx.z, h = blockIdx.y;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const float* biasb = bias + b * bias_sb;

  auto stage = [&](int buf, int k0) {
    climb::cp_async_tile64<kTcThreads, kLd>(Ks + buf * kTcTile, kb, ks.s, k0, S, tid);
    climb::cp_async_tile64<kTcThreads, kLd>(Vs + buf * kTcTile, vb, vs.s, k0, S, tid);
    if (tid < kBK) {
      const bool ok = k0 + tid < S;
      climb::cp_async4(Bs + buf * kBK + tid, ok ? biasb + k0 + tid : biasb, ok);
    }
  };
  climb::cp_async_tile64<kTcThreads, kLd>(Qs, qb, qs.s, q0, S, tid);
  stage(0, 0);
  climb::cp_async_commit();

  unsigned qf[4][4];  // A fragments of the warp's 16 query rows, 4 chunks of 16 dims
  float o[8][4];      // 16 rows x 64 dims, f32
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int n_tiles = (S + kBK - 1) / kBK;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, k0 = it * kBK;
    if (it + 1 < n_tiles) stage(buf ^ 1, k0 + kBK);
    climb::cp_async_commit();
    climb::cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    if (it == 0) climb::load_a(qf, Qs + warp * 16 * kLd, kLd, lane);
    const bf16* Kt = Ks + buf * kTcTile;
    const bf16* Vt = Vs + buf * kTcTile;
    const float* Bt = Bs + buf * kBK;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    climb::mma_abt(s, qf, Kt, kLd, lane);

    // scale, key bias, keys past S out; the row max over the tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const bool ok = k0 + c < S;
        const float bc = Bt[c];
        s[j][e] = ok ? s[j][e] * scale + bc : -INFINITY;
        s[j][2 + e] = ok ? s[j][2 + e] * scale + bc : -INFINITY;
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // every tile holds at least one key < S, so m_new is finite
      m_new[r] = fmaxf(m[r], climb::quad_max(mx[r]));
      alpha[r] = __expf(m[r] - m_new[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m_new[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + climb::quad_sum(rs[r]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // O += bf16(P) . V
    unsigned pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) climb::a_from_c(pf[kk], s, kk);
    climb::mma_ab(o, pf, Vt, kLd, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  const int g = lane >> 2;
  bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + warp * 16 + g + 8 * r;
    if (s >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + s * os.s + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * r] / den, o[j][2 * r + 1] / den);
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out, int B,
                int S, int H, const long long* qs, const long long* ks, const long long* vs,
                const long long* os, long long bias_sb, float scale, cudaStream_t stream) {
  // the wrapper checks these and says which tensor fails
  if (!climb::aligned16(q, qs) || !climb::aligned16(k, ks) || !climb::aligned16(v, vs) ||
      !climb::aligned16(out, os))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kTcSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  attention_fwd_bf16_kernel<<<grid, kTcThreads, kTcSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), S, strides3(qs), strides3(ks), strides3(vs),
      strides3(os), bias_sb, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, const float* bias, void* out, int B,
               int S, int H, const long long* qs, const long long* ks, const long long* vs,
               const long long* os, long long bias_sb, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  attention_fwd_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(out), S, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1],
      vs[2], os[0], os[1], os[2], bias_sb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/out: (B, S, H, D) with D == 64 contiguous; *_strides = element
// strides of the B, S and H axes. bias: (B, S) f32 rows bias_sb apart. bf16
// tensors start on 16-byte boundaries with strides in multiples of 8.
extern "C" int climb_attention_fwd(const void* q, const void* k, const void* v,
                                   const float* bias, void* out, int B, int S, int H, int D,
                                   const long long* q_strides, const long long* k_strides,
                                   const long long* v_strides, const long long* o_strides,
                                   long long bias_sb, float scale, int dtype, void* stream) {
  if (D != kD || B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == climb::kFloat32)
    return launch_f32(q, k, v, bias, out, B, S, H, q_strides, k_strides, v_strides, o_strides,
                      bias_sb, scale, s);
  if (dtype == climb::kBFloat16)
    return launch_bf16(q, k, v, bias, out, B, S, H, q_strides, k_strides, v_strides, o_strides,
                       bias_sb, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
