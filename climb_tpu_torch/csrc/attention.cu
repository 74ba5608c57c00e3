// Masked multi-head attention forward, one (batch, head, 64-query tile) per block.
//
// Replaces climb_tpu/ops/pallas_attention.py::_fwd_kernel (wrappers _prep,
// _fa_fwd): s = q.k^T * scale + key_bias in f32, softmax in f32, p.v in f32,
// output cast to the input type.
//
// Bound on the H100: bytes. At the ViLT-B/32 serving shape (B=64, S=281,
// H=12, D=64, bf16) one call does 15.5 GFLOP and must move 110.5 MB (q, k, v
// read once, o written once), about 33 us at 3.35 TB/s against 16 us of
// bf16 tensor-core time. What the design does about it:
// - It never writes the (B, H, S, S) scores or probabilities to device
//   memory: K/V tiles of 64 keys are staged in shared memory and an online
//   softmax keeps the running max, sum and output rows in registers.
// - It reads q/k/v in their (B, S, H, D) layout through strides, so no
//   transpose or padding copy precedes it, and masks the ragged end of S
//   (281 = 4 * 64 + 25) itself instead of padding to a multiple of 128.
// - All products are f32 FMAs on the CUDA cores (bf16 inputs are widened as
//   they are staged). That is the simple first version: it is bound by the
//   CUDA cores' f32 rate, not by memory. Tensor-core tiles (mma/wgmma) are
//   later work.
// Keys past S are excluded from the softmax entirely, which is what the plain
// version (climb_tpu/ops/attention.py::_mha_core) computes; masked keys inside
// S carry the caller's -1e9 bias as in the TPU kernel.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;        // head_dim the kernel takes (ViLT-B/32: 768 / 12)
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 256; // 16 x 16 threads, each owns 4 rows x 4 columns
constexpr int kPad = kD + 1;  // row stride of the padded tiles (no bank conflicts)

constexpr size_t kSmemFloats = kBQ * kPad      // Q tile
                               + kBK * kPad    // K tile
                               + kBK * kD      // V tile
                               + kBQ * kPad    // probabilities
                               + kBK;          // key bias
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         T* __restrict__ out, int S, long long q_sb, long long q_ss,
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

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  T* ob = out + b * o_sb + h * o_sh;
  const float* biasb = bias + b * bias_sb;

  for (int idx = tid; idx < kBQ * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD, s = q0 + r;
    Qs[r * kPad + d] = s < S ? climb::to_float(qb[s * q_ss + d]) : 0.f;
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
      Ks[r * kPad + d] = ok ? climb::to_float(kb[s * k_ss + d]) : 0.f;
      Vs[r * kD + d] = ok ? climb::to_float(vb[s * v_ss + d]) : 0.f;
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
      ob[s * o_ss + tx + 16 * j] = climb::from_float<T>(acc[i][j] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out, int B,
           int S, int H, const long long* qs, const long long* ks, const long long* vs,
           const long long* os, long long bias_sb, float scale, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), S, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      os[0], os[1], os[2], bias_sb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/out: (B, S, H, D) with D == 64 contiguous; *_strides = element
// strides of the B, S and H axes. bias: (B, S) f32 rows bias_sb apart.
extern "C" int climb_attention_fwd(const void* q, const void* k, const void* v,
                                   const float* bias, void* out, int B, int S, int H, int D,
                                   const long long* q_strides, const long long* k_strides,
                                   const long long* v_strides, const long long* o_strides,
                                   long long bias_sb, float scale, int dtype, void* stream) {
  if (D != kD || B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == climb::kFloat32)
    return launch<float>(q, k, v, bias, out, B, S, H, q_strides, k_strides, v_strides,
                         o_strides, bias_sb, scale, s);
  if (dtype == climb::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, bias, out, B, S, H, q_strides, k_strides, v_strides,
                                 o_strides, bias_sb, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
