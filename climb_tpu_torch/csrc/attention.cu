// Masked multi-head attention forward, one (batch, head, 64-query tile) per block.
//
// Replaces climb_tpu/ops/pallas_attention.py::_fwd_kernel (:53, wrappers
// _prep, _fa_fwd) and ::_fwd_kernel_blocked (:104, _fa_fwd_blocked), and the
// attention step of pallas_block.py::_kernel (:55) through block.cu's third
// launch: the masked softmax(q.k^T * scale + key_bias).v. The bf16 kernel
// computes _fwd_kernel_blocked's online softmax over 64-key blocks: f32
// scores from the bf16 inputs, the row max and row sum in f32 updated once
// per 64-key tile, the unnormalised P rounded to bf16 for P.V, an f32
// accumulator divided by max(l, 1e-30) at the end and then rounded to bf16.
// Scores are carried in log2 units (scale * log2 e folded into one FMA with
// the key bias, exp as one ex2 of the SFU), as attention_bwd.cu does; that
// moves each f32 score by an ulp or so, far below P's bf16 rounding. The
// f32 kernel keeps P in f32 throughout.
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
//   transpose or padding copy; block.cu's (B, S, E) buffers and the
//   --fuse_qkv views of a (B, S, 3E) tensor included), and masks the ragged
//   end of S (281 = 4 * 64 + 25) itself: keys past S are excluded from the
//   softmax entirely, which is what the plain version
//   (climb_tpu/ops/attention.py::_mha_core) computes; masked keys inside S
//   carry the caller's -1e9 bias as in the TPU kernel.
// - bf16: both products run on wgmma m64n64k16 with f32 accumulators
//   (hopper.cuh): S = Q.K^T with Q and K as K-major 128-byte-swizzled tiles
//   in shared memory, O += P.V with P taken from registers (the score
//   accumulator re-packed as bf16 pairs) and V's tile read MN-major with the
//   transpose bit, so each K/V tile is loaded once, as TMA wrote it.
// - Tiles arrive by TMA: 4-D tensor maps over {D, H, S, B} with the views'
//   strides (encoded on every call; rows past S read as zeros within each
//   example). A block is one consumer warpgroup of 64 query rows and one
//   producer warpgroup, one warp of which loads the Q tile once and streams
//   K and V through a 3-stage ring of full and empty mbarriers, writing
//   beside each stage its 64 key-bias values (in log2 units, -inf past S, so
//   the consumer needs no mask test); setmaxnreg hands the producer's
//   registers to the consumer (136 a thread).
// - Overlap: the consumer issues the next tile's Q.K^T right behind this
//   tile's P.V, so the tensor cores have both queued while it waits, and
//   three blocks share each SM, so one block's softmax runs while another's
//   products do (ping-pong across blocks), and one block's Q load and
//   first K/V tiles overlap the others' work: at S = 281 a block sees only
//   five key tiles, and 64-row blocks leave 12% of the rows idle where
//   128-row blocks leave 27%. Two or three consumer warpgroups a block were
//   no faster on the card, and two at two blocks an SM spill; issuing tile
//   i + 1's Q.K^T before tile i's softmax or P.V (FlashAttention-3's
//   intra-warpgroup overlap) made ptxas serialize the wgmma pipeline
//   (C7513, C7514: registers a pending wgmma reads or writes are touched in
//   between), and was slower.
// - The output is staged through the Q tile (free once the last Q.K^T has
//   completed) in the swizzled layout (conflict-free 4-byte writes) and
//   written in 16-byte stores, eight threads a 128-byte row; no row past S
//   is written, and nothing is summed across blocks, so a second call gives
//   bit-equal output.
// - f32 keeps f32 FMAs on the CUDA cores (the tensor cores' f32 is TF32,
//   about three decimal digits), as gemm.cuh keeps its f32 GEMM.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;        // head_dim the kernel takes (ViLT-B/32: 768 / 12)
constexpr int kBQ = 64;       // query rows per tile (an f32 block, a bf16 warpgroup)
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

// ---- bf16: wgmma fed by TMA -------------------------------------------------

using bf16 = __nv_bfloat16;
using namespace climb;  // hopper.cuh's mbarrier, TMA, wgmma and softmax helpers

constexpr unsigned kTileBytes = kBQ * kD * 2;  // one 64 x 64 bf16 tile

// A block is one consumer warpgroup (warps 0-3, 64 query rows) and one
// producer warpgroup (warps 4-7), of which one warp issues the copies; three
// blocks share an SM, so three consumers' softmax and products interleave.
// setmaxnreg moves the producer's registers to the consumer: 80 a thread at
// launch (65536 / (3 * 256)), 24 for the producer, 136 for the consumer.
// Dynamic shared memory, from a 1024-byte boundary (the swizzle's period):
// the Q tile (reused for the output), the ring of kStages stages of a K and a
// V tile, each stage's 64 key-bias values, then the barriers.
constexpr int kFwdThreads = 256;
constexpr int kFwdBlocksPerSm = 3;
constexpr int kStages = 3;
constexpr int kProducerRegs = 24, kConsumerRegs = 136;
static_assert(kProducerRegs + kConsumerRegs <=
                  2 * (65536 / (kFwdThreads * kFwdBlocksPerSm) / 8 * 8),
              "the handoff stays within the registers the block gets at launch");
constexpr unsigned kRingOffset = kTileBytes;
constexpr unsigned kBiasOffset = kRingOffset + kStages * 2 * kTileBytes;
constexpr unsigned kBarOffset = kBiasOffset + kStages * kBK * sizeof(float);
constexpr size_t kFwdSmemBytes = 1024 + kBarOffset + RingBarriers<kStages>::kBytes;
static_assert(kFwdBlocksPerSm * (kFwdSmemBytes + 1024) <= 228 * 1024,
              "three blocks an SM, with the 1 KB each that the system keeps");

__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSm)
    attention_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const float* __restrict__ bias, bf16* __restrict__ out, int S,
                              Strides os, long long bias_sb, float scale) {
  unsigned base;
  unsigned char* smem = aligned_smem(base);
  const unsigned ring = base + kRingOffset;
  float* key_bias = reinterpret_cast<float*>(smem + kBiasOffset);
  const RingBarriers<kStages> bar(base + kBarOffset);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int n_k = (S + kBK - 1) / kBK;

  if (tid == 0) bar.init(1);
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup: one warp issues the copies
    setmaxnreg_dec<kProducerRegs>();
    if (warp > 4) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar.ready, kTileBytes);
      tma_load_4d(base, &qmap, bar.ready, 0, h, q0, b);
    }
    // K and V tiles with the tile's key bias in log2 units, -inf past S (so a
    // key past S gets s = -inf and p = 0 with no test in the consumer)
    const float* biasb = bias + b * bias_sb;
    for (int i = 0; i < n_k; ++i) {
      const int s = i % kStages, k0 = i * kBK;
      mbar_wait(bar.empty + 8 * s, ((i / kStages) & 1) ^ 1);  // round 0 passes at once
      for (int c = lane; c < kBK; c += 32)
        key_bias[s * kBK + c] = k0 + c < S ? biasb[k0 + c] * kLog2e : -INFINITY;
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

  setmaxnreg_inc<kConsumerRegs>();
  const int t = lane & 3;
  const unsigned qt = base;
  const float scale_log2 = scale * kLog2e;
  mbar_wait(bar.ready, 0);

  // S = Q.K^T of key tile i into s
  float s[32];
  auto issue_scores = [&](int i) {
    const int st = i % kStages;
    const unsigned kt = ring + st * 2 * kTileBytes;
    mbar_wait(bar.full + 8 * st, (i / kStages) & 1);
    wgmma_fence();
    wgmma_m64n64k16_ss_first(s, sw128_desc(qt), sw128_desc(kt));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      wgmma_m64n64k16_ss(s, sw128_desc(qt + 32 * kk), sw128_desc(kt + 32 * kk));
    wgmma_commit();
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows lane/4 and 8 on
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  fence_operand(o);  // zeroed here, not next to its first wgmma
  issue_scores(0);
  for (int i = 0; i < n_k; ++i) {
    const int st = i % kStages;
    wgmma_wait<0>();  // tile i's S, and tile i - 1's P.V
    fence_operand(s);
    fence_operand(o);
    if (i > 0) bar.release((i - 1) % kStages, lane);  // P.V has read V
    // s * scale + bias in log2 units; the row max over the tile
    const float* bt = key_bias + st * kBK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bc = bt[8 * j + 2 * t + e];
        s[4 * j + e] = fmaf(s[4 * j + e], scale_log2, bc);
        s[4 * j + 2 + e] = fmaf(s[4 * j + 2 + e], scale_log2, bc);
        mx[0] = fmaxf(mx[0], s[4 * j + e]);
        mx[1] = fmaxf(mx[1], s[4 * j + 2 + e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // every tile holds at least one key < S, so the new max is finite
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = exp2_approx(s[e] - m[r]);
      rs[r] += s[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] *= alpha[(e >> 1) & 1];
    // O += bf16(P).V with V as the MN-major B operand
    unsigned pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_from_acc(pf[kk], s, kk);
    const unsigned vt = ring + st * 2 * kTileBytes + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs(o, pf[kk], sw128_mn_desc(vt + 2048 * kk));
    wgmma_commit();
    // the next tile's S queues behind this P.V; the softmax of the other
    // blocks on this SM runs meanwhile
    if (i + 1 < n_k) issue_scores(i + 1);
  }
  wgmma_wait<0>();
  fence_operand(o);
  bar.release((n_k - 1) % kStages, lane);

  // o / max(l, 1e-30) in bf16 into the Q tile, swizzled as TMA wrote Q (the
  // 16-byte chunk c of row r at chunk c ^ (r % 8)), then out in 16-byte
  // stores of rows below S, eight threads a 128-byte row
  bar_sync_named(1, 128);  // every warp's last Q.K^T has completed: Q is free
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + (lane >> 2) + 8 * r;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(smem + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
  }
  bar_sync_named(1, 128);
  bf16* ob = out + b * os.b + h * os.h;
  for (int c = tid; c < kBQ * 8; c += 128) {
    const int row = c >> 3, chunk = c & 7;
    if (q0 + row < S)
      *reinterpret_cast<uint4*>(ob + (q0 + row) * os.s + 8 * chunk) =
          *reinterpret_cast<const uint4*>(smem + row * 128 + ((chunk ^ (row & 7)) << 4));
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out, int B,
                int S, int H, const long long* qs, const long long* ks, const long long* vs,
                const long long* os, long long bias_sb, float scale, cudaStream_t stream) {
  // the wrapper checks these and says which tensor fails; TMA needs the same
  if (!aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs) || !aligned16(out, os))
    return static_cast<int>(cudaErrorMisalignedAddress);
  // the operands' addresses and strides change from call to call: encode here
  CUtensorMap qm, km, vm;
  int err = encode_bshd_bf16(&qm, q, B, S, H, qs);
  if (!err) err = encode_bshd_bf16(&km, k, B, S, H, ks);
  if (!err) err = encode_bshd_bf16(&vm, v, B, S, H, vs);
  if (err) return err;
  const cudaError_t cerr = cudaFuncSetAttribute(attention_fwd_bf16_kernel,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(kFwdSmemBytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  attention_fwd_bf16_kernel<<<grid, kFwdThreads, kFwdSmemBytes, stream>>>(
      qm, km, vm, bias, static_cast<bf16*>(out), S, strides3(os), bias_sb, scale);
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
// tensors start on 16-byte boundaries with strides in multiples of 8 (what
// their TMA tensor maps and the 16-byte output stores need).
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
