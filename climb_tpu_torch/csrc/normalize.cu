// uint8 canvas -> normalized float, x * (1/255) - 0.5, / 0.5.
//
// Replaces climb_tpu/ops/pallas_image.py::_normalize_kernel (normalize_pallas).
//
// Bound on the H100: bytes. Each pixel is one byte in and 2 (bf16) or 4 (f32)
// bytes out, with three flops: 141.6 MB for a 64x384x640x3 bf16 batch, about
// 42 us at 3.35 TB/s. The design moves 16 input bytes per thread with one
// 128-bit load and writes the outputs with 128-bit stores, one pass, no
// shared memory.
//
// Rounding is part of the contract: the result must equal
// climb_tpu/ops/image_ops.py::normalize_images bit for bit. So the kernel uses
// __fmul_rn/__fsub_rn/__fdiv_rn (nvcc would otherwise contract x*c - 0.5 into
// one FMA), keeps image_ops.py's op order, and in bf16 rounds the constant
// 1/255 and every intermediate to bf16 as JAX does.
#include "common.cuh"

namespace {

constexpr float kInv255 = static_cast<float>(1.0 / 255.0);

__device__ __forceinline__ float normalize_one(float x, float c) {
  return __fdiv_rn(__fsub_rn(__fmul_rn(x, c), 0.5f), 0.5f);
}

template <typename OutT>
struct Normalize;

template <>
struct Normalize<float> {
  __device__ __forceinline__ static float apply(unsigned int u) {
    return normalize_one(static_cast<float>(u), kInv255);
  }
};

template <>
struct Normalize<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 apply(unsigned int u) {
    const float c = __bfloat162float(__float2bfloat16_rn(kInv255));
    float x = __bfloat162float(__float2bfloat16_rn(__fmul_rn(static_cast<float>(u), c)));
    x = __bfloat162float(__float2bfloat16_rn(__fsub_rn(x, 0.5f)));
    return __float2bfloat16_rn(__fdiv_rn(x, 0.5f));
  }
};

template <typename OutT>
__global__ void normalize_u8_kernel(const uint8_t* __restrict__ in, OutT* __restrict__ out,
                                    long long n) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 16;
  if (i >= n) return;
  if (i + 16 <= n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(in + i);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
    __align__(16) OutT vals[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) vals[j] = Normalize<OutT>::apply(bytes[j]);
    const uint4* src = reinterpret_cast<const uint4*>(vals);
    uint4* dst = reinterpret_cast<uint4*>(out + i);
#pragma unroll
    for (int j = 0; j < static_cast<int>(16 * sizeof(OutT) / 16); ++j) dst[j] = src[j];
  } else {
    for (long long j = i; j < n; ++j) out[j] = Normalize<OutT>::apply(in[j]);
  }
}

}  // namespace

extern "C" int climb_normalize_u8(const void* in, void* out, long long n, int out_dtype,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const long long chunks = (n + 15) / 16;
  const unsigned int blocks = static_cast<unsigned int>((chunks + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (out_dtype == climb::kFloat32) {
    normalize_u8_kernel<float><<<blocks, threads, 0, s>>>(src, static_cast<float*>(out), n);
  } else if (out_dtype == climb::kBFloat16) {
    normalize_u8_kernel<__nv_bfloat16>
        <<<blocks, threads, 0, s>>>(src, static_cast<__nv_bfloat16*>(out), n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
