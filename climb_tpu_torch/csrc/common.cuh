// Shared helpers for the climb_tpu_torch CUDA kernels (sm_90a, plain C ABI).
//
// Every entry point is `extern "C"`, launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace climb {

// dtype codes shared with climb_tpu_torch/kernels/build.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// element strides of the B, S and H axes of a (B, S, H, D) tensor
struct Strides {
  long long b, s, h;
};
inline Strides strides3(const long long* s) { return Strides{s[0], s[1], s[2]}; }

// what the TMA tensor maps of bf16 (B, S, H, D) tensors and the forward's 16-byte
// output stores need: a 16-byte aligned base and B, S, H
// strides in multiples of 8 elements
inline bool aligned16(const void* p, const long long* s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % 8 == 0 && s[1] % 8 == 0 &&
         s[2] % 8 == 0;
}

}  // namespace climb
