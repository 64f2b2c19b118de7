// Helpers shared by the port's CUDA kernels.
//
// Every kernel takes float32 or bfloat16 tensors, does its arithmetic in
// float32 and rounds once when it stores. The C entry points return the
// value of cudaGetLastError() after the launch, so the Python wrapper can
// raise on a launch the CUDA runtime refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace e4s {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);

template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}

template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void store_f32(T* p, float v);

template <>
__device__ __forceinline__ void store_f32<float>(float* p, float v) {
  *p = v;
}

template <>
__device__ __forceinline__ void store_f32<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

// Blocks along grid y and z are capped by the hardware; kernels loop over
// the rest.
constexpr long long kMaxGridYZ = 65535;

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace e4s
