// Helpers shared by the port's CUDA kernels.
//
// Every kernel takes float32 or bfloat16 tensors, does its arithmetic in
// float32 and rounds once when it stores. The C entry points return the
// value of cudaGetLastError() after the launch, so the Python wrapper can
// raise on a launch the CUDA runtime refused.
#pragma once

#include <cstdint>

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

// The two bfloat16 halves of a 32-bit word, widened to float32.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Two float32 values rounded to bfloat16 by one instruction, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The device's multiprocessor count, read once per device.
inline int multiprocessors(int device) {
  static int count[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (count[device] == 0)
    cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device);
  return count[device] > 0 ? count[device] : 132;
}

// Blocks along grid y and z are capped by the hardware; kernels loop over
// the rest.
constexpr long long kMaxGridYZ = 65535;

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace e4s
