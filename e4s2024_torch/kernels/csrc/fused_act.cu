// K1: fused bias + LeakyReLU + gain, out = leaky_relu(x + bias[c], slope) * gain.
//
// Replaces the TPU kernel e4s2024_tpu/ops/pallas/kernels.py::fused_leaky_relu_tpu
// (pallas_call at :69). It runs after every StyledConv of the generator.
//
// Layout: x is a contiguous (N, C, *spatial) tensor (NCHW in the port), so one
// (n, c) plane is `inner` contiguous elements that share one bias value.
//
// Bound on the card: bytes. Each element is read once and written once and
// costs three floating-point operations, far below the ~20 operations per
// byte at which an H100 stops being memory-bound even in plain float32.
//
// Design (first, simple version): grid y walks the planes, so the bias is
// read once per block and no thread divides an element index by the plane
// size; grid x covers a plane in chunks of 1024 elements, four coalesced
// elements per thread. Fusing the pass into the producing convolution's
// epilogue, which would save the whole round trip, is later work.
//
// Backward (no TPU counterpart: the JAX package differentiates XLA ops):
// grad_x = grad * (out >= 0 ? gain : slope * gain), from the saved output,
// whose sign is that of x + bias (gain and slope are positive). One flat
// pass, four coalesced elements per thread in a grid-stride loop; the bias
// gradient, grad_x summed over every axis but 1, is the caller's reduction.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

template <typename T>
__global__ void fused_leaky_relu_kernel(const T* __restrict__ x,
                                        const float* __restrict__ bias,
                                        T* __restrict__ out, long long planes,
                                        int channels, long long inner,
                                        float slope, float gain) {
  for (long long plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const float b = bias != nullptr ? bias[plane % channels] : 0.f;
    const T* src = x + plane * inner;
    T* dst = out + plane * inner;
    const long long first =
        static_cast<long long>(blockIdx.x) * kThreads * kPerThread + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long i = first + static_cast<long long>(k) * kThreads;
      if (i < inner) {
        const float v = e4s::load_f32(src + i) + b;
        e4s::store_f32(dst + i, (v >= 0.f ? v : v * slope) * gain);
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* bias, void* out, long long planes,
            int channels, long long inner, float slope, float gain,
            cudaStream_t stream) {
  const long long chunk = static_cast<long long>(kThreads) * kPerThread;
  const dim3 grid(static_cast<unsigned>((inner + chunk - 1) / chunk),
                  static_cast<unsigned>(planes < e4s::kMaxGridYZ ? planes : e4s::kMaxGridYZ));
  fused_leaky_relu_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(bias),
      static_cast<T*>(out), planes, channels, inner, slope, gain);
}

template <typename T>
__global__ void fused_leaky_relu_backward_kernel(const T* __restrict__ grad,
                                                 const T* __restrict__ out,
                                                 T* __restrict__ grad_x, long long n,
                                                 float slope_gain, float gain) {
  const long long chunk = static_cast<long long>(kThreads) * kPerThread;
  const long long step = static_cast<long long>(gridDim.x) * chunk;
  for (long long first = blockIdx.x * chunk + threadIdx.x; first < n; first += step) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long i = first + static_cast<long long>(k) * kThreads;
      if (i < n) {
        const float g = e4s::load_f32(grad + i);
        e4s::store_f32(grad_x + i, g * (e4s::load_f32(out + i) >= 0.f ? gain : slope_gain));
      }
    }
  }
}

template <typename T>
void launch_backward(const void* grad, const void* out, void* grad_x, long long n,
                     float slope, float gain, cudaStream_t stream) {
  const long long chunk = static_cast<long long>(kThreads) * kPerThread;
  const long long blocks = std::min((n + chunk - 1) / chunk, 1LL << 30);
  fused_leaky_relu_backward_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(out), static_cast<T*>(grad_x), n,
      slope * gain, gain);
}

}  // namespace

// bias may be null (no bias); otherwise it holds `channels` float32 values.
extern "C" int e4s_fused_leaky_relu(const void* x, const void* bias, void* out,
                                    int dtype, long long planes, int channels,
                                    long long inner, float slope, float gain,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes <= 0 || inner <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case e4s::kFloat32:
      launch<float>(x, bias, out, planes, channels, inner, slope, gain, s);
      break;
    case e4s::kBFloat16:
      launch<__nv_bfloat16>(x, bias, out, planes, channels, inner, slope, gain, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return e4s::launch_status();
}

// grad, out and grad_x: n contiguous elements of one dtype; grad_x may not
// alias the others.
extern "C" int e4s_fused_leaky_relu_backward(const void* grad, const void* out, void* grad_x,
                                             int dtype, long long n, float slope, float gain,
                                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case e4s::kFloat32:
      launch_backward<float>(grad, out, grad_x, n, slope, gain, s);
      break;
    case e4s::kBFloat16:
      launch_backward<__nv_bfloat16>(grad, out, grad_x, n, slope, gain, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return e4s::launch_status();
}
