// K3: per-pixel regional scale, out[b,c,p] = x[b,c,p] * sum_k seg[b,k,p] * scales[b,k,c].
//
// Replaces the TPU kernel
// e4s2024_tpu/ops/pallas/kernels.py::modulate_demodulate_tpu (pallas_call at
// :159). It is the modulate and demodulate step of the fast regional mode and
// the modulation of every masked ToRGB layer (which runs the fast form in both
// regional modes).
//
// Layout: x and out are contiguous (B, C, H, W); seg is the (B, K, H, W)
// one-hot region map at the same resolution; scales is (B, K, C).
//
// Bound on the card: bytes. Each element of x is read once and written once;
// seg adds K values per pixel; the work is 2K + 1 operations per element,
// about 3 per byte in float32, well below the card's ridge.
//
// Design (first, simple version): a block owns 256 pixels of one sample and
// a chunk of 64 channels. It stages scales[b, :, chunk] (K x 64 floats) in
// shared memory, where every thread reads the same word at once (a
// broadcast), and keeps its pixel's K region weights in registers, so the
// (B, C, H, W) scale tensor is never formed in device memory. Each thread then
// walks the chunk's channels: a K-term dot product and one multiply per
// element; neighbouring threads touch neighbouring pixels, so every load and
// store is coalesced. Fusing this scale into the convolution's prologue and
// epilogue is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // pixels per block
constexpr int kChanPerBlock = 64;  // channels per block
constexpr int kMaxRegions = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
regional_scale_kernel(const T* __restrict__ x, const T* __restrict__ seg,
                      const T* __restrict__ scales, T* __restrict__ out,
                      int channels, int regions, long long hw) {
  __shared__ float s[kMaxRegions][kChanPerBlock];

  const long long b = blockIdx.z;
  const int c0 = blockIdx.y * kChanPerBlock;
  const int nc = min(kChanPerBlock, channels - c0);
  for (int i = threadIdx.x; i < kMaxRegions * kChanPerBlock; i += kThreads) {
    const int k = i / kChanPerBlock;
    const int c = i - k * kChanPerBlock;
    s[k][c] = (k < regions && c < nc)
                  ? e4s::load_f32(scales + (b * regions + k) * channels + c0 + c)
                  : 0.f;
  }
  __syncthreads();

  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= hw) return;

  float w[kMaxRegions];
#pragma unroll
  for (int k = 0; k < kMaxRegions; ++k)
    w[k] = k < regions ? e4s::load_f32(seg + (b * regions + k) * hw + p) : 0.f;

  const long long base = (b * channels + c0) * hw + p;
  for (int c = 0; c < nc; ++c) {
    float scale = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxRegions; ++k) scale += w[k] * s[k][c];
    const long long i = base + static_cast<long long>(c) * hw;
    e4s::store_f32(out + i, e4s::load_f32(x + i) * scale);
  }
}

template <typename T>
void launch(const void* x, const void* seg, const void* scales, void* out,
            long long batch, int channels, int regions, long long hw,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>((channels + kChanPerBlock - 1) / kChanPerBlock),
                  static_cast<unsigned>(batch));
  regional_scale_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(seg),
      static_cast<const T*>(scales), static_cast<T*>(out), channels, regions, hw);
}

}  // namespace

// Requires 1 <= regions <= 16 and batch <= 65535.
extern "C" int e4s_regional_scale(const void* x, const void* seg,
                                  const void* scales, void* out, int dtype,
                                  long long batch, int channels, int regions,
                                  long long hw, int device, void* stream) {
  if (regions < 1 || regions > kMaxRegions || batch > e4s::kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || channels <= 0 || hw <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case e4s::kFloat32:
      launch<float>(x, seg, scales, out, batch, channels, regions, hw, s);
      break;
    case e4s::kBFloat16:
      launch<__nv_bfloat16>(x, seg, scales, out, batch, channels, regions, hw, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return e4s::launch_status();
}
