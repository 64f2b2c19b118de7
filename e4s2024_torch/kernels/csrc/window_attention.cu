// K4 and K6: shifted-window attention,
//   out = softmax(round(q * d^-1/2) . k^T + bias[h], -100 where labels differ) . v
//
// K4 replaces e4s2024_tpu/ops/window_attention.py::swin_attention_nhwc
// (pallas_call at :161). It reads the fused qkv projection in its own
// (B, H, W, 3C) layout, channels [q|k|v] x head x head_dim, finds a window's
// tokens from blockIdx, and writes (B, H, W, C): no partitioned copy of q, k
// and v is ever made.
//
// K6 replaces e4s2024_tpu/ops/window_attention.py::fused_window_attention
// (pallas_call at :79). It takes q, k and v already partitioned, each
// (BW, heads, n, hd) contiguous, labels (BW, n), and writes (BW, heads, n, hd).
//
// Both run the same core (window_core.cuh::attend_head) and differ only in
// how a block finds its tokens (NhwcLayout, PartitionedLayout). Labels are
// int32 window-region labels of the shifted image (K4: (H / w, W / w, n);
// K6: (BW, n)) or absent.
//
// Bound on the card: bytes, barely. Per token the work is
// 2 * 2 * n * C = 46,080 operations at n = 64, C = 180 against
// (3C + C) * 4 = 2,880 bytes in float32 (16 operations a byte; the card's
// float32 ridge outside the tensor cores is 20). At 1024^2 that is about
// 0.90 ms of memory against 0.72 ms of float32 arithmetic.
//
// Design (first, simple version): one block of 256 threads per window. For
// each head it stages q (scaled and rounded as the reference rounds it), k
// and v in shared memory with an odd row stride, builds the n x n scores with
// bias and mask, runs the softmax one warp per row in float32, and multiplies
// by v; every element of qkv is read once from device memory and every output
// written once, and the n x n matrices never leave shared memory. The
// products are plain float32 FMAs on register tiles; tensor cores are later
// work.
#include "window_core.cuh"

namespace {

using e4s::win::kThreads;

// K4: the window (blockIdx.x, blockIdx.y) of image blockIdx.z, qkv NHWC.
template <typename T>
struct NhwcLayout {
  const T* qkv;
  T* out;
  const int* labels;
  int height, width, channels, window;

  __device__ long long pixel(int t) const {
    const int ty = t / window, tx = t - ty * window;
    const long long y = static_cast<long long>(blockIdx.y) * window + ty;
    const long long x = static_cast<long long>(blockIdx.x) * window + tx;
    return (static_cast<long long>(blockIdx.z) * height + y) * width + x;
  }
  __device__ const T* in(int part, int head, int hd, int, int t) const {
    return qkv + pixel(t) * 3 * channels + part * channels + head * hd;
  }
  __device__ T* dst(int head, int hd, int, int t) const {
    return out + pixel(t) * channels + head * hd;
  }
  __device__ const int* window_labels(int n) const {
    return labels + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * n;
  }
};

// K6: window instance blockIdx.x of pre-partitioned (BW, heads, n, hd).
template <typename T>
struct PartitionedLayout {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  const int* labels;

  __device__ long long row(int head, int hd, int n, int t) const {
    return ((static_cast<long long>(blockIdx.x) * heads_ + head) * n + t) * hd;
  }
  __device__ const T* in(int part, int head, int hd, int n, int t) const {
    const T* base = part == 0 ? q : (part == 1 ? k : v);
    return base + row(head, hd, n, t);
  }
  __device__ T* dst(int head, int hd, int n, int t) const { return out + row(head, hd, n, t); }
  __device__ const int* window_labels(int n) const {
    return labels + static_cast<long long>(blockIdx.x) * n;
  }
  int heads_;
};

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(L lay, const float* __restrict__ bias, int heads, int n, int hd,
                        float scale) {
  extern __shared__ float smem[];
  __shared__ int lab[e4s::win::kMaxTokens];
  const bool masked = lay.labels != nullptr;
  const int ldq = hd + 1;
  float* q = smem;
  float* k = q + n * ldq;
  float* v = k + n * ldq;
  float* s = v + n * ldq;
  if (masked) {
    const int* src = lay.window_labels(n);
    for (int t = threadIdx.x; t < n; t += blockDim.x) lab[t] = src[t];
  }
  for (int h = 0; h < heads; ++h) {
    for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
      const int t = i / hd, d = i - t * hd;
      q[t * ldq + d] = e4s::win::round_to<T>(e4s::load_f32(lay.in(0, h, hd, n, t) + d) * scale);
      k[t * ldq + d] = e4s::load_f32(lay.in(1, h, hd, n, t) + d);
      v[t * ldq + d] = e4s::load_f32(lay.in(2, h, hd, n, t) + d);
    }
    __syncthreads();
    e4s::win::attend_head<T>(q, k, v, s, n, hd, bias + static_cast<long long>(h) * n * n,
                             masked ? lab : nullptr, [&](int t, int d, float acc) {
                               e4s::store_f32(lay.dst(h, hd, n, t) + d, acc);
                             });
    __syncthreads();
  }
}

bool shape_ok(int n, int hd) {
  return n >= 4 && n <= e4s::win::kMaxTokens && n % 4 == 0 && hd >= 1 &&
         hd <= e4s::win::kMaxHeadDim;
}

template <typename T, typename L>
int launch(const L& lay, dim3 grid, const void* bias, int heads, int n, int hd, float scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * e4s::win::head_floats(n, hd);
  auto* kernel = window_attention_kernel<T, L>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(lay, static_cast<const float*>(bias), heads, n, hd,
                                           scale);
  return e4s::launch_status();
}

}  // namespace

// K4. qkv (batch, height, width, 3 * channels) and out (batch, height, width,
// channels) contiguous in `dtype`; bias (heads, n, n) float32 with
// n = window^2; labels (height / window, width / window, n) int32 or null.
// `scale` is head_dim^-1/2 already rounded to `dtype`. Requires height and
// width multiples of window, n a multiple of 4 up to 64, head_dim <= 64.
extern "C" int e4s_swin_attention_nhwc(const void* qkv, const void* bias, const void* labels,
                                       void* out, int dtype, int batch, int height, int width,
                                       int channels, int heads, int window, float scale,
                                       int device, void* stream) {
  const int n = window * window;
  if (heads <= 0 || window <= 0 || channels % heads != 0 || height % window != 0 ||
      width % window != 0 || !shape_ok(n, channels / heads) || batch > e4s::kMaxGridYZ ||
      height / window > e4s::kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  const int hd = channels / heads;
  const dim3 grid(width / window, height / window, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  switch (dtype) {
    case e4s::kFloat32: {
      const NhwcLayout<float> lay{static_cast<const float*>(qkv), static_cast<float*>(out), lab,
                                  height, width, channels, window};
      return launch<float>(lay, grid, bias, heads, n, hd, scale, s);
    }
    case e4s::kBFloat16: {
      using B16 = __nv_bfloat16;
      const NhwcLayout<B16> lay{static_cast<const B16*>(qkv), static_cast<B16*>(out), lab,
                                height, width, channels, window};
      return launch<B16>(lay, grid, bias, heads, n, hd, scale, s);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6. q, k, v and out (windows, heads, n, head_dim) contiguous in `dtype`;
// bias (heads, n, n) float32; labels (windows, n) int32 or null. `scale` is
// head_dim^-1/2 already rounded to `dtype`. Requires n a multiple of 4 up to
// 64 and head_dim <= 64.
extern "C" int e4s_window_attention(const void* q, const void* k, const void* v,
                                    const void* bias, const void* labels, void* out, int dtype,
                                    long long windows, int heads, int n, int head_dim,
                                    float scale, int device, void* stream) {
  if (heads <= 0 || !shape_ok(n, head_dim) || windows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (windows <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(windows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  switch (dtype) {
    case e4s::kFloat32: {
      const PartitionedLayout<float> lay{static_cast<const float*>(q),
                                         static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(out),
                                         lab, heads};
      return launch<float>(lay, grid, bias, heads, n, head_dim, scale, s);
    }
    case e4s::kBFloat16: {
      using B16 = __nv_bfloat16;
      const PartitionedLayout<B16> lay{static_cast<const B16*>(q), static_cast<const B16*>(k),
                                       static_cast<const B16*>(v), static_cast<B16*>(out), lab,
                                       heads};
      return launch<B16>(lay, grid, bias, heads, n, head_dim, scale, s);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
