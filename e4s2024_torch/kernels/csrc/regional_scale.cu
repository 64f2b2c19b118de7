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
// Design. Each thread owns one 16-byte vector of pixels (4 float32 or 8
// bfloat16) and walks a set of channels; the (B, C, H, W) scale tensor is
// never formed in device memory.
// - The K region weights of its pixels stay in registers (K x 4 or K x 8
//   floats; K is padded to 12 or 16, a template parameter, with zero scales
//   for the padding), loaded once as K 16-byte vectors.
// - A block stages scales[b, :, its channels] in shared memory as [c][k], so
//   one channel's K scales are K / 4 16-byte broadcast reads, and each serves
//   all of the thread's pixels.
// - Loads in flight: the weights, the first four channels and the block's
//   scales are issued together before the one barrier; then the channel
//   loop keeps the next four channels' 16-byte loads in flight under this
//   four's arithmetic. Addresses past the end are clamped, not branched on.
//   x and out go through the streaming cache hints (read and written once);
//   seg is read through the read-only path (the block's channel chunks share
//   it through L2).
// - The grid is shaped to the plane: a block of 128 threads spans min(128,
//   pixel vectors) vectors of its plane and as many channel groups as fill
//   it, so the 4^2-16^2 levels (one to 32 vectors a plane) span channels, and
//   channels per thread are chosen so that the grid is about one wave of
//   resident blocks (each thread then streams many channels).
// - bfloat16 stores pack pairs with cvt.rn.bf16x2 into one 16-byte store.
// Planes whose pixel count is not a multiple of the vector (or unaligned
// tensors) take the same code with one pixel a thread.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSpan = 256;  // channels a block stages
constexpr int kMaxRegions = 16;

// V consecutive values: one 16-byte vector (V = 16 / sizeof(T)) or one
// scalar (V = 1), loaded as raw bits and widened to floats where used, so
// that four loads in flight hold 16 registers, not 32, in bfloat16.
template <typename T, int V>
struct Pack {
  using type = T;
};
template <>
struct Pack<float, 4> {
  using type = float4;
};
template <>
struct Pack<__nv_bfloat16, 8> {
  using type = uint4;
};

// STREAM: the streaming (evict-first) hint for data read once; else the
// read-only path.
template <typename T, int V, bool STREAM>
__device__ __forceinline__ typename Pack<T, V>::type load_raw(const T* p) {
  using P = typename Pack<T, V>::type;
  if constexpr (V == 1)
    return *p;
  else
    return STREAM ? __ldcs(reinterpret_cast<const P*>(p)) : __ldg(reinterpret_cast<const P*>(p));
}

template <typename T, int V>
__device__ __forceinline__ void widen(const typename Pack<T, V>::type& a, float* v) {
  if constexpr (V == 1) {
    v[0] = e4s::load_f32(&a);
  } else if constexpr (sizeof(T) == 4) {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = e4s::bf16_lo(w[i]);
      v[2 * i + 1] = e4s::bf16_hi(w[i]);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (V == 1) {
    e4s::store_f32(p, v[0]);
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(e4s::pack_bf16x2(v[0], v[1]), e4s::pack_bf16x2(v[2], v[3]),
                      e4s::pack_bf16x2(v[4], v[5]), e4s::pack_bf16x2(v[6], v[7])));
  }
}

// grid: x pixel-vector blocks, y channel chunks of span = groups * per_thread
// channels, z samples. Thread: vector tid % vecs_per_block of the block's
// range, channel group g = tid / vecs_per_block, channels c0 + g + groups * j.
template <typename T, int V, int KMAX>
__global__ void __launch_bounds__(kThreads)
regional_scale_kernel(const T* __restrict__ x, const T* __restrict__ seg,
                      const T* __restrict__ scales, T* __restrict__ out,
                      int channels, int regions, long long hw, int vecs_per_block,
                      int groups, int per_thread) {
  using P = typename Pack<T, V>::type;
  __shared__ __align__(16) float s[kMaxSpan * KMAX];

  const long long b = blockIdx.z;
  const int span = groups * per_thread;
  const int c0 = blockIdx.y * span;
  const int g = threadIdx.x / vecs_per_block;
  const long long p =
      (static_cast<long long>(blockIdx.x) * vecs_per_block + threadIdx.x % vecs_per_block) * V;
  const bool live = g < groups && p < hw;
  const T* xb = x + b * channels * hw + p;
  // channel j of this thread; past its last, the last again (loads are not
  // branched on it)
  auto channel = [&](int j) {
    return min(c0 + g + groups * min(j, per_thread - 1), channels - 1);
  };

  // Issue the region weights and the first four channels, then stage the
  // scales: all of these loads are in flight together.
  P seg_raw[KMAX], cur[4], nxt[4];
  if (live) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k)  // padding regions re-read the last; their scales are 0
      seg_raw[k] = load_raw<T, V, false>(seg + (b * regions + min(k, regions - 1)) * hw + p);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      cur[u] = load_raw<T, V, true>(xb + static_cast<long long>(channel(u)) * hw);
  }
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int c = min(c0 + i, channels - 1);
    float v[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      v[k] = e4s::load_f32(scales + (b * regions + min(k, regions - 1)) * channels + c);
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      s[i * KMAX + k] = k < regions && c0 + i < channels ? v[k] : 0.f;
  }
  __syncthreads();
  if (!live) return;

  float w[KMAX][V];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) widen<T, V>(seg_raw[k], w[k]);

  T* ob = out + b * channels * hw + p;
  for (int j = 0; j < per_thread; j += 4) {
    if (j + 4 < per_thread) {  // the next four channels load under this four's work
#pragma unroll
      for (int u = 0; u < 4; ++u)
        nxt[u] = load_raw<T, V, true>(xb + static_cast<long long>(channel(j + 4 + u)) * hw);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cs = g + groups * (j + u);
      if (j + u >= per_thread || c0 + cs >= channels) break;
      float xv[V];
      widen<T, V>(cur[u], xv);
      const float4* sc = reinterpret_cast<const float4*>(s + cs * KMAX);
      float scale[V];
#pragma unroll
      for (int v = 0; v < V; ++v) scale[v] = 0.f;
#pragma unroll
      for (int q = 0; q < KMAX / 4; ++q) {
        const float4 s4 = sc[q];
        const float sk[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) scale[v] += w[4 * q + r][v] * sk[r];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) xv[v] *= scale[v];
      store_vec<T, V>(ob + static_cast<long long>(c0 + cs) * hw, xv);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) cur[u] = nxt[u];
  }
}

template <typename T, int V, int KMAX>
void launch(const void* x, const void* seg, const void* scales, void* out, long long batch,
            int channels, int regions, long long hw, int device, cudaStream_t stream) {
  auto kernel = regional_scale_kernel<T, V, KMAX>;
  const long long vecs = (hw + V - 1) / V;
  int per_block = 1;
  while (per_block < kThreads && per_block < vecs) per_block *= 2;
  const int groups = kThreads / per_block;
  const long long xblocks = (vecs + per_block - 1) / per_block;
  // channels per thread: as many as make the grid one wave of resident
  // blocks (the occupancy is read once per instance)
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, regional_scale_kernel<T, V, KMAX>,
                                                  kThreads, 0);
    return std::max(n, 1);
  }();
  const long long wave = static_cast<long long>(e4s::multiprocessors(device)) * per_sm;
  const long long chunks = std::max(1LL, wave / (xblocks * batch));
  const int per_group = (channels + groups - 1) / groups;
  int per_thread = static_cast<int>((per_group + chunks - 1) / chunks);
  per_thread = std::min((per_thread + 3) / 4 * 4, kMaxSpan / groups);
  per_thread = std::max(per_thread, 1);
  const int span = groups * per_thread;
  const dim3 grid(static_cast<unsigned>(xblocks),
                  static_cast<unsigned>((channels + span - 1) / span),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(seg), static_cast<const T*>(scales),
      static_cast<T*>(out), channels, regions, hw, per_block, groups, per_thread);
}

template <typename T>
void launch_shape(const void* x, const void* seg, const void* scales, void* out,
                  long long batch, int channels, int regions, long long hw, int device,
                  cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(seg) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const bool vec = aligned && hw % kVec == 0;
  if (regions <= 12) {
    if (vec)
      launch<T, kVec, 12>(x, seg, scales, out, batch, channels, regions, hw, device, s);
    else
      launch<T, 1, 12>(x, seg, scales, out, batch, channels, regions, hw, device, s);
  } else {
    if (vec)
      launch<T, kVec, 16>(x, seg, scales, out, batch, channels, regions, hw, device, s);
    else
      launch<T, 1, 16>(x, seg, scales, out, batch, channels, regions, hw, device, s);
  }
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
      launch_shape<float>(x, seg, scales, out, batch, channels, regions, hw, device, s);
      break;
    case e4s::kBFloat16:
      launch_shape<__nv_bfloat16>(x, seg, scales, out, batch, channels, regions, hw, device, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return e4s::launch_status();
}
