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
// Both are one kernel over the tensor-core core of window_core.cuh
// (attend_rows) and differ only in how a block finds its tokens (NhwcLayout,
// PartitionedLayout). Labels are int32 window-region labels of the shifted
// image (K4: (H / w, W / w, n); K6: (BW, n)) or absent.
//
// Bound on the card: bytes. Per token the work is 2 * 2 * n * C = 46,080
// operations at n = 64, C = 180 against (3C + C) * 4 = 2,880 bytes in
// float32: at 1024^2 about 0.90 ms of memory traffic (0.45 ms in bfloat16)
// against 0.05 ms of bf16 tensor-core time, or 0.29 ms for the three tf32
// products of the float32 path.
//
// Design: one block of four warps per window, two heads at a time. The
// block reads the two heads' q, k and v along the channel axis with the
// widest vector loads their alignment allows (16 bytes where a run of two
// heads starts on a 16-byte boundary, else 8), writes them to shared memory
// in their own type in the layout the fragments read (q scaled and rounded
// as the reference rounds it, head_dim padded to 32 and the
// window to 64 tokens with zeros), runs attend_rows with one warp per 16
// query rows, parks the result in q's place and writes it out with the same
// vector width. A block holds 26 KB (bfloat16) or 52 KB (float32) of shared
// memory, so four to eight blocks share an SM and one window's loads and
// stores overlap another's products. The first version (4.8 ms for K4 and
// 4.4 ms for K6 at 1024^2 in float32 on an H100 80GB HBM3 at 700 W) ran
// float32 FMAs on 2 x 4 register tiles with scalar loads and kept the n x n
// scores in shared memory.
#include <cstdint>
#include <initializer_list>

#include "window_core.cuh"

namespace {

using e4s::win::kHeadElems;
using e4s::win::kLdHead;
using e4s::win::kMaxHeadDim;
using e4s::win::kMaxTokens;

// Four warps, 16 query rows each, take the step's heads one after the other:
// a smaller block than K5's leaves room for five and more on an SM.
constexpr int kThreads = 128;

// BYTES bytes (2, 4, 8 or 16) moved with one load or store and kept as 32-bit
// words in registers; element j of type T is read from or written to them
// with shifts, never through memory.
template <int BYTES>
struct Words {
  uint32_t w[(BYTES + 3) / 4];

  __device__ __forceinline__ void load(const void* p) {
    if constexpr (BYTES == 16) {
      const uint4 q = *static_cast<const uint4*>(p);
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else if constexpr (BYTES == 8) {
      const uint2 q = *static_cast<const uint2*>(p);
      w[0] = q.x, w[1] = q.y;
    } else if constexpr (BYTES == 4) {
      w[0] = *static_cast<const uint32_t*>(p);
    } else {
      w[0] = *static_cast<const uint16_t*>(p);
    }
  }
  __device__ __forceinline__ void store(void* p) const {
    if constexpr (BYTES == 16) {
      *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (BYTES == 8) {
      *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (BYTES == 4) {
      *static_cast<uint32_t*>(p) = w[0];
    } else {
      *static_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
    }
  }
  template <typename T>
  __device__ __forceinline__ T get(int j) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[j]);
    } else {
      __nv_bfloat16_raw r;
      r.x = static_cast<unsigned short>(j % 2 ? w[j / 2] >> 16 : w[j / 2] & 0xffffu);
      return __nv_bfloat16(r);
    }
  }
  // v is already a value of T
  template <typename T>
  __device__ __forceinline__ void set(int j, float v) {
    if constexpr (sizeof(T) == 4) {
      w[j] = __float_as_uint(v);
    } else {
      const uint32_t bits = __float_as_uint(v) >> 16;
      w[j / 2] = j % 2 ? (w[j / 2] & 0xffffu) | (bits << 16) : bits;
    }
  }
};

// Copies between global and shared memory. Global memory holds `runs`
// contiguous runs of `len` elements (a multiple of VEC) at at(run). Element e
// of a run lives in shared memory at tile(run) + (e / hd) * wrap + e % hd: hd
// neighbours of one head and token, then a step of `wrap` to the next token
// (K6) or head (K4). A thread walks its VEC elements with one division.

// Global to shared; runs for which scaled(run) holds (q) are multiplied by
// `scale` and rounded on the way. A thread has kBatch loads in flight before
// it uses the first.
template <int VEC, typename T, typename At, typename Tile, typename Scaled>
__device__ __forceinline__ void read_runs(int runs, int len, int hd, int wrap, float scale, At at,
                                          Tile tile, Scaled scaled) {
  constexpr int kBatch = 4;
  const int per = len / VEC, total = runs * per;
  for (int first = threadIdx.x; first < total; first += kBatch * kThreads) {
    Words<VEC * sizeof(T)> raw[kBatch];
    int run[kBatch], e0[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = min(first + b * kThreads, total - 1);
      run[b] = i / per;
      e0[b] = (i - run[b] * per) * VEC;
      raw[b].load(at(run[b]) + e0[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (first + b * kThreads < total) {
        const int hi = e0[b] / hd;
        int lo = e0[b] - hi * hd;
        T* dst = tile(run[b]) + hi * wrap + lo;
        const bool q = scaled(run[b]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const T v = raw[b].template get<T>(j);
          if (q) {
            e4s::store_f32(dst, e4s::load_f32(&v) * scale);  // the store rounds
          } else {
            *dst = v;
          }
          ++dst;
          if (++lo == hd) lo = 0, dst += wrap - hd;
        }
      }
    }
  }
}

// Shared to global.
template <int VEC, typename T, typename At, typename Tile>
__device__ __forceinline__ void write_runs(int runs, int len, int hd, int wrap, At at, Tile tile) {
  const int per = len / VEC;
  for (int i = threadIdx.x; i < runs * per; i += kThreads) {
    const int run = i / per, e0 = (i - run * per) * VEC;
    const int hi = e0 / hd;
    int lo = e0 - hi * hd;
    const T* src = tile(run) + hi * wrap + lo;
    Words<VEC * sizeof(T)> raw;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      raw.template set<T>(j, e4s::load_f32(src));
      ++src;
      if (++lo == hd) lo = 0, src += wrap - hd;
    }
    raw.store(at(run) + e0);
  }
}

// K4: the window (blockIdx.x, blockIdx.y) of image blockIdx.z, qkv NHWC. A
// run is one token's channels of one of q, k, v over the heads of the step.
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
  template <int VEC>
  __device__ void load(T* tiles, int h0, int nh, int, int n, int hd, float scale) const {
    read_runs<VEC, T>(
        3 * n, nh * hd, hd, kHeadElems, scale,
        [&](int run) { return qkv + (pixel(run / 3) * 3 + run % 3) * channels + h0 * hd; },
        [&](int run) { return tiles + (run / 3) * kLdHead + (run % 3) * kMaxHeadDim; },
        [](int run) { return run % 3 == 0; });
  }
  template <int VEC>
  __device__ void store(const T* tiles, int h0, int nh, int, int n, int hd) const {
    write_runs<VEC, T>(
        n, nh * hd, hd, kHeadElems,
        [&](int run) { return out + pixel(run) * channels + h0 * hd; },
        [&](int run) { return tiles + run * kLdHead; });
  }
  __device__ const int* window_labels(int n) const {
    return labels + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * n;
  }
};

// K6: window instance blockIdx.x of pre-partitioned (BW, heads, n, hd). A run
// is one head's (n, hd) block of one of q, k, v.
template <typename T>
struct PartitionedLayout {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  const int* labels;

  __device__ long long head_offset(int head, int heads, int n, int hd) const {
    return (static_cast<long long>(blockIdx.x) * heads + head) * n * hd;
  }
  template <int VEC>
  __device__ void load(T* tiles, int h0, int nh, int heads, int n, int hd, float scale) const {
    read_runs<VEC, T>(
        3 * nh, n * hd, hd, kLdHead, scale,
        [&](int run) {
          const int part = run / nh;
          return (part == 0 ? q : (part == 1 ? k : v)) + head_offset(h0 + run % nh, heads, n, hd);
        },
        [&](int run) { return tiles + (run % nh) * kHeadElems + (run / nh) * kMaxHeadDim; },
        [&](int run) { return run < nh; });
  }
  template <int VEC>
  __device__ void store(const T* tiles, int h0, int nh, int heads, int n, int hd) const {
    write_runs<VEC, T>(
        nh, n * hd, hd, kLdHead,
        [&](int run) { return out + head_offset(h0 + run, heads, n, hd); },
        [&](int run) { return tiles + run * kHeadElems; });
  }
  __device__ const int* window_labels(int n) const {
    return labels + static_cast<long long>(blockIdx.x) * n;
  }
};

template <typename T, typename L, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
window_attention_kernel(L lay, const float* __restrict__ bias, int heads, int n, int hd,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int lab[kMaxTokens];
  T* tiles = reinterpret_cast<T*>(smem_raw);  // two heads
  const bool masked = lay.labels != nullptr;
  if (masked && threadIdx.x < n) lab[threadIdx.x] = lay.window_labels(n)[threadIdx.x];
  // the padding (head_dim to 32, tokens to 64) stays zero throughout
  for (int i = threadIdx.x; i < 2 * kHeadElems; i += kThreads) e4s::store_f32(tiles + i, 0.f);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const uint32_t differ = e4s::win::label_mask(masked ? lab : nullptr, n, 16 * warp);
  for (int h0 = 0; h0 < heads; h0 += 2) {
    const int nh = min(2, heads - h0);
    lay.template load<VEC>(tiles, h0, nh, heads, n, hd, scale);
    __syncthreads();
    for (int hl = 0; hl < nh; ++hl) {
      T* head = tiles + hl * kHeadElems;
      // a warp reads only its own rows of q, and has read them all before
      // its first sum is complete: the result can take their place
      e4s::win::attend_rows<T>(head, n, bias + static_cast<long long>(h0 + hl) * n * n, differ,
                               16 * warp, [&](int row, int col, float a, float b) {
                                 e4s::win::store_in_head(head + row * kLdHead + col, col, hd, a, b);
                               });
    }
    __syncthreads();
    lay.template store<VEC>(tiles, h0, nh, heads, n, hd);
    __syncthreads();
  }
}

bool shape_ok(int n, int hd) {
  return n >= 1 && n <= kMaxTokens && hd >= 1 && hd <= kMaxHeadDim;
}

// The widest vector (in elements, at most 16 bytes) that divides `len` and
// the alignment of every pointer.
template <typename T>
int vector_width(std::initializer_list<const void*> pointers, long long len) {
  int vec = 16 / static_cast<int>(sizeof(T));
  for (; vec > 1; vec /= 2) {
    bool ok = len % vec == 0;
    for (const void* p : pointers)
      ok = ok && reinterpret_cast<uintptr_t>(p) % (vec * sizeof(T)) == 0;
    if (ok) break;
  }
  return vec;
}

template <typename T, typename L, int VEC>
int launch_vec(const L& lay, dim3 grid, const float* bias, int heads, int n, int hd, float scale,
               cudaStream_t stream) {
  const int smem = 2 * kHeadElems * static_cast<int>(sizeof(T));
  auto* kernel = window_attention_kernel<T, L, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as much of the SM's memory as shared memory as it can have, so that the
  // blocks' count is not cut by the split with L1
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(lay, bias, heads, n, hd, scale);
  return e4s::launch_status();
}

template <typename T, typename L>
int launch(const L& lay, dim3 grid, const void* bias, int heads, int n, int hd, float scale,
           int vec, cudaStream_t stream) {
  const float* b = static_cast<const float*>(bias);
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) {
        return launch_vec<T, L, 8>(lay, grid, b, heads, n, hd, scale, stream);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    case 4:
      return launch_vec<T, L, 4>(lay, grid, b, heads, n, hd, scale, stream);
    case 2:
      return launch_vec<T, L, 2>(lay, grid, b, heads, n, hd, scale, stream);
    default:
      return launch_vec<T, L, 1>(lay, grid, b, heads, n, hd, scale, stream);
  }
}

template <typename T>
int launch_nhwc(const void* qkv, const void* bias, const int* labels, void* out, dim3 grid,
                int height, int width, int channels, int heads, int window, float scale,
                cudaStream_t stream) {
  const int hd = channels / heads;
  // runs start at multiples of C and of 2 * hd and are 2 * hd long, but for
  // a last odd head's, which is hd long
  const long long unit = heads % 2 == 0 ? 2 * hd : hd;
  const NhwcLayout<T> lay{static_cast<const T*>(qkv), static_cast<T*>(out), labels,
                          height, width, channels, window};
  return launch<T>(lay, grid, bias, heads, window * window, hd, scale,
                   vector_width<T>({qkv, out}, unit), stream);
}

template <typename T>
int launch_partitioned(const void* q, const void* k, const void* v, const void* bias,
                       const int* labels, void* out, dim3 grid, int heads, int n, int hd,
                       float scale, cudaStream_t stream) {
  const PartitionedLayout<T> lay{static_cast<const T*>(q), static_cast<const T*>(k),
                                 static_cast<const T*>(v), static_cast<T*>(out), labels};
  return launch<T>(lay, grid, bias, heads, n, hd, scale,
                   vector_width<T>({q, k, v, out}, static_cast<long long>(n) * hd), stream);
}

}  // namespace

// K4. qkv (batch, height, width, 3 * channels) and out (batch, height, width,
// channels) contiguous in `dtype`; bias (heads, n, n) float32 with
// n = window^2; labels (height / window, width / window, n) int32 or null.
// `scale` is head_dim^-1/2 already rounded to `dtype`. Requires height and
// width multiples of window, n <= 64, head_dim <= 32.
extern "C" int e4s_swin_attention_nhwc(const void* qkv, const void* bias, const void* labels,
                                       void* out, int dtype, int batch, int height, int width,
                                       int channels, int heads, int window, float scale,
                                       int device, void* stream) {
  const int n = window * window;
  if (heads <= 0 || window <= 0 || channels <= 0 || channels % heads != 0 ||
      height % window != 0 || width % window != 0 || !shape_ok(n, channels / heads) ||
      batch > e4s::kMaxGridYZ || height / window > e4s::kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  const dim3 grid(width / window, height / window, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  switch (dtype) {
    case e4s::kFloat32:
      return launch_nhwc<float>(qkv, bias, lab, out, grid, height, width, channels, heads,
                                window, scale, s);
    case e4s::kBFloat16:
      return launch_nhwc<__nv_bfloat16>(qkv, bias, lab, out, grid, height, width, channels,
                                        heads, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6. q, k, v and out (windows, heads, n, head_dim) contiguous in `dtype`;
// bias (heads, n, n) float32; labels (windows, n) int32 or null. `scale` is
// head_dim^-1/2 already rounded to `dtype`. Requires n <= 64 and
// head_dim <= 32.
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
    case e4s::kFloat32:
      return launch_partitioned<float>(q, k, v, bias, lab, out, grid, heads, n, head_dim, scale,
                                       s);
    case e4s::kBFloat16:
      return launch_partitioned<__nv_bfloat16>(q, k, v, bias, lab, out, grid, heads, n, head_dim,
                                               scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
