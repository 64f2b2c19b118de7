// K2: upfirdn2d, upsample by zero-stuffing, pad, FIR filter, downsample.
//
// Replaces the TPU kernel e4s2024_tpu/ops/pallas/kernels.py::blur3x3_tpu
// (pallas_call at :115), which covers one case only (up 1, pad (2, 1)). The
// generator runs others, so this kernel is the general 4-tap upfirdn2d, as
// the original StyleGAN2 CUDA extension was: the x4-gain blur with pad (1, 1)
// after every transposed convolution, the up 2 / pad (2, 1) upsample of every
// ToRGB skip, and down 2 for downsample_2x.
//
// Semantics (e4s2024_tpu/ops/upfirdn.py): with u the input zero-stuffed by
// `up` (up - 1 zeros after each sample), out[o] = sum_t taps[t] *
// u[o * down + t - pad0], where taps is the FIR kernel flipped (a true
// convolution) and any index outside u reads zero. Negative pads crop. The
// output size is (H * up + pad0 + pad1 - kh) / down + 1.
//
// Layout: x is (planes, H, W) contiguous (NCHW with N * C planes).
//
// Bound on the card: bytes. A 4x4 filter costs at most 32 operations per
// output element, under ten per byte moved, below the H100's float32 ridge.
// The main path's blurs read (2r + 1)^2 planes and write (2r)^2 ones.
//
// Design. Two kernels, neither with shared memory nor a barrier: each
// thread reads its input straight from global memory (neighbouring
// threads' overlap meets in L1), zeroes samples outside
// the image by selects after loads at clamped addresses, so no load sits
// behind a branch, and stores 4 output columns at once.
// - Rank-1 taps at up 1 / down 1 (the generator's outer([1,3,3,1]) x gain:
//   the 8 blurs of every swap), `upfirdn2d_kernel_rank1`, 4 output columns
//   x 8 rows a thread. Per input row a thread loads the 16-byte-aligned
//   chunks that cover its 7 input columns (3 in float32, 2 in bfloat16), so
//   a warp's row of 128 columns arrives in a few L1 wavefronts; the row's
//   misalignment within the first chunk is applied by selects on registers
//   (the main path's rows, 1025, 513, ... wide, start at every offset, so
//   neither 16-byte copies of a row nor TMA, which needs 16-byte row
//   strides, can land them aligned). A horizontal 4-tap pass per input row,
//   then a vertical 4-tap pass into the 8 rows held in registers (11 input
//   rows per 8 output rows). Threads are laid out column group fastest,
//   then row strip, then plane, so small planes (the 9^2 and 17^2 inputs of
//   the low levels, thousands of planes) fill every thread, and more than
//   65,535 planes need no grid loop.
//   Why not cp.async: this path first staged tile windows into double-
//   buffered shared memory with cp.async in a persistent grid. On an H100
//   the float32 1024^2 blur then took 0.135 ms (4-byte copies) and 0.167 ms
//   (16-byte copies from each row's aligned address), bfloat16 0.159 and
//   0.130 ms, against bounds of 0.080 and 0.040; the direct loads took 0.108
//   and 0.077 ms (chip_smoke.py device_ms, 4 columns a thread in both types).
// - Any other taps, up 2, down 2 (on the main path only the ToRGB skips' up-2
//   upsample of 3-channel planes), `upfirdn2d_kernel`, 4 output columns of
//   one row a thread: per tap row it loads, one element each, the (3 * down
//   + 4) zero-stuffed columns its outputs reach and zeroes those that fall
//   between samples, then forms the outputs with compile-time indices.
// - Stores: a float4 or four bfloat16 packed by cvt.rn.bf16x2 into 8 bytes,
//   where the output width is a multiple of 4 (every main-path width is);
//   else element by element.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCols = 4;     // output columns per thread
constexpr int kRows = 8;     // output rows per thread of the rank-1 kernel
constexpr int kTaps = 4;     // filter height and width at most
constexpr int kThreads = 128;
constexpr int kChunk = 16;   // bytes per load of the rank-1 kernel

struct Taps {
  // general: row-major 4 x 4, flipped, zero-padded; rank-1: k[0..3] the
  // vertical taps, k[4..7] the horizontal ones, flipped, zero-padded
  float k[kTaps * kTaps];
};

struct Geometry {
  long long planes, items;     // items: threads of the launch
  int in_h, in_w, out_h, out_w, pad0;
  unsigned groups_x, strips_y;  // a plane's column groups and (rank-1) 8-row strips
  int vec_store;               // out_w % 4 == 0 and the output 16-byte aligned
};

template <int UP>
__device__ __forceinline__ bool on_sample(int a) { return UP == 1 || (a & 1) == 0; }

// The 4 outputs of row oy from column ox: a 16-byte float4, or four
// bfloat16 packed by cvt.rn.bf16x2 into 8 bytes, where g.vec_store says the
// row allows, else one by one.
template <typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ out, const Geometry& g, long long plane,
                                           int oy, int ox, const float* v) {
  if (oy >= g.out_h || ox >= g.out_w) return;
  T* p = out + (plane * g.out_h + oy) * g.out_w + ox;
  if (g.vec_store) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<uint2*>(p) =
          make_uint2(e4s::pack_bf16x2(v[0], v[1]), e4s::pack_bf16x2(v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (ox + j < g.out_w) e4s::store_f32(p + j, v[j]);
  }
}

// Rank-1 taps, up 1, down 1, read straight from global memory: a thread
// owns 4 output columns of 8 rows; output (oy, ox) reads input row
// oy - pad0 + ty and column ox - pad0 + tx. Per input row it loads the
// 16-byte-aligned chunks that cover its 7 columns (3 in float32, 2 in
// bfloat16; neighbouring threads' chunks overlap and meet in L1), applies
// the row's offset within the first chunk by selects, zeroes columns and
// rows outside the image, and runs the horizontal pass; the vertical pass
// accumulates into the 8 rows held in registers. (Issuing all 11 rows'
// loads before the arithmetic, or 8 columns a thread in bfloat16, measured
// slower on an H100.)
template <typename T>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_kernel_rank1(const T* __restrict__ x, T* __restrict__ out, Taps taps, Geometry g) {
  constexpr int kElems = kChunk / sizeof(T);
  constexpr int kWin = kCols + kTaps - 1;                      // input columns used
  constexpr int kLoads = (kWin + kElems - 1 + kElems - 1) / kElems;  // chunks per row
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.items) return;
  const int ox = static_cast<int>(t % g.groups_x) * kCols;
  const unsigned rest = t / g.groups_x;
  const int oy0 = static_cast<int>(rest % g.strips_y) * kRows;
  const long long plane = rest / g.strips_y;
  const int ix = ox - g.pad0;  // input column of window column 0

  unsigned cols = 0;  // bit q: window column q lies in the image
#pragma unroll
  for (int q = 0; q < kWin; ++q) cols |= (ix + q >= 0 && ix + q < g.in_w) ? 1u << q : 0u;
  const bool edge = cols != (1u << kWin) - 1;
  // chunks that could fall outside x (at its first or last samples) are
  // clamped into it; the columns they hold are outside the image
  const bool clamp = edge || (plane == 0 && oy0 < g.pad0 + 1) ||
                     (plane == g.planes - 1 && oy0 + kRows + kTaps - 1 - g.pad0 >= g.in_h);
  using Addr = unsigned long long;
  const Addr lo = reinterpret_cast<Addr>(x) & ~Addr(kChunk - 1);
  const Addr hi = reinterpret_cast<Addr>(x + g.planes * g.in_h * g.in_w - 1) & ~Addr(kChunk - 1);
  const T* xp = x + plane * g.in_h * g.in_w;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int m = 0; m < kRows + kTaps - 1; ++m) {
    const int iy = oy0 - g.pad0 + m;
    const bool row_ok = iy >= 0 && iy < g.in_h;
    const Addr a = reinterpret_cast<Addr>(
        xp + static_cast<long long>(min(max(iy, 0), g.in_h - 1)) * g.in_w + ix);
    const int sh = static_cast<int>((a & (kChunk - 1)) / sizeof(T));
    uint32_t wd[4 * kLoads];  // the chunks' 32-bit words
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      Addr chunk = (a & ~Addr(kChunk - 1)) + k * kChunk;
      if (clamp) chunk = min(max(chunk, lo), hi);
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(chunk));
      wd[4 * k] = v.x; wd[4 * k + 1] = v.y; wd[4 * k + 2] = v.z; wd[4 * k + 3] = v.w;
    }
    float e[kWin + 1];  // e[q] = window column q
    if constexpr (sizeof(T) == 4) {  // shift by sh words
      uint32_t s1[4 * kLoads - 1];
#pragma unroll
      for (int q = 0; q < 4 * kLoads - 1; ++q) s1[q] = (sh & 1) ? wd[q + 1] : wd[q];
#pragma unroll
      for (int q = 0; q < kWin; ++q) e[q] = __uint_as_float((sh & 2) ? s1[q + 2] : s1[q]);
    } else {  // shift by sh >> 1 words, then by sh & 1 halves
      uint32_t s1[4 * kLoads - 1], s2[4 * kLoads - 3];
#pragma unroll
      for (int i = 0; i < 4 * kLoads - 1; ++i) s1[i] = (sh & 2) ? wd[i + 1] : wd[i];
#pragma unroll
      for (int i = 0; i < 4 * kLoads - 3; ++i) s2[i] = (sh & 4) ? s1[i + 2] : s1[i];
#pragma unroll
      for (int i = 0; i < (kWin + 1) / 2; ++i) {
        const uint32_t u = __funnelshift_r(s2[i], s2[i + 1], (sh & 1) * 16);
        e[2 * i] = e4s::bf16_lo(u);
        e[2 * i + 1] = e4s::bf16_hi(u);
      }
    }
    if (edge) {
#pragma unroll
      for (int q = 0; q < kWin; ++q) e[q] = (cols >> q) & 1 ? e[q] : 0.f;
    }
    float h[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      h[j] = 0.f;
#pragma unroll
      for (int tx = 0; tx < kTaps; ++tx) h[j] += taps.k[kTaps + tx] * e[j + tx];
      h[j] = row_ok ? h[j] : 0.f;
    }
#pragma unroll
    for (int ty = 0; ty < kTaps; ++ty) {
      const int i = m - ty;
      if (i >= 0 && i < kRows) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] += taps.k[ty] * h[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) store_cols<T>(out, g, plane, oy0 + i, ox, acc[i]);
}

// Any taps, up and down 1 or 2, one element per load: a thread owns 4
// output columns of one row; output (oy, ox) reads zero-stuffed row
// oy * DOWN - pad0 + ty and column ox * DOWN - pad0 + tx, which holds input
// sample (row, column) / UP where both are multiples of UP. A grid-stride
// loop covers any number of threads.
template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ out, Taps taps, Geometry g) {
  constexpr int kSpan = (kCols - 1) * DOWN + kTaps;  // zero-stuffed columns reached
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < g.items;
       t += step) {
    const int ox = static_cast<int>(t % g.groups_x) * kCols;
    const long long rest = t / g.groups_x;
    const int oy = static_cast<int>(rest % g.out_h);
    const long long plane = rest / g.out_h;
    const T* xp = x + plane * g.in_h * g.in_w;
    const int ax0 = ox * DOWN - g.pad0;
    int col[kSpan];  // input column of zero-stuffed column q, clamped into the row
    unsigned cols = 0;  // bit q: zero-stuffed column q holds a sample of the image
#pragma unroll
    for (int q = 0; q < kSpan; ++q) {
      const int ix = (ax0 + q) >> (UP - 1);  // arithmetic shift: floor
      cols |= on_sample<UP>(ax0 + q) && ix >= 0 && ix < g.in_w ? 1u << q : 0u;
      col[q] = min(max(ix, 0), g.in_w - 1);
    }
    float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ty = 0; ty < kTaps; ++ty) {
      const int ay = oy * DOWN + ty - g.pad0;
      const int iy = ay >> (UP - 1);
      const bool row_ok = on_sample<UP>(ay) && iy >= 0 && iy < g.in_h;
      const T* row = xp + static_cast<long long>(min(max(iy, 0), g.in_h - 1)) * g.in_w;
      float e[kSpan];
#pragma unroll
      for (int q = 0; q < kSpan; ++q) {
        const float v = e4s::load_f32(row + col[q]);
        e[q] = row_ok && ((cols >> q) & 1) ? v : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j)
#pragma unroll
        for (int tx = 0; tx < kTaps; ++tx) acc[j] += taps.k[ty * kTaps + tx] * e[j * DOWN + tx];
    }
    store_cols<T>(out, g, plane, oy, ox, acc);
  }
}

template <typename T, int UP, int DOWN>
void launch(const void* x, void* out, const Taps& taps, const Geometry& g, cudaStream_t s) {
  const long long blocks = std::min((g.items + kThreads - 1) / kThreads, 1LL << 30);
  upfirdn2d_kernel<T, UP, DOWN><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), taps, g);
}

template <typename T>
void launch_factors(const void* x, void* out, const Taps& taps, const Geometry& g, int up,
                    int down, cudaStream_t s) {
  if (up == 1 && down == 1) return launch<T, 1, 1>(x, out, taps, g, s);
  if (up == 2 && down == 1) return launch<T, 2, 1>(x, out, taps, g, s);
  if (up == 1 && down == 2) return launch<T, 1, 2>(x, out, taps, g, s);
  launch<T, 2, 2>(x, out, taps, g, s);
}

template <typename T>
void launch_rank1(const void* x, void* out, const Taps& taps, const Geometry& g,
                  cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((g.items + kThreads - 1) / kThreads);
  upfirdn2d_kernel_rank1<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                                      static_cast<T*>(out), taps, g);
}

}  // namespace

// taps: host float32 values, flipped and scaled by the caller: with rank1
// (up 1 and down 1 only), kh vertical then kw horizontal taps; else kh * kw
// row-major. Requires up and down in {1, 2} and 1 <= kh, kw <= 4.
extern "C" int e4s_upfirdn2d(const void* x, void* out, int dtype,
                             long long planes, int in_h, int in_w, int out_h,
                             int out_w, int up, int down, int pad0,
                             const float* taps, int kh, int kw, int rank1, int device,
                             void* stream) {
  if (up < 1 || up > 2 || down < 1 || down > 2 || kh < 1 || kh > kTaps || kw < 1 ||
      kw > kTaps || (rank1 && (up != 1 || down != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes <= 0 || out_h <= 0 || out_w <= 0) return 0;
  if (dtype != e4s::kFloat32 && dtype != e4s::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == e4s::kBFloat16 ? 2 : 4;
  Geometry g = {};
  g.planes = planes;
  g.in_h = in_h; g.in_w = in_w; g.out_h = out_h; g.out_w = out_w; g.pad0 = pad0;
  g.groups_x = static_cast<unsigned>((out_w + kCols - 1) / kCols);
  g.vec_store = out_w % kCols == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the rank-1 path reads whole 16-byte chunks of x: it takes inputs of
  // four chunks or more, and thread counts that fit 32 bits
  const long long strips = (out_h + kRows - 1) / kRows;
  const long long items = planes * strips * g.groups_x;
  Taps t = {};
  if (rank1 && planes * in_h * in_w * elem >= 4 * kChunk && items < (1LL << 32)) {
    for (int i = 0; i < kh; ++i) t.k[i] = taps[i];
    for (int i = 0; i < kw; ++i) t.k[kTaps + i] = taps[kh + i];
    g.strips_y = static_cast<unsigned>(strips);
    g.items = items;
    if (dtype == e4s::kFloat32)
      launch_rank1<float>(x, out, t, g, s);
    else
      launch_rank1<__nv_bfloat16>(x, out, t, g, s);
  } else {
    for (int ty = 0; ty < kh; ++ty)
      for (int tx = 0; tx < kw; ++tx)
        t.k[ty * kTaps + tx] = rank1 ? taps[ty] * taps[kh + tx] : taps[ty * kw + tx];
    g.items = planes * out_h * g.groups_x;
    if (dtype == e4s::kFloat32)
      launch_factors<float>(x, out, t, g, up, down, s);
    else
      launch_factors<__nv_bfloat16>(x, out, t, g, up, down, s);
  }
  return e4s::launch_status();
}
