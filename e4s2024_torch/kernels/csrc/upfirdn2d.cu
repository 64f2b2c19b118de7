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
//
// Design (first, simple version): one block computes a 32 x 32 output tile
// of one plane. It stages the input window the tile needs, halo included and
// out-of-range samples as zeros, in shared memory, then each thread forms
// four outputs from the staged window with the taps held in registers. `up`
// and `down` are template parameters (1 or 2), so the index arithmetic is
// shifts and masks, and the zero-stuffed samples are skipped, not
// multiplied. Grid z walks the planes. Overlapping the next window's load
// with this one's arithmetic, or fusing the blur into the transposed
// convolution, is later work.
#include "common.cuh"

namespace {

constexpr int kTileW = 32;   // output columns per block (threads along x)
constexpr int kTileH = 32;   // output rows per block
constexpr int kRowsY = 8;    // threads along y; each computes kTileH / kRowsY rows
constexpr int kMaxTaps = 4;  // filter height and width at most
constexpr int kMaxDown = 2;
// Largest input window of one tile (up = 1, down = 2, 4 taps), plus one.
constexpr int kInTile = (kTileH - 1) * kMaxDown + kMaxTaps + 1;

struct Taps {
  float k[kMaxTaps * kMaxTaps];  // row-major, already flipped and scaled
};

// floor(a / UP) and a mod UP for UP in {1, 2}; >> is an arithmetic shift.
template <int UP>
__device__ __forceinline__ int div_up(int a) { return UP == 1 ? a : a >> 1; }
template <int UP>
__device__ __forceinline__ bool on_sample(int a) { return UP == 1 || (a & 1) == 0; }

template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kTileW * kRowsY)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ out, Taps taps,
                 long long planes, int in_h, int in_w, int out_h, int out_w,
                 int pad0, int kh, int kw) {
  __shared__ float tile[kInTile][kInTile + 1];

  const int oy0 = blockIdx.y * kTileH;
  const int ox0 = blockIdx.x * kTileW;
  // Input rows and columns the tile reads: from tap 0 of its first output to
  // the last tap of its last output, in input coordinates.
  const int iy0 = div_up<UP>(oy0 * DOWN - pad0);
  const int ix0 = div_up<UP>(ox0 * DOWN - pad0);
  const int rows = div_up<UP>((oy0 + kTileH - 1) * DOWN + kh - 1 - pad0) - iy0 + 1;
  const int cols = div_up<UP>((ox0 + kTileW - 1) * DOWN + kw - 1 - pad0) - ix0 + 1;

  const long long in_plane = static_cast<long long>(in_h) * in_w;
  const long long out_plane = static_cast<long long>(out_h) * out_w;
  const int ox = ox0 + threadIdx.x;

  for (long long plane = blockIdx.z; plane < planes; plane += gridDim.z) {
    const T* src = x + plane * in_plane;
    __syncthreads();  // the previous plane's window is no longer read
    for (int r = threadIdx.y; r < rows; r += kRowsY) {
      const int iy = iy0 + r;
      const bool row_in = iy >= 0 && iy < in_h;
      for (int c = threadIdx.x; c < cols; c += kTileW) {
        const int ix = ix0 + c;
        tile[r][c] = (row_in && ix >= 0 && ix < in_w)
                         ? e4s::load_f32(src + static_cast<long long>(iy) * in_w + ix)
                         : 0.f;
      }
    }
    __syncthreads();

    if (ox < out_w) {
      for (int ry = threadIdx.y; ry < kTileH; ry += kRowsY) {
        const int oy = oy0 + ry;
        if (oy >= out_h) break;
        float acc = 0.f;
#pragma unroll
        for (int ty = 0; ty < kMaxTaps; ++ty) {
          if (ty >= kh) break;
          const int ay = oy * DOWN + ty - pad0;
          if (!on_sample<UP>(ay)) continue;
          const int r = div_up<UP>(ay) - iy0;
#pragma unroll
          for (int tx = 0; tx < kMaxTaps; ++tx) {
            if (tx >= kw) break;
            const int ax = ox * DOWN + tx - pad0;
            if (!on_sample<UP>(ax)) continue;
            acc += taps.k[ty * kMaxTaps + tx] * tile[r][div_up<UP>(ax) - ix0];
          }
        }
        e4s::store_f32(out + plane * out_plane + static_cast<long long>(oy) * out_w + ox, acc);
      }
    }
  }
}

template <typename T, int UP, int DOWN>
void launch(const void* x, void* out, const Taps& taps, long long planes,
            int in_h, int in_w, int out_h, int out_w, int pad0, int kh, int kw,
            cudaStream_t stream) {
  const dim3 block(kTileW, kRowsY);
  const dim3 grid((out_w + kTileW - 1) / kTileW, (out_h + kTileH - 1) / kTileH,
                  static_cast<unsigned>(planes < e4s::kMaxGridYZ ? planes : e4s::kMaxGridYZ));
  upfirdn2d_kernel<T, UP, DOWN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), taps, planes, in_h, in_w,
      out_h, out_w, pad0, kh, kw);
}

template <typename T>
void launch_factors(const void* x, void* out, const Taps& taps, long long planes,
                    int in_h, int in_w, int out_h, int out_w, int up, int down,
                    int pad0, int kh, int kw, cudaStream_t s) {
  if (up == 1 && down == 1)
    launch<T, 1, 1>(x, out, taps, planes, in_h, in_w, out_h, out_w, pad0, kh, kw, s);
  else if (up == 2 && down == 1)
    launch<T, 2, 1>(x, out, taps, planes, in_h, in_w, out_h, out_w, pad0, kh, kw, s);
  else if (up == 1 && down == 2)
    launch<T, 1, 2>(x, out, taps, planes, in_h, in_w, out_h, out_w, pad0, kh, kw, s);
  else
    launch<T, 2, 2>(x, out, taps, planes, in_h, in_w, out_h, out_w, pad0, kh, kw, s);
}

}  // namespace

// taps: kh * kw float32 values on the host, row-major, flipped and scaled by
// the caller. Requires up and down in {1, 2} and 1 <= kh, kw <= 4.
extern "C" int e4s_upfirdn2d(const void* x, void* out, int dtype,
                             long long planes, int in_h, int in_w, int out_h,
                             int out_w, int up, int down, int pad0,
                             const float* taps, int kh, int kw, int device,
                             void* stream) {
  if (up < 1 || up > 2 || down < 1 || down > kMaxDown || kh < 1 || kh > kMaxTaps ||
      kw < 1 || kw > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes <= 0 || out_h <= 0 || out_w <= 0) return 0;
  Taps t = {};
  for (int ty = 0; ty < kh; ++ty)
    for (int tx = 0; tx < kw; ++tx) t.k[ty * kMaxTaps + tx] = taps[ty * kw + tx];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case e4s::kFloat32:
      launch_factors<float>(x, out, t, planes, in_h, in_w, out_h, out_w, up, down, pad0,
                            kh, kw, s);
      break;
    case e4s::kBFloat16:
      launch_factors<__nv_bfloat16>(x, out, t, planes, in_h, in_w, out_h, out_w, up,
                                    down, pad0, kh, kw, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return e4s::launch_status();
}
