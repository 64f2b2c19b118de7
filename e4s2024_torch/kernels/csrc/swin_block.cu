// K5: one whole Swin transformer block,
//   y   = x + proj(attention(LN1(x)))           (shifted-window attention)
//   out = y + fc2(gelu(fc1(LN2(y))))
//
// Replaces e4s2024_tpu/ops/swin_block.py::fused_swin_block (pallas_call at
// :163). x and out are (B, H, W, C) contiguous in the compute type T; the
// caller rolls x by -shift before and +shift after a shifted block and
// passes the shifted image's window-region labels (H / w, W / w, n) int32.
// Weights, as the JAX kernel takes them: LN scales and biases and the
// relative-position bias (heads, n, n) in float32; qkv_w (C, 3C) with
// columns [q|k|v] x head x head_dim, proj_w (C, C), fc1_w (C, Cm),
// fc2_w (Cm, C) and every projection bias in T. Rounding follows the JAX
// kernel: LN statistics in float32 in one pass (E[x^2] - mu^2, eps given),
// every product accumulated in float32 and rounded to T before its bias is
// added, softmax in float32, erf GELU in float32.
//
// Bound on the card: operations. Per token the block does
// 2 * (3C^2 + C^2 + 2 * C * Cm) + 4 * n * C = 564,480 operations at C = 180,
// Cm = 360, n = 64, against (C + C) * 4 = 1,440 bytes of activations in
// float32: 392 operations a byte, far above the float32 ridge (20) and above
// the bf16 tensor-core ridge (295). At 1024^2 that is 5.9e11 operations per
// call.
//
// Design: one block of 512 threads per 8 x 8 window, the window's whole
// token tile in shared memory: x, then y, row-major; the LN output and the
// attention output, then one MLP chunk, stored transposed, C x (n + 4); one
// head's q, k, v and scores; the fc2 sum; two staging buffers for weights.
// That is 209,536 bytes at C = 180, which needs the dynamic shared-memory
// opt-in and leaves one block per SM. LN1, each head's qkv slice, the
// attention, proj with the residual, LN2 and the MLP in chunks of
// 3 * head_dim hidden units follow one another without leaving shared
// memory: x is read once and the output written once.
//
// The four projections (92% of the operations) run in this body as float32
// FMAs, one 4 x 12 or 4 x 6 register tile per thread (gemm_at). The
// transposed A operand gives a thread its 4 rows in one 16-byte
// shared-memory load per k. The weights pass through shared memory 16 rows
// at a time, double-buffered: the block reads each weight once from L2 and
// the next rows' loads are in flight during the current rows' FMAs. The
// attention products use window_core.cuh's 2 x 4 and 2 x 2 tiles.
//
// The first version (256 threads, 4 x 4 and 4 x 2 tiles over row-major A,
// every thread reading its weights from global memory one element a load)
// ran at 83 ms a call at 1024^2 in float32 on an H100 80GB HBM3 at 700 W;
// this one at about half that.
// Both stay well above the bound: with one block per SM the phases run one
// after another, and each product feeds few FMAs per shared-memory load.
// Tensor cores (mma / wgmma on bf16 tiles) and more than one block per SM
// are later work.
#include "window_core.cuh"

namespace {

// K5 runs 512 threads a block (K4 and K6 run window_core.cuh's 256).
constexpr int kThreads = 512;
using e4s::win::round_to;

struct BlockWeights {
  const float* ln1_s;
  const float* ln1_b;
  const void* qkv_w;
  const void* qkv_b;
  const void* proj_w;
  const void* proj_b;
  const float* bias;
  const float* ln2_s;
  const float* ln2_b;
  const void* fc1_w;
  const void* fc1_b;
  const void* fc2_w;
  const void* fc2_b;
};

// Rows of B staged in shared memory per step of gemm_at, and the widest B
// it stages (16 column groups of 12).
constexpr int kStageRows = 16;
constexpr int kMaxCols = 192;
constexpr int kStagePerThread = kStageRows * kMaxCols / kThreads;

// Block-wide product of a transposed shared-memory A (K rows of M floats,
// row stride lda, 16-byte aligned; M a multiple of 4) with B in global
// memory, whose element (k, c) lies at B[k * ldb + col(c)]. Each thread owns
// one 4 x CN output tile, so (M / 4) * ceil(N / CN) must not exceed the
// block's threads (the host checks the widths), and hands each finished sum
// to epi(row, column, sum). B goes through shared memory kStageRows rows at a
// time, double-buffered in `stage` (2 * kStageRows * kMaxCols floats): the
// block reads each weight once from L2, and the next rows' loads are in
// flight while the current rows are multiplied.
template <int CN, typename T, typename Col, typename Epi>
__device__ __forceinline__ void gemm_at(const float* at, int lda, int m, const T* b,
                                        long long ldb, Col col, int k_dim, int n_dim,
                                        float* stage, Epi epi) {
  static_assert(CN % 2 == 0, "CN must be even");
  const int cgroups = (n_dim + CN - 1) / CN;
  const bool active = static_cast<int>(threadIdx.x) < (m / 4) * cgroups;
  const int r0 = active ? (threadIdx.x / cgroups) * 4 : 0;
  const int c0 = active ? (threadIdx.x % cgroups) * CN : 0;
  const int lds = (cgroups * CN + 3) & ~3;  // staged row stride, 16-byte multiple
  // which staged element (row kk, column c) each thread moves, and from
  // where: the same in every step, so the index arithmetic runs once; a
  // thread with no element gets a row that is never fetched
  float reg[kStagePerThread];
  int row[kStagePerThread], dst[kStagePerThread];
  long long src[kStagePerThread];
#pragma unroll
  for (int i = 0; i < kStagePerThread; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int kk = idx / n_dim, c = idx - kk * n_dim;
    const bool in = idx < kStageRows * n_dim;
    row[i] = in ? kk : k_dim;
    dst[i] = in ? kk * lds + c : -1;
    src[i] = in ? kk * ldb + col(c) : 0;
  }
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kStagePerThread; ++i)
      reg[i] = k0 + row[i] < k_dim ? e4s::load_f32(b + k0 * ldb + src[i]) : 0.f;
  };
  auto put = [&](float* buf) {
#pragma unroll
    for (int i = 0; i < kStagePerThread; ++i)
      if (dst[i] >= 0) buf[dst[i]] = reg[i];
  };
  float acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
  const int steps = (k_dim + kStageRows - 1) / kStageRows;
  fetch(0);
  put(stage);
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const float* cur = stage + (st & 1) * kStageRows * lds + c0;
    if (st + 1 < steps) fetch((st + 1) * kStageRows);
    if (active) {
      const int kn = min(kStageRows, k_dim - st * kStageRows);
      const float* a = at + st * kStageRows * lda + r0;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(a + kk * lda);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        float bv[CN];
        if constexpr (CN % 4 == 0) {
#pragma unroll
          for (int j = 0; j < CN; j += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(cur + kk * lds + j);
            bv[j] = v4.x, bv[j + 1] = v4.y, bv[j + 2] = v4.z, bv[j + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < CN; j += 2) {
            const float2 v2 = *reinterpret_cast<const float2*>(cur + kk * lds + j);
            bv[j] = v2.x, bv[j + 1] = v2.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(ar[i], bv[j], acc[i][j]);
      }
    }
    if (st + 1 < steps) put(stage + ((st + 1) & 1) * kStageRows * lds);
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        if (c0 + j < n_dim) epi(r0 + i, c0 + j, acc[i][j]);
  }
}

// LayerNorm of n rows of C floats (row stride ld) from src into the
// transposed dst (dst[c * ldt + row]), one warp per row; single-pass float32
// statistics as the JAX kernel takes them.
template <typename T>
__device__ __forceinline__ void layer_norm_t(const float* src, int ld, float* dst, int ldt, int n,
                                             int c, const float* scale, const float* shift,
                                             float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += blockDim.x >> 5) {
    const float* row = src + r * ld;
    float s = 0.f, s2 = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float v = row[i];
      s += v;
      s2 += v * v;
    }
    s = e4s::win::warp_sum(s);
    s2 = e4s::win::warp_sum(s2);
    const float mu = s / c;
    const float inv = rsqrtf(s2 / c - mu * mu + eps);
    for (int i = lane; i < c; i += 32)
      dst[i * ldt + r] = round_to<T>((row[i] - mu) * inv * scale[i] + shift[i]);
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Hidden units of fc1 per MLP chunk: one head's qkv width.
__host__ __device__ inline int mlp_chunk(int c, int heads, int hidden) {
  return 3 * (c / heads) < hidden ? 3 * (c / heads) : hidden;
}

// Whether gemm_at can take the block's products: one 4 x 12 tile per thread
// over the C-wide ones (qkv is not one of them), one 4 x 6 tile per thread
// over the qkv slice of a head and an MLP chunk, and at most kMaxCols staged
// columns. With 8 x 8 windows: C <= 192.
__host__ __device__ inline bool widths_ok(int c, int heads, int n) {
  const int wide = (c + 11) / 12, narrow = (3 * (c / heads) + 5) / 6;
  return (n / 4) * wide <= kThreads && wide * 12 <= kMaxCols &&
         (n / 4) * narrow <= kThreads && narrow * 6 <= kMaxCols;
}

// Shared-memory floats of one block: x/y (n x (C + 1)), the transposed LN
// output (C x (n + 4)), the transposed attention output or the fc2 sum, one
// head's attention buffers or one transposed MLP chunk, and gemm_at's two
// staging buffers.
__host__ __device__ inline long long work_floats(int c, int heads, int hidden, int n) {
  const long long head = e4s::win::head_floats(n, c / heads);
  const long long mlp = static_cast<long long>(mlp_chunk(c, heads, hidden)) * (n + 4);
  return head > mlp ? head : mlp;
}

__host__ __device__ inline long long smem_floats(int c, int heads, int hidden, int n) {
  const long long tile = static_cast<long long>(n) * (c + 1);
  const long long tile_t = static_cast<long long>(c) * (n + 4);
  return tile + tile_t + (tile_t > tile ? tile_t : tile) + work_floats(c, heads, hidden, n) +
         2LL * kStageRows * kMaxCols;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
swin_block_kernel(const T* __restrict__ x, T* __restrict__ out, BlockWeights wt,
                  const int* __restrict__ labels, int height, int width, int c, int heads,
                  int cm, int window, int chunk, float scale, float eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int lab[e4s::win::kMaxTokens];
  const int n = window * window;
  const int hd = c / heads;
  const int ld = c + 1;
  const int ldt = n + 4;
  const int ldq = hd + 1;
  float* xs = smem;            // x, then y after the attention residual (row-major)
  float* lnt = xs + n * ld;    // LN1, then LN2 (transposed)
  float* big = lnt + c * ldt;  // attention output (transposed), then the fc2 sum
  float* q = big + (c * ldt > n * ld ? c * ldt : n * ld);  // one head; later an MLP chunk
  float* stage = q + work_floats(c, heads, cm, n);        // gemm_at's staged weights
  float* k = q + n * ldq;
  float* v = k + n * ldq;
  float* s = v + n * ldq;
  float* hid = q;              // one MLP chunk (transposed)

  const T* qkv_w = static_cast<const T*>(wt.qkv_w);
  const T* qkv_b = static_cast<const T*>(wt.qkv_b);
  const T* proj_w = static_cast<const T*>(wt.proj_w);
  const T* proj_b = static_cast<const T*>(wt.proj_b);
  const T* fc1_w = static_cast<const T*>(wt.fc1_w);
  const T* fc1_b = static_cast<const T*>(wt.fc1_b);
  const T* fc2_w = static_cast<const T*>(wt.fc2_w);
  const T* fc2_b = static_cast<const T*>(wt.fc2_b);

  auto pixel = [&](int t) {
    const int ty = t / window, tx = t - ty * window;
    const long long yy = static_cast<long long>(blockIdx.y) * window + ty;
    const long long xx = static_cast<long long>(blockIdx.x) * window + tx;
    return (static_cast<long long>(blockIdx.z) * height + yy) * width + xx;
  };
  auto same = [](int j) { return static_cast<long long>(j); };

  for (int i = threadIdx.x; i < n * c; i += blockDim.x) {
    const int t = i / c, ch = i - t * c;
    xs[t * ld + ch] = e4s::load_f32(x + pixel(t) * c + ch);
  }
  const bool masked = labels != nullptr;
  if (masked) {
    const int* src = labels + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * n;
    for (int t = threadIdx.x; t < n; t += blockDim.x) lab[t] = src[t];
  }
  __syncthreads();
  layer_norm_t<T>(xs, ld, lnt, ldt, n, c, wt.ln1_s, wt.ln1_b, eps);
  __syncthreads();

  for (int h = 0; h < heads; ++h) {
    // this head's q, k and v: columns part * C + h * hd + d of qkv_w
    auto col = [=](int j) {
      const int part = j / hd;
      return static_cast<long long>(part) * c + h * hd + (j - part * hd);
    };
    gemm_at<6>(lnt, ldt, n, qkv_w, 3LL * c, col, c, 3 * hd, stage, [&](int r, int j, float a) {
      const int part = j / hd, d = j - part * hd;
      const float val = round_to<T>(round_to<T>(a) + e4s::load_f32(qkv_b + col(j)));
      if (part == 0)
        q[r * ldq + d] = round_to<T>(val * scale);
      else if (part == 1)
        k[r * ldq + d] = val;
      else
        v[r * ldq + d] = val;
    });
    __syncthreads();
    e4s::win::attend_head<T, 2>(q, k, v, s, n, hd, wt.bias + static_cast<long long>(h) * n * n,
                             masked ? lab : nullptr, [&](int t, int d, float a) {
                               big[(h * hd + d) * ldt + t] = round_to<T>(a);
                             });
    __syncthreads();
  }

  // y = x + round(attn . proj_w) + proj_b, rounded after each add; in place
  gemm_at<12>(big, ldt, n, proj_w, c, same, c, c, stage, [&](int r, int j, float a) {
    const float y = round_to<T>(xs[r * ld + j] + round_to<T>(a));
    xs[r * ld + j] = round_to<T>(y + e4s::load_f32(proj_b + j));
  });
  __syncthreads();
  layer_norm_t<T>(xs, ld, lnt, ldt, n, c, wt.ln2_s, wt.ln2_b, eps);
  __syncthreads();

  for (int c0 = 0; c0 < cm; c0 += chunk) {
    const int w = min(chunk, cm - c0);
    gemm_at<6>(lnt, ldt, n, fc1_w, cm, [=](int j) { return static_cast<long long>(c0 + j); }, c,
               w, stage, [&](int r, int j, float a) {
                 hid[j * ldt + r] = round_to<T>(gelu_erf(a + e4s::load_f32(fc1_b + c0 + j)));
               });
    __syncthreads();
    gemm_at<12>(hid, ldt, n, fc2_w + static_cast<long long>(c0) * c, c, same, w, c, stage,
                [&](int r, int j, float a) {
                  big[r * ld + j] = (c0 == 0 ? 0.f : big[r * ld + j]) + a;
                });
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n * c; i += blockDim.x) {
    const int t = i / c, ch = i - t * c;
    const float o = round_to<T>(xs[t * ld + ch] + round_to<T>(big[t * ld + ch]));
    e4s::store_f32(out + pixel(t) * c + ch, o + e4s::load_f32(fc2_b + ch));
  }
}

template <typename T>
int launch(const void* x, void* out, const BlockWeights& wt, const int* labels, int batch,
           int height, int width, int c, int heads, int cm, int window, int chunk, int smem,
           float scale, float eps, cudaStream_t stream) {
  auto* kernel = swin_block_kernel<T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(width / window, height / window, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), wt,
                                           labels, height, width, c, heads, cm, window, chunk,
                                           scale, eps);
  return e4s::launch_status();
}

}  // namespace

// K5. x and out (batch, height, width, channels) contiguous in `dtype`;
// weights as BlockWeights describes, hidden = fc1 width; labels
// (height / window, width / window, window^2) int32 or null. `scale` is
// head_dim^-1/2 already rounded to `dtype`. Requires height and width
// multiples of window, window^2 a multiple of 4 up to 64, widths_ok(...)
// (e4s2024_torch/ops/swin_block.py::widths_ok computes the same) and the
// shared memory of smem_floats(...) within the card's limit per block.
extern "C" int e4s_swin_block(const void* x, const void* ln1_s, const void* ln1_b,
                              const void* qkv_w, const void* qkv_b, const void* proj_w,
                              const void* proj_b, const void* bias, const void* labels,
                              const void* ln2_s, const void* ln2_b, const void* fc1_w,
                              const void* fc1_b, const void* fc2_w, const void* fc2_b, void* out,
                              int dtype, int batch, int height, int width, int channels,
                              int heads, int hidden, int window, float scale, float eps,
                              int device, void* stream) {
  const int n = window * window;
  if (heads <= 0 || window <= 0 || hidden <= 0 || channels % heads != 0 ||
      height % window != 0 || width % window != 0 || n < 4 || n > e4s::win::kMaxTokens ||
      n % 4 != 0 || channels / heads > e4s::win::kMaxHeadDim ||
      !widths_ok(channels, heads, n) || batch > e4s::kMaxGridYZ ||
      height / window > e4s::kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  const long long smem =
      static_cast<long long>(sizeof(float)) * smem_floats(channels, heads, hidden, n);
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the labels' static array shares the block's shared memory
  if (smem + static_cast<long long>(sizeof(int)) * e4s::win::kMaxTokens > limit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = mlp_chunk(channels, heads, hidden);
  const BlockWeights wt{static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b),
                        qkv_w, qkv_b, proj_w, proj_b, static_cast<const float*>(bias),
                        static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b),
                        fc1_w, fc1_b, fc2_w, fc2_b};
  const int* lab = static_cast<const int*>(labels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case e4s::kFloat32:
      return launch<float>(x, out, wt, lab, batch, height, width, channels, heads, hidden, window,
                           chunk, static_cast<int>(smem), scale, eps, s);
    case e4s::kBFloat16:
      return launch<__nv_bfloat16>(x, out, wt, lab, batch, height, width, channels, heads,
                                   hidden, window, chunk, static_cast<int>(smem), scale, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
