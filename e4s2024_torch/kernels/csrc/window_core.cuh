// The attention core shared by the window-attention kernels K4 and K6
// (window_attention.cu) and the fused Swin block K5 (swin_block.cu).
//
// One thread block owns one window of n <= 64 tokens and walks its heads.
// For one head it holds q, k and v (n x hd, hd <= 64) and the n x n scores
// in shared memory, all as float32 values that have already been rounded to
// the compute type T where the reference rounds them:
//
//   s   = (round_T(q * scale) . k^T) + bias[h]     (float32 accumulation)
//   s  -= 100 where the window-region labels of the two tokens differ
//   p   = round_T(softmax(s))                      (float32 softmax)
//   out = p . v                                    (float32 accumulation)
//
// (e4s2024_tpu/ops/window_attention.py `_kernel` and `_nhwc_kernel`; the
// caller rounds `out` when it stores it.)
#pragma once

#include <math.h>

#include "common.cuh"

namespace e4s {
namespace win {

constexpr int kThreads = 256;   // threads per block in K4 and K6 (K5 runs 512)
constexpr int kMaxTokens = 64;  // an 8 x 8 window
constexpr int kMaxHeadDim = 64;

// v rounded to the precision of T, kept as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide product of a shared-memory A (M x K, row stride lda; M a
// multiple of RM) with B, where B's element (k, c) lies at
// B[k * ldb + col(c)]. Each thread owns RM x CN outputs at a time and hands
// each finished sum to epi(row, column, sum). B may be in shared or global
// memory, in float32 or bfloat16.
template <int RM, int CN, typename BT, typename Col, typename Epi>
__device__ __forceinline__ void block_gemm(const float* A, int lda, int M, const BT* B,
                                           long long ldb, Col col, int K, int N, Epi epi) {
  const int cgroups = (N + CN - 1) / CN;
  const int items = (M / RM) * cgroups;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int r0 = (item / cgroups) * RM;
    const int c0 = (item % cgroups) * CN;
    long long bcol[CN];
#pragma unroll
    for (int j = 0; j < CN; ++j) bcol[j] = col(min(c0 + j, N - 1));
    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
    const float* a = A + r0 * lda;
    const BT* b = B;
    for (int k = 0; k < K; ++k, b += ldb) {
      float av[RM], bv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = a[i * lda + k];
#pragma unroll
      for (int j = 0; j < CN; ++j) bv[j] = load_f32(b + bcol[j]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        if (c0 + j < N) epi(r0 + i, c0 + j, acc[i][j]);
  }
}

// Shared-memory floats one head of attention needs: q, k and v (n rows of
// hd + 1, the odd stride spreads rows over the banks) and the n x (n + 1)
// scores.
__host__ __device__ inline int head_floats(int n, int hd) {
  return 3 * n * (hd + 1) + n * (n + 1);
}

// One head of window attention over q, k, v already in shared memory (q
// scaled and rounded; rows of stride hd + 1). `bias` is this head's n x n
// float32 relative-position bias in global memory; `lab` the window's
// labels in shared memory or nullptr for an unshifted window. Calls
// out(token, d, sum) for every output element. RM rows per thread tile: 4
// for a block of 256 threads, 2 for 512 (n a multiple of RM). Starts and
// ends with the block in step, so the caller may overwrite q, k, v and s
// after it returns once it has synchronised.
template <typename T, int RM = 4, typename Out>
__device__ __forceinline__ void attend_head(const float* q, const float* k, const float* v,
                                            float* s, int n, int hd, const float* bias,
                                            const int* lab, Out out) {
  const int ldq = hd + 1;
  const int lds = n + 1;
  block_gemm<RM, 4>(q, ldq, n, k, 1, [=](int c) { return static_cast<long long>(c) * ldq; },
                   hd, n, [=](int r, int c, float acc) {
                     float a = acc + bias[r * n + c];
                     if (lab != nullptr && lab[r] != lab[c]) a -= 100.f;
                     s[r * lds + c] = a;
                   });
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int r = warp; r < n; r += warps) {
    float* row = s + r * lds;
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < n; c += 32) row[c] = round_to<T>(row[c] / sum);
  }
  __syncthreads();
  block_gemm<RM, 2>(s, lds, n, v, ldq, [](int c) { return static_cast<long long>(c); }, n, hd,
                   out);
}

}  // namespace win
}  // namespace e4s
