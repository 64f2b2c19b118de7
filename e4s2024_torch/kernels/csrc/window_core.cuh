// Tensor-core primitives and the attention core shared by the
// window-attention kernels K4 and K6 (window_attention.cu) and the fused Swin
// block K5 (swin_block.cu).
//
// The products here are warp-level `mma.sync` on operands held in shared
// memory in their own type T (K5's four projections use wgmma on the same
// fragments, swin_block.cu):
//
//   bfloat16  m16n8k16, bf16 operands, float32 accumulators;
//   float32   m16n8k8 tf32, error-compensated ("3xTF32"): each float32
//             operand a is split in registers into hi = a with its
//             mantissa cut to tf32's 10 bits and lo = a - hi, and the
//             product is lo.hi + hi.lo + hi.hi with float32 accumulators.
//             The dropped lo.lo term and the 10 bits the tensor core keeps
//             of lo leave a relative error of at most 2^-19 per term and
//             about 2^-21 on average (under 2e-6 of sum |a||b| at K = 360),
//             where plain TF32 would leave 2^-10.
//
// Layouts. An A operand is a row-major tile (row stride ld elements); a B
// operand is stored [n][k], k contiguous (the transpose of the matrix the
// product reads). A head's tile has a row stride of (width + kPad) elements
// with kPad = 8, so that the eight rows a fragment load touches fall into
// different banks in both types. The float32 fragments read (k, k + 1) pairs with one 8-byte
// load, which permutes k inside a k8 step the same way for A and B; the
// probabilities, which stay in registers, use the same permutation.
//
// The attention core works on one head of one window of up to 64 tokens,
// padded to 64 tokens and to head_dim 32, with values already rounded to T
// where the reference rounds them:
//
//   s   = (round_T(q * scale) . k^T) + bias[h]     (float32 accumulation)
//   s  -= 100 where the window-region labels of the two tokens differ
//   p   = round_T(softmax(s))                      (float32 softmax)
//   out = p . v                                    (float32 accumulation)
//
// (e4s2024_tpu/ops/window_attention.py `_kernel` and `_nhwc_kernel`; the
// caller rounds `out` when it stores it.) A warp owns 16 query rows: it
// builds their 16 x 64 scores on the accumulator fragments, adds bias and
// mask there, takes the row softmax in registers with quad shuffles, and
// feeds the rounded probabilities straight back as the A operand of p . v.
// No n x n matrix touches shared memory.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace e4s {
namespace win {

constexpr int kWarps = 8;  // four warps a head (16 of a window's 64 rows each), two heads
constexpr int kThreads = 32 * kWarps;  // threads per block in K4, K5 and K6
constexpr int kMaxTokens = 64;         // an 8 x 8 window; smaller ones are padded
constexpr int kMaxHeadDim = 32;        // head_dim is padded to this
constexpr int kPad = 8;                // elements added to every shared-memory row
// One head in shared memory: q, k and v side by side, [64][3 * 32 + kPad].
constexpr int kLdHead = 3 * kMaxHeadDim + kPad;
constexpr int kHeadElems = kMaxTokens * kLdHead;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a and b rounded to the precision of T. Conversions run at a quarter of the
// ALU rate, and one packed conversion rounds both.
template <typename T>
__device__ __forceinline__ void round_pair(float& a, float& b) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(&v);
    a = __uint_as_float(w << 16);
    b = __uint_as_float(w & 0xffff0000u);
  }
}

// Two neighbouring elements of a tile, rounded to its type (to nearest even)
// and stored with one instruction.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The warp-level product of type T. `g` = lane / 4 and `t4` = lane % 4 place
// a thread in the fragments; `load_a(p, ld)` reads the 16 x kStep fragment
// whose corner element is *p from a row-major tile, `load_b_pair(p, ld)` the
// two kStep x 8 fragments whose corners (n0, k0) and (n0 + 8, k0) start at
// *p in [n][k] storage, `load_bt(p, ld)` one such fragment from [k][n]
// storage (corner (k0, n0)), and `mma(c, a, b)` adds a . b to the 16 x 8
// accumulator fragment c (c[0], c[1]: row g, columns 2 * t4 and 2 * t4 + 1;
// c[2], c[3]: row g + 8).
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kStep = 16;
  struct AFrag {
    uint32_t r[4];
  };
  struct BFrag {
    uint32_t r[2];
  };

  // ldmatrix: four 8 x 8 blocks with one instruction, lane l giving the
  // address of row l % 8 of block l / 8
  static __device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const T* row) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  }
  // blocks: rows 0..7 and 8..15 at k 0..7, then the same rows at k 8..15
  static __device__ __forceinline__ AFrag load_a(const T* p, int ld, int, int) {
    const int lane = threadIdx.x & 31;
    AFrag a;
    ldmatrix4(a.r, p + (lane & 15) * ld + (lane >> 4) * 8);
    return a;
  }
  static __device__ __forceinline__ AFrag load_a_in_order(const T* p, int ld, int g, int t4) {
    return load_a(p, ld, g, t4);
  }
  // blocks: tile 0 at k 0..7 and 8..15, then tile 1
  static __device__ __forceinline__ void load_b_pair(BFrag& b0, BFrag& b1, const T* p, int ld,
                                                     int, int) {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldmatrix4(r, p + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
    b0 = {{r[0], r[1]}};
    b1 = {{r[2], r[3]}};
  }
  // ldmatrix transposes two 8 x 8 blocks (k 0..7 and 8..15) on the way
  static __device__ __forceinline__ BFrag load_bt(const T* p, int ld, int, int) {
    const uint32_t row =
        static_cast<uint32_t>(__cvta_generic_to_shared(p + (threadIdx.x & 15) * ld));
    BFrag b;
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b.r[0]), "=r"(b.r[1])
                 : "r"(row));
    return b;
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  // The A fragment of k step `ks` (16 columns) from a row of 16 x 8
  // accumulator fragments, rounded to bf16 (to nearest even) on the way.
  static __device__ __forceinline__ AFrag from_acc(const float (*c)[4], int ks) {
    const float* c0 = c[2 * ks];
    const float* c1 = c[2 * ks + 1];
    return {{pack(c0[0], c0[1]), pack(c0[2], c0[3]), pack(c1[0], c1[1]), pack(c1[2], c1[3])}};
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const AFrag& a, const BFrag& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
};

template <>
struct Mma<float> {
  using T = float;
  static constexpr int kStep = 8;
  struct AFrag {
    uint32_t hi[4], lo[4];
  };
  struct BFrag {
    uint32_t hi[2], lo[2];
  };

  // v = hi + lo with hi the leading 19 bits of v (a tf32: the mantissa cut
  // to 10 bits); the tensor core reads the leading 19 bits of lo. A mask
  // and a subtraction run at the full ALU rate, cvt.rna.tf32 at a quarter
  // of it.
  static __device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(v) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  }
  // Slot t4 of a k8 step holds column 2 * t4 and slot t4 + 4 column
  // 2 * t4 + 1, in A and in B alike.
  static __device__ __forceinline__ AFrag load_a(const T* p, int ld, int g, int t4) {
    const float2 lo = *reinterpret_cast<const float2*>(p + g * ld + 2 * t4);
    const float2 hi = *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t4);
    AFrag a;
    split(lo.x, a.hi[0], a.lo[0]);
    split(hi.x, a.hi[1], a.lo[1]);
    split(lo.y, a.hi[2], a.lo[2]);
    split(hi.y, a.hi[3], a.lo[3]);
    return a;
  }
  // The same fragment with slot t4 holding column t4 and slot t4 + 4 column
  // t4 + 4, for a B operand that the tensor core reads itself (wgmma).
  static __device__ __forceinline__ AFrag load_a_in_order(const T* p, int ld, int g, int t4) {
    AFrag a;
    split(p[g * ld + t4], a.hi[0], a.lo[0]);
    split(p[(g + 8) * ld + t4], a.hi[1], a.lo[1]);
    split(p[g * ld + t4 + 4], a.hi[2], a.lo[2]);
    split(p[(g + 8) * ld + t4 + 4], a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ void load_b_pair(BFrag& b0, BFrag& b1, const T* p, int ld,
                                                     int g, int t4) {
    const float2 v0 = *reinterpret_cast<const float2*>(p + g * ld + 2 * t4);
    const float2 v1 = *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t4);
    split(v0.x, b0.hi[0], b0.lo[0]);
    split(v0.y, b0.hi[1], b0.lo[1]);
    split(v1.x, b1.hi[0], b1.lo[0]);
    split(v1.y, b1.hi[1], b1.lo[1]);
  }
  static __device__ __forceinline__ BFrag load_bt(const T* p, int ld, int g, int t4) {
    BFrag b;
    split(p[2 * t4 * ld + g], b.hi[0], b.lo[0]);
    split(p[(2 * t4 + 1) * ld + g], b.hi[1], b.lo[1]);
    return b;
  }
  // The A fragment of k step `ks` (8 columns) from a row of 16 x 8
  // accumulator fragments, in the same column permutation as load_a.
  static __device__ __forceinline__ AFrag from_acc(const float (*c)[4], int ks) {
    AFrag a;
    split(c[ks][0], a.hi[0], a.lo[0]);
    split(c[ks][2], a.hi[1], a.lo[1]);
    split(c[ks][1], a.hi[2], a.lo[2]);
    split(c[ks][3], a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ void tf32(float (&c)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // The small terms first, so that they are not lost against the large one.
  static __device__ __forceinline__ void mma(float (&c)[4], const AFrag& a, const BFrag& b) {
    tf32(c, a.lo, b.hi);
    tf32(c, a.hi, b.lo);
    tf32(c, a.hi, b.hi);
  }
};

// What the softmax needs that is the same for every head of a window: for
// the calling thread's two rows (row0 + g, row0 + g + 8) and 16 columns
// (8 * j + 2 * t4 + e), bit 16 * half + 2 * j + e of `differ` says that the
// row's and the column's window-region labels differ. `lab` is the window's
// labels in shared memory or nullptr for an unshifted window.
__device__ __forceinline__ uint32_t label_mask(const int* lab, int n, int row0) {
  uint32_t differ = 0;
  if (lab == nullptr) return differ;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int mine = lab[min(row0 + g + 8 * half, n - 1)];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = min(8 * (i >> 1) + 2 * t4 + (i & 1), n - 1);
      differ |= static_cast<uint32_t>(lab[col] != mine) << (16 * half + i);
    }
  }
  return differ;
}

// exp(v) and a / b of the row softmax. float32 keeps expf and the true
// quotient; for bfloat16, whose probabilities are rounded to 8 bits right
// after, the fast exponential and a product with the reciprocal do.
template <typename T>
__device__ __forceinline__ float soft_exp(float v) {
  if constexpr (sizeof(T) == 4) return expf(v);
  return __expf(v);
}

// One head of window attention for the 16 query rows row0 .. row0 + 15 of
// the calling warp. `qkv` is the head's [64][kLdHead] tile (q, scaled and
// rounded, in columns 0..31, k in columns 32..63 and v in columns 64..95;
// columns past head_dim zero, rows past n zero or finite). `bias` is
// this head's n x n float32 relative-position bias in global memory;
// `differ` the thread's label_mask. Key columns past n get probability
// exactly 0. Calls out(row, column, a, b) with the float32 sums of
// (row, column) and (row, column + 1) for every even column below 32; rows
// past n hold nothing of use. Synchronises nothing: the caller brings the
// block in step between filling the tiles and calling this.
template <typename T, typename Out>
__device__ __forceinline__ void attend_rows(const T* qkv, int n, const float* bias,
                                            uint32_t differ, int row0, Out out) {
  using M = Mma<T>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  constexpr int kColTiles = kMaxTokens / 8;
  constexpr int kOutTiles = kMaxHeadDim / 8;

  // the bias of the thread's 2 x 16 scores, in flight during the products;
  // every load unconditional (clamped), in pairs where n is even
  float b[2][kColTiles][2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float* row = bias + min(row0 + g + 8 * half, n - 1) * n;
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {
      const int col = 8 * j + 2 * t4;
      if (n % 2 == 0) {
        const float2 p = *reinterpret_cast<const float2*>(row + min(col, n - 2));
        b[half][j][0] = p.x, b[half][j][1] = p.y;
      } else {
        b[half][j][0] = row[min(col, n - 1)];
        b[half][j][1] = row[min(col + 1, n - 1)];
      }
    }
  }

  float s[kColTiles][4];
#pragma unroll
  for (int j = 0; j < kColTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kMaxHeadDim / M::kStep; ++ks) {
    const typename M::AFrag a = M::load_a(qkv + row0 * kLdHead + ks * M::kStep, kLdHead, g, t4);
#pragma unroll
    for (int j = 0; j < kColTiles; j += 2) {
      typename M::BFrag b0, b1;
      M::load_b_pair(b0, b1, qkv + (8 * j) * kLdHead + kMaxHeadDim + ks * M::kStep, kLdHead, g,
                     t4);
      M::mma(s[j], a, b0);
      M::mma(s[j + 1], a, b1);
    }
  }

  // bias, mask and the row softmax on the fragments: a thread holds 16
  // columns of row row0 + g (elements 0, 1) and of row row0 + g + 8
  // (elements 2, 3), and the four threads of a quad hold a whole row
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kColTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sc = s[j][e] + b[e >> 1][j][e & 1];
      if (differ >> (16 * (e >> 1) + 2 * j + (e & 1)) & 1) sc -= 100.f;
      if (8 * j + 2 * t4 + (e & 1) >= n) sc = -INFINITY;
      s[j][e] = sc;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < kColTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = soft_exp<T>(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    if constexpr (sizeof(T) != 4) sum[h] = 1.f / sum[h];
  }
  // the probabilities; in bfloat16 from_acc rounds them as it packs them
#pragma unroll
  for (int j = 0; j < kColTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (sizeof(T) == 4) {
        s[j][e] = s[j][e] / sum[e >> 1];
      } else {
        s[j][e] = s[j][e] * sum[e >> 1];
      }
    }

  float o[kOutTiles][4];
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kMaxTokens / M::kStep; ++ks) {
    const typename M::AFrag a = M::from_acc(s, ks);
#pragma unroll
    for (int j = 0; j < kOutTiles; ++j) {
      const typename M::BFrag bf = M::load_bt(
          qkv + ks * M::kStep * kLdHead + 2 * kMaxHeadDim + 8 * j, kLdHead, g, t4);
      M::mma(o[j], a, bf);
    }
  }
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j) {
    out(row0 + g, 8 * j + 2 * t4, o[j][0], o[j][1]);
    out(row0 + g + 8, 8 * j + 2 * t4, o[j][2], o[j][3]);
  }
}

// Two neighbouring elements of a row of head_dim `hd` stored at dst if they
// exist: with one instruction where hd is even.
template <typename T>
__device__ __forceinline__ void store_in_head(T* dst, int col, int hd, float a, float b) {
  if (hd % 2 == 0) {
    if (col < hd) store_pair(dst, a, b);
  } else {
    if (col < hd) store_f32(dst, a);
    if (col + 1 < hd) store_f32(dst + 1, b);
  }
}

}  // namespace win
}  // namespace e4s
