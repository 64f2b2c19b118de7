// K5: one whole Swin transformer block,
//   y   = x + proj(attention(LN1(x)))           (shifted-window attention)
//   out = y + fc2(gelu(fc1(LN2(y))))
//
// Replaces e4s2024_tpu/ops/swin_block.py::fused_swin_block (pallas_call at
// :163). x and out are (B, H, W, C) contiguous in the compute type T. Token
// (ty, tx) of window (wy, wx) is pixel ((wy * w + ty + shift) mod H,
// (wx * w + tx + shift) mod W), read and written there: the kernel does the
// roll by -shift before and by +shift after a shifted block itself. The
// labels (H / w, W / w, n) int32 are the shifted image's window regions.
// Rounding follows the JAX kernel: LN statistics in float32 in one pass
// (E[x^2] - mu^2, eps given), every product accumulated in float32 and
// rounded to T before its bias is added, softmax in float32, erf GELU in
// float32.
//
// Bound on the card: operations. Per token the block does
// 2 * (3C^2 + C^2 + 2 * C * Cm) + 4 * n * C = 564,480 operations at C = 180,
// Cm = 360, n = 64, against (C + C) * 4 = 1,440 bytes of activations in
// float32: 392 operations a byte, above the bf16 tensor-core ridge (295).
// At 1024^2 that is 5.9e11 operations a call: 0.60 ms at the bf16 tensor-core
// rate. The float32 path runs three tf32 products for every float32 one
// (3xTF32, window_core.cuh), so a third of the tf32 rate is the most it can
// reach: 3 * 5.9e11 / 495e12 = 3.6 ms.
//
// Earlier versions, on an NVIDIA H100 80GB HBM3 at 700 W, 1024^2, float32:
// about 83 ms (256 threads, float32 FMAs, weights read from global memory
// one element a load), then 42.85 ms (512 threads, weights staged through
// shared memory, 4 x 12 register tiles; bfloat16 44.33 ms on the same FMAs).
// What held that version back, and what this design does about it:
//
// 1. No tensor cores. The four projections are wgmma.mma_async products:
//    m64n96k16 bf16 for bfloat16, three m64n96k8 tf32 products (3xTF32) for
//    float32. The block's two warpgroups each take 96 of a product's 192
//    columns; a warp holds its 16 rows of A as fragments in registers and
//    the tensor cores read B from shared memory. The attention products
//    (64 x 64 x 32 a head) are mma.sync (window_core.cuh).
// 2. FMAs fed faster than shared memory delivers. wgmma reads B once for
//    all 64 rows; A costs one ldmatrix per 16 x 16 fragment.
// 3. Idle threads. All eight warps work in every product.
// 4. One block per SM in lock step. Tiles stay in their own type (bf16 as
//    bf16); x is no longer kept (LN1 reads it from global memory and the
//    residual re-reads it from L2), y lives in the attention output's tile
//    and the MLP's hidden units in tiles that are dead by then: 112 KB in
//    bfloat16, two blocks an SM, so that one window's LN, softmax, loads and
//    stores overlap another's products. float32 needs 222 KB, one block;
//    there the products of a slab overlap the split of the next.
// 5. Weights re-read by every window. They are packed once on the host
//    (ops/swin_block.py::pack_block_weights) into the stream of K slabs the
//    block consumes, 192 columns by 64 bytes of k each in the core-matrix
//    order wgmma reads, zero-padded, and arrive through a ring of
//    shared-memory stages filled with cp.async three slabs ahead, across the
//    attention and the epilogues too. The halves of float32 weights are
//    split off in shared memory as a slab arrives, not stored: that keeps
//    the L2 traffic at one read of every weight per window (0.59 MB in
//    bfloat16, 1.2 MB in float32).
// 6. Scalar attention core. Replaced by window_core.cuh::attend_rows; the
//    scores never leave registers.
// 7. torch.roll around shifted blocks. The shift is the kernel's `shift`.
//
// Every product has the same shape, 64 x 192 x K: q, k and v of a pair of
// heads (each padded to head_dim 32; 2 x 3 x 32 columns), proj, each half of
// fc1 (hidden units padded to 2 x 192) and fc2 (K up to 384). So C <= 192,
// head_dim <= 32, hidden <= 384. bfloat16 rounding goes through packed
// conversions (round_pair, store_pair): conversions run at a quarter of the
// ALU rate and were a third of the epilogues' time one value at a time.
#include "window_core.cuh"

namespace {

using e4s::win::kHeadElems;
using e4s::win::kLdHead;
using e4s::win::kMaxHeadDim;
using e4s::win::kMaxTokens;
using e4s::win::kThreads;
using e4s::win::round_pair;
using e4s::win::store_pair;

constexpr int kTile = 192;  // output columns of every product
// A warp's share of a product: the 16 rows of its place in its warpgroup and
// the 96 columns of the warpgroup, twelve 16 x 8 accumulator fragments.
constexpr int kGroupCols = kTile / 2;
constexpr int kColTiles = kGroupCols / 8;
constexpr int kAcc = 4 * kColTiles;
constexpr int kSlabBytes = 64;  // bytes of k in one row of a slab of weights
constexpr int kSlabSize = kTile * kSlabBytes;
// What wgmma reads is laid out in 8 x 16-byte core matrices: next to each
// other along k, then along the 24 groups of 8 columns.
constexpr int kCoreBytes = 128;
constexpr int kGroupStride = kSlabBytes / 16 * kCoreBytes;

// Offsets (floats) into the packed float32 vector.
constexpr int kVecLn1S = 0, kVecLn1B = kTile, kVecLn2S = 2 * kTile, kVecLn2B = 3 * kTile,
              kVecProjB = 4 * kTile, kVecFc2B = 5 * kTile, kVecQkvB = 6 * kTile;

template <typename T>
struct Shape {
  static constexpr int kSlab = kSlabBytes / static_cast<int>(sizeof(T));  // k of a slab
  static constexpr int kSlabElems = kTile * kSlab;
  // Row stride of the 64 x 192 tiles: the A fragments' eight rows fall into
  // different banks with 16 bytes (ldmatrix, bfloat16) or 4 words (float32)
  // beyond a multiple of 128 bytes.
  static constexpr int kLdTile = kTile + (sizeof(T) == 2 ? 8 : 4);
  // Stages of the ring and, in float32, two pairs of buffers for the halves
  // of the slab in use and of the next: what fits beside the tiles with two
  // blocks an SM in bfloat16 and one in float32.
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kRingElems = (kStages + (sizeof(T) == 4 ? 4 : 0)) * kSlabElems;
  // lnt, ot, one pair of heads, the ring
  static constexpr int kElems = 2 * kMaxTokens * kLdTile + 2 * kHeadElems + kRingElems;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The shared-memory descriptor of a wgmma B operand in the layout above, no
// swizzle: address, byte step between core matrices along k, byte step
// between groups of 8 columns, all in units of 16 bytes.
__device__ __forceinline__ uint64_t b_descriptor(const void* p) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr >> 4) & 0x3fff) | static_cast<uint64_t>(kCoreBytes >> 4) << 16 |
         static_cast<uint64_t>(kGroupStride >> 4) << 32;
}

// d (+)= a . b for the warpgroup's 64 rows and 96 columns: a is the calling
// warp's 16 x k fragment in registers, b a descriptor; `add` = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16(float (&d)[kAcc], const uint32_t (&a)[4],
                                           uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], const uint32_t (&a)[4],
                                           uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// One k step of the product: bf16 as it is; float32 as 3xTF32, the small
// terms first (`b` describes the high halves, the low ones lie one slab on).
__device__ __forceinline__ void wgmma_step(float (&d)[kAcc],
                                           const e4s::win::Mma<__nv_bfloat16>::AFrag& a,
                                           uint64_t b, int add) {
  wgmma_bf16(d, a.r, b, add);
}

__device__ __forceinline__ void wgmma_step(float (&d)[kAcc], const e4s::win::Mma<float>::AFrag& a,
                                           uint64_t b, int add) {
  wgmma_tf32(d, a.lo, b, add);
  wgmma_tf32(d, a.hi, b + (kSlabSize >> 4), 1);
  wgmma_tf32(d, a.hi, b, 1);
}

// The ring of weight slabs. Every thread of the block holds the same
// counters. Slab i of the packed stream lands in stage i % kStages with
// cp.async, three slabs ahead of the one in use. In bfloat16 the tensor
// cores read the stage itself. In float32 they read the slab's high and low
// tf32 halves, which the block splits off the stage into one of two pairs
// of buffers while the products of the slab before are still running.
//
// `start()` begins the first loads; `first()` makes slab 0 ready; then for
// each slab `current()` is what its products read and `advance()`, called
// once they are committed, makes the next slab ready, waits for them and
// brings the block in step.
template <typename T>
struct WeightRing {
  static constexpr int kStages = Shape<T>::kStages;
  static constexpr bool kSplit = sizeof(T) == 4;
  const T* src;
  T* stages;
  int total, queued, taken;

  __device__ __forceinline__ void queue_next() {
    if (queued < total) {
      const char* from = reinterpret_cast<const char*>(src) +
                         static_cast<long long>(queued) * kSlabSize;
      const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(
          stages + (queued % kStages) * Shape<T>::kSlabElems));
#pragma unroll
      for (int i = 0; i < kSlabSize / 16 / kThreads; ++i) {
        const int piece = (threadIdx.x + i * kThreads) * 16;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to + piece),
                     "l"(from + piece)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    ++queued;
  }
  // The halves of slab `i`, which has arrived in its stage: hi = the value
  // with its mantissa cut to tf32's 10 bits, lo = the rest.
  __device__ __forceinline__ void split(int i) {
    const float* stage = stages + (i % kStages) * Shape<T>::kSlabElems;
    float* hi = stages + (kStages + 2 * (i % 2)) * Shape<T>::kSlabElems;
    float* lo = hi + Shape<T>::kSlabElems;
#pragma unroll
    for (int j = 0; j < Shape<T>::kSlabElems / 4 / kThreads; ++j) {
      const int at = (threadIdx.x + j * kThreads) * 4;
      const float4 v = *reinterpret_cast<const float4*>(stage + at);
      float4 h, l;
      h.x = __uint_as_float(__float_as_uint(v.x) & 0xffffe000u), l.x = v.x - h.x;
      h.y = __uint_as_float(__float_as_uint(v.y) & 0xffffe000u), l.y = v.y - h.y;
      h.z = __uint_as_float(__float_as_uint(v.z) & 0xffffe000u), l.z = v.z - h.z;
      h.w = __uint_as_float(__float_as_uint(v.w) & 0xffffe000u), l.w = v.w - h.w;
      *reinterpret_cast<float4*>(hi + at) = h;
      *reinterpret_cast<float4*>(lo + at) = l;
    }
  }
  // Slab `i` ready for the tensor cores, which read through the asynchronous
  // proxy what ordinary stores and cp.async wrote; then the products in
  // flight done and the block in step.
  template <bool kProducts>
  __device__ __forceinline__ void make_ready(int i) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // all but the newest load
    if constexpr (kSplit) {
      __syncthreads();
      if (i < total) split(i);
    }
    // (the wait first: ptxas 12 crashes on a proxy fence between a commit
    // and its wait)
    if constexpr (kProducts) asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kSplit || kProducts) queue_next();  // into the stage read for the last time just now
  }
  __device__ __forceinline__ void start(const T* packed, T* buffers, int slabs) {
    src = packed, stages = buffers, total = slabs, queued = 0, taken = 0;
    for (int i = 0; i < kStages; ++i) queue_next();
  }
  __device__ __forceinline__ void first() { make_ready<false>(0); }
  __device__ __forceinline__ const T* current() const {
    return stages + (kSplit ? kStages + 2 * (taken % 2) : taken % kStages) * Shape<T>::kSlabElems;
  }
  __device__ __forceinline__ void advance() { make_ready<true>(++taken); }
};

// acc = A . B for the calling warp's 16 rows and its warpgroup's 96 columns.
// A's columns [0, 192) lie in tile a0 and [192, 384) in tile a1 (row stride
// kLdTile); B is the next `slabs` slabs of the ring. A warp loads its A
// fragments into registers and the tensor cores read B from shared memory.
// Returns with the products done and the block in step.
template <typename T>
__device__ __forceinline__ void gemm(float (&acc)[kAcc], const T* a0, const T* a1, int slabs,
                                     WeightRing<T>& ring) {
  using M = e4s::win::Mma<T>;
  constexpr int kLd = Shape<T>::kLdTile;
  constexpr int kSteps = Shape<T>::kSlab / M::kStep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  for (int s = 0; s < slabs; ++s) {
    const char* b = reinterpret_cast<const char*>(ring.current()) +
                    (warp / 4) * (kGroupCols / 8) * kGroupStride;
    const int k0 = s * Shape<T>::kSlab;
    const T* a = (k0 < kTile ? a0 + k0 : a1 + (k0 - kTile)) + 16 * (warp % 4) * kLd;
    typename M::AFrag af[kSteps];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      af[ks] = M::load_a_in_order(a + ks * M::kStep, kLd, g, t4);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_step(acc, af[ks], b_descriptor(b + ks * 2 * kCoreBytes), s + ks > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    ring.advance();
  }
}

// epi(row, column, tile, a, b, bias_a, bias_b) for every pair of neighbouring
// sums of the warp (tile = which of its twelve 8-column tiles, a constant
// where the loop is unrolled), with the two columns' entries of `bias` (192
// floats in global memory), all of which are loaded before the first sum is
// handed on.
template <typename Epi>
__device__ __forceinline__ void for_each_pair(const float (&acc)[kAcc], const float* bias,
                                              Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = (warp / 4) * kGroupCols + 2 * t4, row = 16 * (warp % 4) + g;
  float2 bv[kColTiles];
#pragma unroll
  for (int j = 0; j < kColTiles; ++j)
    bv[j] = *reinterpret_cast<const float2*>(bias + col0 + 8 * j);
#pragma unroll
  for (int j = 0; j < kColTiles; ++j) {
    epi(row, col0 + 8 * j, j, acc[4 * j], acc[4 * j + 1], bv[j].x, bv[j].y);
    epi(row + 8, col0 + 8 * j, j, acc[4 * j + 2], acc[4 * j + 3], bv[j].x, bv[j].y);
  }
}

// LayerNorm of the calling warp's 8 rows into the tile `dst` (columns past c
// zero); load(row, column) gives the input. Single-pass float32 statistics
// as the JAX kernel takes them. c <= 192. Every load is unconditional, so
// that a batch of rows is in flight together.
template <typename T, typename Load>
__device__ __forceinline__ void layer_norm_rows(Load load, T* dst, int c, const float* scale,
                                                const float* shift, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPer = kTile / 32;
  constexpr int kRows = kMaxTokens / e4s::win::kWarps;
  constexpr int kBatch = 4;  // rows whose loads are in flight together
  float sc[kPer], sh[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    sc[i] = scale[lane + 32 * i];  // padded to 192 by the packing
    sh[i] = shift[lane + 32 * i];
  }
  for (int r0 = kRows * warp; r0 < kRows * (warp + 1); r0 += kBatch) {
    float v[kBatch][kPer];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[b][i] = load(r0 + b, min(lane + 32 * i, c - 1));
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (lane + 32 * i >= c) v[b][i] = 0.f;
        s += v[b][i];
        s2 += v[b][i] * v[b][i];
      }
      s = e4s::win::warp_sum(s);
      s2 = e4s::win::warp_sum(s2);
      const float mu = s / c;
      const float inv = rsqrtf(s2 / c - mu * mu + eps);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int col = lane + 32 * i;
        const float o = col < c ? (v[b][i] - mu) * inv * sc[i] + sh[i] : 0.f;
        e4s::store_f32(dst + (r0 + b) * Shape<T>::kLdTile + col, o);
      }
    }
  }
}

// erf GELU in float32. For bfloat16, whose result is rounded to 8 bits right
// after, erf is Abramowitz and Stegun's 7.1.26 (absolute error 1.5e-7) on
// the fast exponential and reciprocal: a third of erff's instructions.
template <typename T>
__device__ __forceinline__ float gelu_erf(float v) {
  const float z = v * 0.70710678118654752f;
  if constexpr (sizeof(T) == 4) return 0.5f * v * (1.f + erff(z));
  const float a = fabsf(z);
  const float t = __frcp_rn(fmaf(0.3275911f, a, 1.f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float erf_a = 1.f - poly * __expf(-a * a);
  return 0.5f * v * (1.f + copysignf(erf_a, z));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
swin_block_kernel(const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ slabs,
                  const float* __restrict__ vec, const float* __restrict__ bias,
                  const int* __restrict__ labels, int height, int width, int c, int heads,
                  int cm, int window, int shift, float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int lab[kMaxTokens];
  __shared__ long long pix[kMaxTokens];
  T* lnt = reinterpret_cast<T*>(smem_raw);  // LN1, LN2, then hidden units 192..383
  constexpr int kLdTile = Shape<T>::kLdTile;
  constexpr int kSlab = Shape<T>::kSlab;
  T* ot = lnt + kMaxTokens * kLdTile;       // attention output, then y
  T* qkv = ot + kMaxTokens * kLdTile;       // a pair of heads, then hidden units 0..191
  T* stages = qkv + 2 * kHeadElems;

  const int n = window * window;
  const int hd = c / heads;
  const int pairs = ceil_div(heads, 2);
  const int chunks = ceil_div(cm, kTile);
  const int c_slabs = ceil_div(c, kSlab);
  const int warp = threadIdx.x >> 5;
  const float* fc1_b = vec + kVecQkvB + pairs * kTile;

  WeightRing<T> ring;
  ring.start(slabs, stages, (pairs + 1 + chunks) * c_slabs + ceil_div(cm, kSlab));

  const bool masked = labels != nullptr;
  // token rows past n repeat the window's tokens, so that every row holds
  // real data and no load needs a condition; nothing is stored for them
  if (threadIdx.x < kMaxTokens) {
    const int t = threadIdx.x % n;
    const int ty = t / window, tx = t - ty * window;
    const int yy = (static_cast<int>(blockIdx.y) * window + ty + shift) % height;
    const int xx = (static_cast<int>(blockIdx.x) * window + tx + shift) % width;
    pix[threadIdx.x] = (static_cast<long long>(blockIdx.z) * height + yy) * width + xx;
    lab[threadIdx.x] =
        masked ? labels[(static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * n + t] : 0;
  }
  // the attention output's columns past C are read by proj and never written
  for (int i = threadIdx.x; i < kMaxTokens * kLdTile; i += kThreads) e4s::store_f32(ot + i, 0.f);
  __syncthreads();

  layer_norm_rows<T>(
      [&](int row, int col) { return e4s::load_f32(x + pix[row] * c + col); },
      lnt, c, vec + kVecLn1S, vec + kVecLn1B, eps);
  ring.first();  // also brings the block in step
  const uint32_t differ = e4s::win::label_mask(masked ? lab : nullptr, n, 16 * (warp % 4));
  float acc[kAcc];
  for (int p = 0; p < pairs; ++p) {
    // q, k, v of heads 2p and 2p + 1: column = head * 96 + part * 32 + d
    gemm<T>(acc, lnt, lnt, c_slabs, ring);
    for_each_pair(acc, vec + kVecQkvB + p * kTile,
                  [&](int row, int col, int tile, float a, float b, float bias_a, float bias_b) {
      // a warpgroup's 96 columns are one head's q, k and v
      const int part = tile / (kMaxHeadDim / 8);
      T* dst = qkv + (warp / 4) * kHeadElems + row * kLdHead + col % kGroupCols;
      // (the store rounds last)
      round_pair<T>(a, b);
      a += bias_a, b += bias_b;
      if (part == 0) {
        round_pair<T>(a, b);
        a *= scale, b *= scale;
      }
      store_pair(dst, a, b);
    });
    __syncthreads();
    // four warps a head, 16 query rows each
    const int h = 2 * p + warp / 4;
    if (h < heads) {
      e4s::win::attend_rows<T>(
          qkv + (warp / 4) * kHeadElems, n, bias + static_cast<long long>(h) * n * n, differ,
          16 * (warp % 4), [&](int row, int col, float a, float b) {
            // an even hd keeps h * hd + col even: the pair is aligned
            e4s::win::store_in_head(ot + row * kLdTile + h * hd + col, col, hd, a, b);
          });
    }
    // the next product brings the block in step before its epilogue
    // overwrites this pair's q, k and v
  }
  __syncthreads();

  // y = x + round(attn . proj_w) + proj_b, rounded after each add; y takes
  // the attention output's place once every warp has read it
  gemm<T>(acc, ot, ot, c_slabs, ring);
  for_each_pair(acc, vec + kVecProjB,
                [&](int row, int col, int tile, float a, float b, float bias_a, float bias_b) {
    const T* xr = x + pix[row] * c;
    round_pair<T>(a, b);
    a += e4s::load_f32(xr + min(col, c - 1));
    b += e4s::load_f32(xr + min(col + 1, c - 1));
    round_pair<T>(a, b);
    a = col < c ? a + bias_a : 0.f;
    b = col + 1 < c ? b + bias_b : 0.f;
    store_pair(ot + row * kLdTile + col, a, b);  // rounds last
  });
  __syncthreads();
  layer_norm_rows<T>([&](int row, int col) { return e4s::load_f32(ot + row * kLdTile + col); },
                     lnt, c, vec + kVecLn2S, vec + kVecLn2B, eps);
  __syncthreads();
  // hidden units 0..191 take the heads' place, 192..383 LN2's once every
  // warp has read it
  for (int ch = 0; ch < chunks; ++ch) {
    gemm<T>(acc, lnt, lnt, c_slabs, ring);
    T* hid = ch == 0 ? qkv : lnt;
    for_each_pair(acc, fc1_b + ch * kTile,
                  [&](int row, int col, int tile, float a, float b, float bias_a, float bias_b) {
      store_pair(hid + row * kLdTile + col, gelu_erf<T>(a + bias_a), gelu_erf<T>(b + bias_b));
    });
  }
  __syncthreads();

  gemm<T>(acc, qkv, lnt, ceil_div(cm, kSlab), ring);
  for_each_pair(acc, vec + kVecFc2B,
                [&](int row, int col, int tile, float a, float b, float bias_a, float bias_b) {
    round_pair<T>(a, b);
    a += e4s::load_f32(ot + row * kLdTile + col);
    b += e4s::load_f32(ot + row * kLdTile + col + 1);
    round_pair<T>(a, b);
    T* dst = out + pix[row] * c + col;
    if (row >= n) return;
    // C even keeps pix * C + col even: the pair is aligned
    if (c % 2 == 0) {
      if (col < c) store_pair(dst, a + bias_a, b + bias_b);
    } else {
      if (col < c) e4s::store_f32(dst, a + bias_a);
      if (col + 1 < c) e4s::store_f32(dst + 1, b + bias_b);
    }
  });
}

template <typename T>
int launch(const void* x, void* out, const void* slabs, const float* vec, const float* bias,
           const int* labels, int batch, int height, int width, int c, int heads, int cm,
           int window, int shift, float scale, float eps, int limit, cudaStream_t stream) {
  const int smem = Shape<T>::kElems * static_cast<int>(sizeof(T));
  // the static label and pixel arrays share the block's shared memory
  if (smem + kMaxTokens * 12 > limit) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = swin_block_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's memory as shared memory: two bfloat16 blocks need it
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(width / window, height / window, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                           static_cast<const T*>(slabs), vec, bias, labels,
                                           height, width, c, heads, cm, window, shift, scale,
                                           eps);
  return e4s::launch_status();
}

}  // namespace

// K5. x and out (batch, height, width, channels) contiguous in `dtype`.
// `slabs` (in `dtype`) and `vec` (float32) are the block's weights as
// e4s2024_torch/ops/swin_block.py::pack_block_weights lays them out for
// `dtype`; bias (heads, n, n) float32 with n = window^2; labels
// (height / window, width / window, n) int32 or null. `shift` in
// [0, min(height, width)) is added to every token's pixel coordinates,
// modulo the image. `scale` is head_dim^-1/2 already rounded to `dtype`.
// Requires height and width multiples of window, n <= 64, channels <= 192
// and a multiple of heads, head_dim <= 32, hidden <= 384
// (ops/swin_block.py::widths_ok computes the same).
extern "C" int e4s_swin_block(const void* x, const void* slabs, const void* vec,
                              const void* bias, const void* labels, void* out, int dtype,
                              int batch, int height, int width, int channels, int heads,
                              int hidden, int window, int shift, float scale, float eps,
                              int device, void* stream) {
  const int n = window * window;
  if (heads <= 0 || window <= 0 || hidden <= 0 || channels <= 0 || channels % heads != 0 ||
      height % window != 0 || width % window != 0 || n > kMaxTokens || channels > kTile ||
      channels / heads > kMaxHeadDim || hidden > 2 * kTile || shift < 0 ||
      batch > e4s::kMaxGridYZ || height / window > e4s::kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (shift >= height || shift >= width) return static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* v = static_cast<const float*>(vec);
  const float* bs = static_cast<const float*>(bias);
  const int* lab = static_cast<const int*>(labels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case e4s::kFloat32:
      return launch<float>(x, out, slabs, v, bs, lab, batch, height, width, channels, heads,
                           hidden, window, shift, scale, eps, limit, s);
    case e4s::kBFloat16:
      return launch<__nv_bfloat16>(x, out, slabs, v, bs, lab, batch, height, width, channels,
                                   heads, hidden, window, shift, scale, eps, limit, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
