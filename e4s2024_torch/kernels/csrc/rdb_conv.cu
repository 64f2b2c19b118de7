// K7: a 3 x 3, stride 1, pad 1 float32 convolution over an NHWC buffer, as
// an implicit GEMM on the tensor cores, with its epilogue fused:
//
//   v   = conv(x[..., :cin], w) + bias            (N = 32 or 64 outputs)
//   v   = leaky_relu(v, 0.2)                       (if act)
//   v   = res1 + s1 * v                            (if res1)
//   v   = res2 + s2 * v                            (if res2)
//   out[..., out_off : out_off + N] = v
//
// x may be read through a nearest x2 upsample (`fold` = 2): output pixel
// (Y, X) then reads source pixel (Y / 2, X / 2) for each tap, and the
// upsampled image is never stored.
//
// Replaces no TPU kernel: the JAX package leaves RealESRGAN's convolutions
// to XLA (e4s2024_tpu/models/rrdb.py). Added for RRDBNet's residual dense
// blocks (models/rrdb.py), whose channel concatenations become channel
// slices of one dense buffer per block: conv i reads channels [0, cin) and
// writes its 32 new ones beside them, so no torch.cat is made; conv5's
// epilogue adds the block's (and, in the third block, the RRDB's) 0.2-scaled
// residual. In the tail, conv_up1 and conv_up2 fold the nearest x2 upsample
// into their addressing.
//
// Bound on the card: operations. A whole block at B = 8, 256^2 does
// 2 * 9 * (32 * (64 + 96 + 128 + 160) + 64 * 192) = 479,232 operations a
// pixel against ~3.3 KB of activations read and written: ~145 operations a
// byte, above float32's ridge. Float32 accuracy comes from error-compensated
// tf32 products (3xTF32): the weights are split once on the host into
// hi = tf32(w) and lo = tf32(w - hi), the activations in registers into
// hi = x with its mantissa cut to 10 bits and lo = x - hi, and every k step
// issues lo.hi + hi.lo + hi.hi into float32 accumulators (the dropped lo.lo
// and the 10 bits the tensor core keeps of lo leave about 2^-20 of
// |x||w| per product). So a third of the tf32 rate, 165 TFLOP/s, is the
// most float32 work it can reach: 1.52 ms for a whole block.
//
// The design:
//
// 1. The product. M is the pixels of a 16 x 16 output tile, N the outputs,
//    K = 9 * cin, walked chunk by chunk of 32 input channels and, inside a
//    chunk, tap by tap. Each of the block's two warpgroups owns 8 rows of
//    the tile as two m64 subtiles (4 rows of 16 pixels; a warp one row) and
//    issues wgmma.mma_async m64nNk8 tf32 with A from registers and B, the
//    weights, from shared memory.
// 2. The halo. A chunk's (16 / fold + 2)^2 source pixels x 32 channels are
//    staged in shared memory once and serve all nine taps: a tap only moves
//    the address a thread reads its A fragment from. A pixel's 32 channels
//    take 144 bytes (16 of padding), so that the eight pixels a quarter warp
//    reads with 16-byte loads fall into different banks. Pixels outside the
//    image are zero-filled by the copy (cp.async with a source size of 0).
// 3. The k order. Inside a chunk, k step ks (8 channels) gives a thread's
//    slots t4 and t4 + 4 the channels 8 t4 + 2 ks and 8 t4 + 2 ks + 1, so
//    one 16-byte load feeds two k steps; the host packs the weights in the
//    same order (ops/rdb_conv.py::pack_weights).
// 4. The weights. Each slab (a row of three taps of a chunk for N = 32,
//    one tap for N = 64), N outputs x 32 channels a tap in hi and lo halves
//    laid out in the 8 x 16-byte core matrices wgmma reads, is streamed
//    through a ring of shared-memory stages by one bulk copy of the tensor
//    memory accelerator, one (N = 32) or two slabs ahead of the one in use,
//    announced by an mbarrier; the whole weight set (<= 0.9 MB) stays in
//    the L2. The halos go by cp.async (zero-filling the border).
// 5. The pipeline. A tap's products go out in two halves (two k steps
//    each), each from a set of A registers of its own: while the last
//    halves run, the threads load and split the next half's fragments. The
//    block comes in step once per slab, to hand a freed stage to the next
//    copy.
// 6. The sums. The tensor cores truncate each partial sum, so a sum kept
//    in the wgmma accumulators over all of K drifts by about an ulp of the
//    total per product (5-7x cuDNN float32's error on these shapes). Each
//    slab's products are summed in fresh accumulators and added into
//    float32 registers rounded to nearest.
// 7. Persistent blocks. One block an SM walks the tiles; the halo of the
//    next chunk (also across tiles) is in flight during the current one.
// 8. The epilogue. Bias, LeakyReLU and the residuals are applied to the
//    accumulator fragments and stored as pairs of channels (8 bytes) into
//    the output's channel slice; rows outside the image are not stored.
//
// Where the time goes (H100, B = 8, 256^2, clock64 by phase): the products
// never wait on the tensor cores' completions; the issuing threads are busy
// issuing (35-39%: the tensor cores' back-pressure), loading and splitting A
// (13-27%), queueing the halos and the bulk copies (14-24%) and in the
// epilogue (3-8%). For N = 32 the shared memory carries, per 3-tap slab,
// 144 KB of B reads, 96 KB of A loads and 38 KB of copies: about what the
// tensor cores' own rate needs, so N = 32 convs cannot pass ~60% of the
// 3xTF32 bound on this design. A producer warp with mbarriers for every
// buffer would take the queueing off the warpgroups and let them drift
// apart.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // two warpgroups
constexpr int kTile = 16;                  // output tile: 16 x 16 pixels
constexpr int kChunk = 32;                 // input channels a k slab covers
constexpr int kPixFloats = kChunk + 4;     // a halo pixel: 32 channels, 144 bytes
constexpr int kCoreBytes = 128;            // one 8 x 16-byte core matrix

template <int kFold>
struct Halo {
  static constexpr int kW = kTile / kFold + 2;  // source pixels across
  static constexpr int kPixels = kW * kW;
  static constexpr int kFloats = kPixels * kPixFloats;
};

// A slab: the weights of kTaps taps of one chunk (N = 32: a row of the 3 x 3
// kernel, so that the block meets and adds its partial sums a third as
// often; N = 64: one tap, whose stages would not fit three times larger),
// streamed through kStages stages.
template <int kN>
struct Slab {
  static constexpr int kHalfBytes = kN * kChunk * 4;  // one tap's hi or lo half
  static constexpr int kTapBytes = 2 * kHalfBytes;
  static constexpr int kTaps = kN == 32 ? 3 : 1;
  static constexpr int kBytes = kTaps * kTapBytes;
  static constexpr int kPerChunk = 9 / kTaps;
  static constexpr int kStages = kN == 32 ? 3 : 4;
  // sets of A fragments in the registers, each a tap's half: products of
  // kSets - 1 halves stay in flight while the next set is loaded (N = 64
  // has room for two)
  static constexpr int kSets = kN == 32 ? 3 : 2;
  static constexpr int kAcc = kN / 2;                 // accumulators of an m64 subtile
};

struct Params {
  const float* x;      // (batch, in_h, in_w, in_stride), channels [0, cin) read
  const float* w;      // packed taps, (cin / 32) * 9 of Slab<N>::kTapBytes
  const float* bias;   // (N,)
  float* out;          // (batch, out_h, out_w, out_stride), channels [out_off, out_off + N)
  const float* res1;   // (batch, out_h, out_w, res1_stride) or null
  const float* res2;   // (batch, out_h, out_w, res2_stride) or null; may be out itself
  int in_h, in_w, in_stride, cin;
  int out_h, out_w, out_stride, out_off;
  int act, res1_stride, res2_stride;
  float s1, s2;
  int tiles_x, tiles_y, tiles;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One copy by the tensor memory accelerator of `bytes` (a multiple of 16)
// from global to shared memory, which completes the phase of `bar` it
// announces.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Until `bar` completes the phase of this parity; a copy that never lands
// traps (after about 2^31 cycles) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 31)) asm volatile("trap;");
  }
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// The shared-memory descriptor of a wgmma B operand with no swizzle: core
// matrices next to each other along k (128 bytes apart), groups of 8
// outputs 8 core matrices apart; address and strides in units of 16 bytes.
__device__ __forceinline__ uint64_t b_descriptor(const void* p) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr >> 4) & 0x3fff) | static_cast<uint64_t>(kCoreBytes >> 4) << 16 |
         static_cast<uint64_t>(8 * kCoreBytes >> 4) << 32;
}

// d (+)= a . b for the warpgroup's 64 rows and N columns; `add` = 0
// overwrites d.
template <int kN>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void tf32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b, int add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void tf32(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
  }
};

// v = hi + lo with hi the leading 19 bits of v (a tf32); the tensor core
// reads the leading 19 bits of lo.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A thread's A fragments for half a tap: [subtile][k step of the half][slot].
struct AFrags {
  uint32_t hi[2][2][4], lo[2][2][4];
};

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : __fmul_rn(v, 0.2f); }

template <int kN, int kFold>
__global__ void __launch_bounds__(kThreads, 1) rdb_conv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using H = Halo<kFold>;
  using S = Slab<kN>;
  constexpr int kStages = S::kStages;
  float* halo = reinterpret_cast<float*>(smem);  // two chunks' halos
  unsigned char* stages = smem + 2 * H::kFloats * 4;
  __shared__ float sbias[kN];
  __shared__ __align__(8) uint64_t full[kStages];  // a slab's weights have landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int chunks = p.cin / kChunk;
  const int per_tile = S::kPerChunk * chunks;
  const int my_tiles =
      (p.tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) / gridDim.x;
  const int total = my_tiles * per_tile;  // slabs this block runs
  const int all_chunks = my_tiles * chunks;

  auto tile_origin = [&](int k, int& b, int& y0, int& x0) {
    int t = static_cast<int>(blockIdx.x) + k * static_cast<int>(gridDim.x);
    const int tx = t % p.tiles_x;
    t /= p.tiles_x;
    const int ty = t % p.tiles_y;
    b = t / p.tiles_y;
    y0 = ty * kTile;
    x0 = tx * kTile;
  };

  // chunk `gc` of this block's sequence (tile gc / chunks, channels
  // 32 (gc % chunks) ...) into halo buffer gc % 2
  auto queue_halo = [&](int gc) {
    int b, y0, x0;
    tile_origin(gc / chunks, b, y0, x0);
    const int c0 = (gc % chunks) * kChunk;
    const int sy0 = y0 / kFold - 1, sx0 = x0 / kFold - 1;
    float* dst = halo + (gc & 1) * H::kFloats;
    for (int piece = tid; piece < H::kPixels * (kChunk / 4); piece += kThreads) {
      const int hp = piece >> 3, q = piece & 7;
      const int hy = hp / H::kW, hx = hp - hy * H::kW;
      const int sy = sy0 + hy, sx = sx0 + hx;
      const bool in = sy >= 0 && sy < p.in_h && sx >= 0 && sx < p.in_w;
      const float* src =
          p.x + (static_cast<long long>(b * p.in_h + (in ? sy : 0)) * p.in_w + (in ? sx : 0)) *
                    p.in_stride +
          c0 + 4 * q;
      cp_async16(dst + hp * kPixFloats + 4 * q, src, in ? 16 : 0);
    }
  };
  // the weights of slab i (taps kTaps (i % kPerChunk) ... of chunk
  // (i / kPerChunk) % chunks, consecutive in the packed stream) into stage
  // i % kStages, by one thread
  auto queue_slab = [&](int i) {
    const int c = (i / S::kPerChunk) % chunks, tap = (i % S::kPerChunk) * S::kTaps;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(p.w) +
                               static_cast<long long>(c * 9 + tap) * S::kTapBytes;
    bulk_load(stages + (i % kStages) * S::kBytes, src, S::kBytes, &full[i % kStages]);
  };

  // A fragments of half h of tap t of slab i: subtile s is rows
  // 8 wg + 4 s + wq of the tile, slot row g pixel g and slot row g + 8
  // pixel g + 8
  auto load_a = [&](AFrags& a, int i, int t, int h) {
    const int tap = (i % S::kPerChunk) * S::kTaps + t, dy = tap / 3 - 1, dx = tap % 3 - 1;
    const float* buf = halo + ((i / S::kPerChunk) & 1) * H::kFloats + 8 * t4 + 4 * h;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int y = 8 * wg + 4 * s + wq + dy;
      const int hy = kFold == 1 ? y + 1 : (y >> 1) + 1;
      float4 v[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = g + 8 * r + dx;
        const int hx = kFold == 1 ? x + 1 : (x >> 1) + 1;
        v[r] = *reinterpret_cast<const float4*>(buf + (hy * H::kW + hx) * kPixFloats);
      }
      split(v[0].x, a.hi[s][0][0], a.lo[s][0][0]);
      split(v[1].x, a.hi[s][0][1], a.lo[s][0][1]);
      split(v[0].y, a.hi[s][0][2], a.lo[s][0][2]);
      split(v[1].y, a.hi[s][0][3], a.lo[s][0][3]);
      split(v[0].z, a.hi[s][1][0], a.lo[s][1][0]);
      split(v[1].z, a.hi[s][1][1], a.lo[s][1][1]);
      split(v[0].w, a.hi[s][1][2], a.lo[s][1][2]);
      split(v[1].w, a.hi[s][1][3], a.lo[s][1][3]);
    }
  };

  // acc: the tile's sums in float32 registers; part: one slab's products,
  // summed by the tensor cores (design note 6)
  float acc[2][S::kAcc], part[2][S::kAcc];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < S::kAcc; ++j) part[s][j] = 0.f;

  // the products of half h of tap t of slab i, small terms first; the
  // first of a slab overwrites the partial sums
  auto issue = [&](const AFrags& a, int i, int t, int h) {
    const unsigned char* st = stages + (i % kStages) * S::kBytes + t * S::kTapBytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int ks = 2 * h + kh;
      const uint64_t bhi = b_descriptor(st + ks * 2 * kCoreBytes);
      const uint64_t blo = b_descriptor(st + S::kHalfBytes + ks * 2 * kCoreBytes);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        Wgmma<kN>::tf32(part[s], a.lo[s][kh], bhi, t + h + kh);
        Wgmma<kN>::tf32(part[s], a.hi[s][kh], blo, 1);
        Wgmma<kN>::tf32(part[s], a.hi[s][kh], bhi, 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  // the residuals of a subtile's two pixel rows are all loaded before the
  // first store (a store may alias res2, so the loads could not pass it)
  auto epilogue = [&](int k) {
    int b, y0, x0;
    tile_origin(k, b, y0, x0);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int y = y0 + 8 * wg + 4 * s + wq;
      long long pix[2];
      bool in[2];
      float2 q1[2][kN / 8], q2[2][kN / 8];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = x0 + g + 8 * r;
        in[r] = y < p.out_h && x < p.out_w;
        pix[r] = in[r] ? (static_cast<long long>(b) * p.out_h + y) * p.out_w + x : 0;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          q1[r][j] = p.res1 == nullptr ? make_float2(0.f, 0.f)
                     : *reinterpret_cast<const float2*>(p.res1 + pix[r] * p.res1_stride +
                                                        8 * j + 2 * t4);
          q2[r][j] = p.res2 == nullptr ? make_float2(0.f, 0.f)
                     : *reinterpret_cast<const float2*>(p.res2 + pix[r] * p.res2_stride +
                                                        8 * j + 2 * t4);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!in[r]) continue;
        float* o = p.out + pix[r] * p.out_stride + p.out_off + 2 * t4;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const float2 bj = *reinterpret_cast<const float2*>(sbias + 8 * j + 2 * t4);
          float v0 = acc[s][4 * j + 2 * r] + bj.x;
          float v1 = acc[s][4 * j + 2 * r + 1] + bj.y;
          if (p.act) v0 = lrelu(v0), v1 = lrelu(v1);
          if (p.res1 != nullptr) {
            v0 = __fadd_rn(q1[r][j].x, __fmul_rn(p.s1, v0));
            v1 = __fadd_rn(q1[r][j].y, __fmul_rn(p.s1, v1));
          }
          if (p.res2 != nullptr) {
            v0 = __fadd_rn(q2[r][j].x, __fmul_rn(p.s2, v0));
            v1 = __fadd_rn(q2[r][j].y, __fmul_rn(p.s2, v1));
          }
          *reinterpret_cast<float2*>(o + 8 * j) = make_float2(v0, v1);
        }
      }
    }
  };

  // The weights of slab i land in stage i % kStages, announced by
  // full[i % kStages] in phase i / kStages; they are queued kStages - 1
  // slabs ahead, into the stage whose last slab every warpgroup is done
  // with. The halos of the first two chunks are queued first, the halo of
  // chunk c + 1 as chunk c begins (its buffer's last reader, chunk c - 1,
  // is done by then), each as a cp.async group of its own.
  if (tid < kN) sbias[tid] = p.bias[tid];  // read after the barriers below
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < kStages; ++j)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[j]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < kStages - 1 && j < total; ++j) queue_slab(j);
  queue_halo(0);
  if (all_chunks > 1) queue_halo(1);
  cp_async_commit();
  cp_async_wait_all();
  mbar_wait(&full[0], 0);
  __syncthreads();

  // (the epilogue stays out of the slab loop: a use of the products in a
  // branch of its body makes ptxas wait for all of them at each turn)
  // the slab's 2 kTaps halves take the sets in turn; a set is loaded once
  // the products that read it last are done
  constexpr int kUnits = 2 * S::kTaps, kSets = S::kSets;
  static_assert(kUnits % kSets == 0, "every slab starts with set 0");
  AFrags a[kSets];
  load_a(a[0], 0, 0, 0);
  for (int k = 0, i = 0; k < my_tiles; ++k) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < S::kAcc; ++j) acc[s][j] = 0.f;
    for (int e = 0; e < per_tile; ++e, ++i) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        if (u >= kSets) wgmma_wait<kSets - 1>();  // half u - kSets is done
        if (u > 0) load_a(a[u % kSets], i, u / 2, u % 2);
        issue(a[u % kSets], i, u / 2, u % 2);
      }
      wgmma_wait<kSets - 1>();  // set 0 is free
      if (i + 1 < total) {
        // slab i + 1 (and, where it begins a chunk, the chunk's halo) has
        // landed; every warpgroup is done with slab i - 1, whose stage
        // takes slab i + kStages - 1, and with the halo of slab i's chunk
        const bool chunk_ends = (i + 1) % S::kPerChunk == 0;
        mbar_wait(&full[(i + 1) % kStages], ((i + 1) / kStages) & 1);
        if (chunk_ends) cp_async_wait_all();
        __syncthreads();
        if (tid == 0 && i + kStages - 1 < total) queue_slab(i + kStages - 1);
        if (chunk_ends && (i + 1) / S::kPerChunk + 1 < all_chunks) {
          queue_halo((i + 1) / S::kPerChunk + 1);
          cp_async_commit();
        }
        load_a(a[0], i + 1, 0, 0);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int j = 0; j < S::kAcc; ++j) acc[s][j] += part[s][j];
    }
    epilogue(k);
  }
  cp_async_wait_all();
}

template <int kN, int kFold>
int launch(const Params& p, int device, cudaStream_t stream) {
  const int smem = 2 * Halo<kFold>::kFloats * 4 + Slab<kN>::kStages * Slab<kN>::kBytes;
  auto* kernel = rdb_conv_kernel<kN, kFold>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.tiles < e4s::multiprocessors(device) ? p.tiles : e4s::multiprocessors(device);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return e4s::launch_status();
}

}  // namespace

// K7. x (batch, in_h, in_w, in_stride) float32, channels [0, cin) read;
// `packed` the weights as e4s2024_torch/ops/rdb_conv.py::pack_weights lays
// them out for n outputs; bias (n,) float32; out (batch, fold * in_h,
// fold * in_w, out_stride), channels [out_off, out_off + n) written; res1,
// res2 (batch, fold * in_h, fold * in_w, res*_stride) float32 or null (res2
// may alias out: each pixel reads it before writing). Requires n 32 or 64,
// fold 1 or 2, cin a positive multiple of 32 <= in_stride, in_stride a
// multiple of 4, out_off + n <= out_stride, the residual strides >= n, every
// stride and out_off even, x 16-byte and out and the residuals 8-byte
// aligned.
extern "C" int e4s_rdb_conv(const void* x, const void* packed, const void* bias, void* out,
                            const void* res1, const void* res2, int batch, int in_h, int in_w,
                            int in_stride, int cin, int n, int fold, int out_stride,
                            int out_off, int act, int res1_stride, float s1, int res2_stride,
                            float s2, int device, void* stream) {
  const auto misaligned = [](const void* q, uintptr_t to) {
    return q != nullptr && reinterpret_cast<uintptr_t>(q) % to != 0;
  };
  if ((n != 32 && n != 64) || (fold != 1 && fold != 2) || cin <= 0 || cin % kChunk != 0 ||
      cin > in_stride || in_stride % 4 != 0 || out_stride % 2 != 0 || out_off % 2 != 0 ||
      out_off < 0 || out_off + n > out_stride || (res1 != nullptr && (res1_stride < n || res1_stride % 2 != 0)) ||
      (res2 != nullptr && (res2_stride < n || res2_stride % 2 != 0)) || misaligned(x, 16) ||
      misaligned(packed, 16) || misaligned(bias, 8) || misaligned(out, 8) ||
      misaligned(res1, 8) || misaligned(res2, 8) || batch < 0 || in_h < 0 || in_w < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || in_h == 0 || in_w == 0) return 0;
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(packed);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.res1 = static_cast<const float*>(res1);
  p.res2 = static_cast<const float*>(res2);
  p.in_h = in_h, p.in_w = in_w, p.in_stride = in_stride, p.cin = cin;
  p.out_h = fold * in_h, p.out_w = fold * in_w, p.out_stride = out_stride, p.out_off = out_off;
  p.act = act, p.res1_stride = res1_stride, p.res2_stride = res2_stride;
  p.s1 = s1, p.s2 = s2;
  p.tiles_x = (p.out_w + kTile - 1) / kTile;
  p.tiles_y = (p.out_h + kTile - 1) / kTile;
  const long long tiles = static_cast<long long>(batch) * p.tiles_x * p.tiles_y;
  if (tiles > (1ll << 30)) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 32) return fold == 1 ? launch<32, 1>(p, device, s) : launch<32, 2>(p, device, s);
  return fold == 1 ? launch<64, 1>(p, device, s) : launch<64, 2>(p, device, s);
}
