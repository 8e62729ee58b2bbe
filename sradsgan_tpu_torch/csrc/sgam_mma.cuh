// Tensor-core building blocks shared by the SGAM attention kernels
// (sgam_flash.cu, sgam_flash_bwd.cu).
//
// Both kernels are chains of small matrix products around a softmax.  A warp
// owns 16 (or 2 x 16) rows of one operand, held in registers as A fragments
// of mma.sync (or of wgmma, which lays them out alike), and streams the
// other operand's rows by tiles of kTile = 64 through shared memory, where
// they serve as the B operand.  A tile has a
// "small" part (kTile x 8: keys or queries, the contraction depth d_qk
// zero-padded to 8) and a "wide" part (kTile x d_v: values or output
// cotangents).  Tiles are copied by cp.async into a ring of kStages buffers
// while the previous tile is consumed; rows past N are zero-filled in
// staging and masked in registers by the caller.
//
// Two element types, one fragment family (the m16n8 accumulator layout: lane
// 4 g + t holds rows g, g + 8 and columns 2 t, 2 t + 1 of each 16 x 8 tile):
//   - bfloat16: mma.sync.m16n8k8/k16 bf16 with float32 accumulators.  An
//     accumulator tile rounded to bf16 is, register for register, the A
//     fragment of the next product; B fragments whose contraction runs over
//     tile rows come from ldmatrix.trans.  Row strides are padded (wide:
//     d_v + 8 elements) so that the eight 16-byte rows of an ldmatrix and
//     the 32-bit fragment loads fall into distinct banks.
//   - float32: error-compensated TF32 ("3xTF32").  Each operand is split in
//     registers into a TF32 high part (cvt.rna, round to nearest) and its
//     float32 residual, and a product is the sum of
//     mma.sync.m16n8k8.tf32 of lo.hi, hi.lo and hi.hi into float32
//     accumulators (the energy product, whose result sits in an exponent,
//     adds lo.lo).  One TF32 product keeps 11 bits; the compensated sum
//     drops only terms of 2^-22 of a product.  The tensor cores truncate
//     their float32 accumulator after every product, a bias that grows with
//     the length of a chain (3e-5 of the result after the 1100 products of
//     N = 2916), so a chain never outlives a tile: each tile's products go
//     into a zeroed partial, which a rounded float32 add then folds into
//     the running sum.  An accumulator tile becomes the next A fragment by
//     taking its columns 2 t, 2 t + 1 as contraction
//     indices t, t + 4: the B fragment then reads tile rows 2 t, 2 t + 1, a
//     permutation of the contraction that changes no sum.  Strides: small
//     12 floats, wide d_v + 4 floats, both conflict-free for every fragment
//     load below.
//
// Both instruction families are here.  wgmma serves the 64-wide bf16
// products of the forward and the backward at the flagship widths, where
// its descriptors read the tiles in place.  mma.sync
// serves everything else: the float32 split forms its B operands in
// registers, and wgmma reads B from shared memory only; the backward's dS . k and dS^T . q are 8
// columns wide; and the narrow widths' rows are shorter than a swizzle
// line.  One accumulator layout serves both families, so the softmax
// between the products is shared code.
#pragma once

#include <cstdint>
#include <type_traits>

#include <math_constants.h>

#include "common.cuh"

namespace sg {
namespace attn {

constexpr int kTile = 64;   // streamed rows per stage
constexpr int kStages = 3;  // ring depth: one barrier a tile (see ring_wait)
constexpr int kChunks = kTile / 16;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// Shared-memory layout of one stage, in bytes.  WG is the layout the
// warpgroup products (wgmma, bf16) read through descriptors: rows unpadded,
// and the 16-byte pieces of a 128-byte wide row exchanged by the row's index
// modulo 8 (the 128-byte swizzle), which does for the bank conflicts what
// the padding does for the fragment loads.
template <typename T, int DV, bool WG = false>
struct Layout {
  static_assert(!WG || (!kIsF32<T> && DV == 64), "bf16 rows of 128 bytes");
  static constexpr int kSmallStride = kIsF32<T> ? 12 : 8;  // elements
  static constexpr int kWideStride =
      WG ? DV : DV + (kIsF32<T> ? 4 : 8);  // elements
  static constexpr int kSmallBytes = kTile * kSmallStride * sizeof(T);
  static constexpr int kWideBytes = kTile * kWideStride * sizeof(T);
  static constexpr int kStatBytes = 2 * kTile * sizeof(float);
  static_assert(kSmallBytes % 16 == 0 && kWideBytes % 16 == 0, "alignment");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy BYTES (4, 8 or 16) to shared memory; src_bytes = 0 zero-fills.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;  // exp2(-inf) = +0
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- float32: TF32 split and compensated product -------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  // The residual is exact in float32.  Its bits go to the tensor core as
  // they are: it reads the top 19, and cutting a residual of either sign
  // costs 2^-21 of x at most, without bias.
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16 x 8 float32 A fragment, split.
struct SplitA {
  uint32_t hi[4];
  uint32_t lo[4];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2,
                                          float a3) {
  SplitA s;
  split_tf32(a0, s.hi[0], s.lo[0]);
  split_tf32(a1, s.hi[1], s.lo[1]);
  split_tf32(a2, s.hi[2], s.lo[2]);
  split_tf32(a3, s.hi[3], s.lo[3]);
  return s;
}

// c += a . b with b split here; the small terms first.  FULL adds lo . lo.
template <bool FULL = false>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a,
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  if (FULL) mma_tf32(c, a.lo, bl0, bl1);
  mma_tf32(c, a.lo, bh0, bh1);
  mma_tf32(c, a.hi, bl0, bl1);
  mma_tf32(c, a.hi, bh0, bh1);
}

// ---- bfloat16 ------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_k8(float (&c)[4],
                                            const uint32_t (&a)[2],
                                            uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}
__device__ __forceinline__ void mma_bf16_k16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(row))
      : "memory");
}

// ---- bfloat16, warpgroup products (wgmma) ----------------------------------
// Four warps issue one asynchronous 64 x 64 x 16 product: A (this warp's 16
// rows, the m16n8k16 A fragment) from registers, B from shared memory
// through a descriptor, the sum in each thread's 32 accumulator registers,
// laid out as eight m16n8 accumulator tiles side by side.

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all in 16-byte units) and the swizzle mode (0 none, 1 128-byte).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int leading,
                                               int stride, int swizzle) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3fff) |
         static_cast<uint64_t>((leading >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((stride >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// d (+)= a . B; B_BY_ROWS: the contraction runs over B's shared-memory rows
// (P . V) rather than along them (q . k^T).  ACCUMULATE = false overwrites d.
#define SG_WGMMA_BODY                                                        \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                    \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"  \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"                        \
  "{%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
#define SG_D4(x) "+f"((x)[0]), "+f"((x)[1]), "+f"((x)[2]), "+f"((x)[3])
template <bool B_BY_ROWS>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc,
                                                bool accumulate) {
  asm volatile(SG_WGMMA_BODY
               : SG_D4(d[0]), SG_D4(d[1]), SG_D4(d[2]), SG_D4(d[3]),
                 SG_D4(d[4]), SG_D4(d[5]), SG_D4(d[6]), SG_D4(d[7])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
                 "r"(static_cast<int>(accumulate)), "n"(B_BY_ROWS ? 1 : 0));
}
#undef SG_D4
#undef SG_WGMMA_BODY

// ---- A operands held in registers ---------------------------------------

// 16 rows x 8 (d_qk zero-padded) of q or k, read from device memory once.
template <typename T>
struct SmallA;
template <>
struct SmallA<float> {
  SplitA a;
};
template <>
struct SmallA<__nv_bfloat16> {
  uint32_t a[2];
};

// rows row0 + g and row0 + g + 8 of x (N, DQK); rows past N and columns past
// DQK read as zero.
template <typename T, int DQK>
__device__ __forceinline__ SmallA<T> load_small_a(const T* x, int row0, int N,
                                                  int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
  SmallA<T> out;
  if constexpr (kIsF32<T>) {
    auto at = [&](int r, int c) {
      return (r < N && c < DQK) ? x[static_cast<long>(r) * DQK + c] : 0.f;
    };
    out.a = split_a(at(r0, t), at(r1, t), at(r0, t + 4), at(r1, t + 4));
  } else {
    auto at = [&](int r) -> uint32_t {
      if (r >= N || 2 * t >= DQK) return 0u;
      return *reinterpret_cast<const uint32_t*>(
          x + static_cast<long>(r) * DQK + 2 * t);
    };
    out.a[0] = at(r0);
    out.a[1] = at(r1);
  }
  return out;
}

// 16 rows x DV of dO or v.
template <typename T, int DV>
struct WideA;
template <int DV>
struct WideA<float, DV> {
  SplitA a[DV / 8];
};
template <int DV>
struct WideA<__nv_bfloat16, DV> {
  uint32_t a[DV / 16][4];
};

template <typename T, int DV>
__device__ __forceinline__ WideA<T, DV> load_wide_a(const T* x, int row0,
                                                    int N, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
  WideA<T, DV> out;
  if constexpr (kIsF32<T>) {
    auto at = [&](int r, int c) {
      return r < N ? x[static_cast<long>(r) * DV + c] : 0.f;
    };
#pragma unroll
    for (int kk = 0; kk < DV / 8; ++kk)
      out.a[kk] = split_a(at(r0, 8 * kk + t), at(r1, 8 * kk + t),
                          at(r0, 8 * kk + t + 4), at(r1, 8 * kk + t + 4));
  } else {
    auto at = [&](int r, int c) -> uint32_t {
      if (r >= N) return 0u;
      return *reinterpret_cast<const uint32_t*>(x + static_cast<long>(r) * DV +
                                                c);
    };
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      out.a[kk][0] = at(r0, 16 * kk + 2 * t);
      out.a[kk][1] = at(r1, 16 * kk + 2 * t);
      out.a[kk][2] = at(r0, 16 * kk + 2 * t + 8);
      out.a[kk][3] = at(r1, 16 * kk + 2 * t + 8);
    }
  }
  return out;
}

// ---- staging -------------------------------------------------------------

// Zero a block's whole dynamic shared memory once: the copies below never
// write the padding columns, which the small fragments read as zeros.
template <int THREADS>
__device__ __forceinline__ void zero_smem(unsigned char* smem, int bytes) {
  uint32_t* w = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < bytes / 4; i += THREADS) w[i] = 0u;
}

template <int BYTES>
__device__ __forceinline__ void zero_bytes(void* dst) {
  if constexpr (BYTES == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = 0u;
  }
}

// One thread's share of the copies of a tile: rows j0 .. j0 + kTile of small
// (N, DQK) and wide (N, DV) into one stage.  Which pieces a thread copies
// never changes and tiles are issued in order, so the thread keeps two
// running source pointers and two offsets into a stage: a whole tile costs
// each piece one copy at a constant offset and no address arithmetic.  Only
// the ragged last tile looks at N: its rows past N are zeroed by plain
// stores, which the barrier before the tile's use also covers.
template <typename T, int DQK, int DV, int THREADS, bool WG = false>
struct TileCopier {
  using L = Layout<T, DV, WG>;
  static constexpr int kRowBytes = DQK * sizeof(T);
  static constexpr int kCopy = kRowBytes < 16 ? kRowBytes : 16;
  static constexpr int kPerRow = kRowBytes / kCopy;
  static constexpr int kWideRowBytes = DV * sizeof(T);
  static constexpr int kWidePerRow = kWideRowBytes / 16;
  static constexpr int kSmallTotal = kTile * kPerRow;
  static constexpr int kWideTotal = kTile * kWidePerRow;
  static constexpr int kSmallStep = THREADS / kPerRow;      // rows a round
  static constexpr int kWideStep = THREADS / kWidePerRow;
  static constexpr int kSmallStride = L::kSmallStride * sizeof(T);  // bytes
  static constexpr int kWideStride = L::kWideStride * sizeof(T);
  static_assert(THREADS % kPerRow == 0 && THREADS % kWidePerRow == 0,
                "a thread keeps its column from round to round");
  static_assert(!WG || kWideStep % 8 == 0, "and its swizzled place");

  const char* small_src;  // this thread's first piece of the next tile
  const char* wide_src;
  int small_dst, wide_dst;  // its byte offset in a stage

  __device__ __forceinline__ TileCopier(const T* small, const T* wide) {
    const unsigned tid = threadIdx.x;
    const int sr = tid / kPerRow, wr = tid / kWidePerRow;
    const int sc = (tid % kPerRow) * kCopy, wc = (tid % kWidePerRow) * 16;
    small_src = reinterpret_cast<const char*>(small) + sr * kRowBytes + sc;
    wide_src = reinterpret_cast<const char*>(wide) + wr * kWideRowBytes + wc;
    small_dst = sr * kSmallStride + sc;
    wide_dst = L::kSmallBytes + wr * kWideStride +
               (WG ? wc ^ ((wr & 7) << 4) : wc);
  }

  // Copy piece `n` of this thread if IN, else zero its place.
  template <bool IN>
  __device__ __forceinline__ void small_piece(unsigned char* stage,
                                              int n) const {
    unsigned char* dst = stage + small_dst + n * kSmallStep * kSmallStride;
    if (IN)
      cp_async<kCopy>(dst, small_src + n * kSmallStep * kRowBytes, kCopy);
    else
      zero_bytes<kCopy>(dst);
  }
  template <bool IN>
  __device__ __forceinline__ void wide_piece(unsigned char* stage,
                                             int n) const {
    unsigned char* dst = stage + wide_dst + n * kWideStep * kWideStride;
    if (IN)
      cp_async<16>(dst, wide_src + n * kWideStep * kWideRowBytes, 16);
    else
      zero_bytes<16>(dst);
  }

  // Issue the next tile, whose first row is j0, and move on to the one after.
  __device__ __forceinline__ void issue(unsigned char* stage, int j0, int N) {
    const unsigned tid = threadIdx.x;
    if (j0 + kTile <= N) {
#pragma unroll
      for (int n = 0; n * THREADS < kSmallTotal; ++n)
        if (tid + n * THREADS < kSmallTotal) small_piece<true>(stage, n);
#pragma unroll
      for (int n = 0; n * THREADS < kWideTotal; ++n)
        if (tid + n * THREADS < kWideTotal) wide_piece<true>(stage, n);
    } else {
      const int sr = j0 + tid / kPerRow, wr = j0 + tid / kWidePerRow;
#pragma unroll
      for (int n = 0; n * THREADS < kSmallTotal; ++n)
        if (tid + n * THREADS < kSmallTotal) {
          if (sr + n * kSmallStep < N)
            small_piece<true>(stage, n);
          else
            small_piece<false>(stage, n);
        }
#pragma unroll
      for (int n = 0; n * THREADS < kWideTotal; ++n)
        if (tid + n * THREADS < kWideTotal) {
          if (wr + n * kWideStep < N)
            wide_piece<true>(stage, n);
          else
            wide_piece<false>(stage, n);
        }
    }
    small_src += kTile * kRowBytes;
    wide_src += kTile * kWideRowBytes;
  }
};

// The ring's schedule, shared by the kernels.  Before the loop: issue tiles 0
// and 1, one commit each (an empty group where there is no tile).  At tile
// `it`: ring_wait() (tile `it` has landed for every thread, and every warp
// is done with tile it - 1), then issue tile it + 2 into the stage that tile
// it - 1 used, commit, and compute on stage it % kStages.  One barrier a
// tile.
template <bool WG = false>
__device__ __forceinline__ void ring_wait() {
  cp_async_wait<1>();  // all groups but the newest: tiles up to `it`
  if (WG)  // what this thread wrote, before the tensor cores' own reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// ---- products over one chunk of 16 tile rows ------------------------------
// Chunk c covers tile rows 16 c .. 16 c + 15 as two accumulator tiles i = 0, 1
// of 8 columns each.

// s[i] = xa . small[rows of tile i]^T  (the energies of 16 x 16 pairs)
template <typename T>
__device__ __forceinline__ void chunk_small_product(float (&s)[2][4],
                                                    const SmallA<T>& xa,
                                                    const T* small, int c,
                                                    int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    const int row = 16 * c + 8 * i + g;
    if constexpr (kIsF32<T>) {
      const float* p = small + row * 12;
      mma_3xtf32<true>(s[i], xa.a, p[t], p[t + 4]);
    } else {
      mma_bf16_k8(s[i], xa.a,
                  *reinterpret_cast<const uint32_t*>(small + row * 8 + 2 * t));
    }
  }
}

// s[i] = xa . wide[rows of tile i]^T  (dO . v^T or v . dO^T)
template <typename T, int DV>
__device__ __forceinline__ void chunk_wide_product(float (&s)[2][4],
                                                   const WideA<T, DV>& xa,
                                                   const T* wide, int c,
                                                   int lane) {
  constexpr int kStride = Layout<T, DV>::kWideStride;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    const T* row = wide + (16 * c + 8 * i + g) * kStride;
    if constexpr (kIsF32<T>) {
#pragma unroll
      for (int kk = 0; kk < DV / 8; ++kk)
        mma_3xtf32(s[i], xa.a[kk], row[8 * kk + t], row[8 * kk + t + 4]);
    } else if constexpr (DV % 32 == 0) {
      // four 8 x 8 matrices a load: tile rows 8 i .. 8 i + 7 at columns
      // 32 kp + 0, 8, 16, 24: the B fragments of two contraction steps
      const T* mat = wide + (16 * c + 8 * i + (lane & 7)) * kStride +
                     (lane >> 3) * 8;
#pragma unroll
      for (int kp = 0; kp < DV / 32; ++kp) {
        uint32_t b[4];
        ldmatrix_x4(b, mat + 32 * kp);
        mma_bf16_k16(s[i], xa.a[2 * kp], b[0], b[1]);
        mma_bf16_k16(s[i], xa.a[2 * kp + 1], b[2], b[3]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        mma_bf16_k16(
            s[i], xa.a[kk],
            *reinterpret_cast<const uint32_t*>(row + 16 * kk + 2 * t),
            *reinterpret_cast<const uint32_t*>(row + 16 * kk + 2 * t + 8));
    }
  }
}

// acc[m][n] += p[m] . wide[chunk rows, columns 8 (n0 + n) ..]  (P . v or
// P^T . dO) for NN column tiles from n0 on, and MT row tiles that share each
// B fragment.
template <typename T, int DV, int MT, int NN>
__device__ __forceinline__ void chunk_wide_accumulate(
    float (&acc)[MT][NN][4], const float (&p)[MT][2][4], const T* wide, int c,
    int n0, int lane) {
  constexpr int kStride = Layout<T, DV>::kWideStride;
  if constexpr (kIsF32<T>) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      SplitA a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        a[m] = split_a(p[m][i][0], p[m][i][2], p[m][i][1], p[m][i][3]);
      const float* r0 =
          wide + (16 * c + 8 * i + 2 * t) * kStride + 8 * n0 + g;
      const float* r1 = r0 + kStride;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(r0[8 * n], bh0, bl0);
        split_tf32(r1[8 * n], bh1, bl1);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_tf32(acc[m][n], a[m].lo, bh0, bh1);
          mma_tf32(acc[m][n], a[m].hi, bl0, bl1);
          mma_tf32(acc[m][n], a[m].hi, bh0, bh1);
        }
      }
    }
  } else {
    static_assert(NN % 2 == 0, "ldmatrix.x4 feeds two column tiles");
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      a[m][0] = pack_bf16(p[m][0][0], p[m][0][1]);
      a[m][1] = pack_bf16(p[m][0][2], p[m][0][3]);
      a[m][2] = pack_bf16(p[m][1][0], p[m][1][1]);
      a[m][3] = pack_bf16(p[m][1][2], p[m][1][3]);
    }
    // lanes 0-7, 8-15: rows 0-7, 8-15 at column 0; lanes 16-31: at column 8
    const T* row = wide + (16 * c + (lane & 15)) * kStride + 8 * n0 +
                   (lane >> 4) * 8;
#pragma unroll
    for (int np = 0; np < NN / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + 16 * np);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16_k16(acc[m][2 * np], a[m], b[0], b[1]);
        mma_bf16_k16(acc[m][2 * np + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// acc += ds . small[chunk rows]  (dS . k or dS^T . q; 8 columns)
template <typename T>
__device__ __forceinline__ void chunk_small_accumulate(float (&acc)[4],
                                                       const float (&ds)[2][4],
                                                       const T* small, int c,
                                                       int lane) {
  if constexpr (kIsF32<T>) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const SplitA a = split_a(ds[i][0], ds[i][2], ds[i][1], ds[i][3]);
      const float* r0 = small + (16 * c + 8 * i + 2 * t) * 12 + g;
      mma_3xtf32(acc, a, r0[0], r0[12]);
    }
  } else {
    uint32_t a[4];
    a[0] = pack_bf16(ds[0][0], ds[0][1]);
    a[1] = pack_bf16(ds[0][2], ds[0][3]);
    a[2] = pack_bf16(ds[1][0], ds[1][1]);
    a[3] = pack_bf16(ds[1][2], ds[1][3]);
    uint32_t b[2];
    ldmatrix_x2_trans(b, small + (16 * c + (lane & 15)) * 8);
    mma_bf16_k16(acc, a, b[0], b[1]);
  }
}

// Store one accumulator tile's pair (columns col, col + 1 of a row).
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Dynamic shared memory above 48 KB has to be asked for, per kernel and
// device; asking again at each launch costs a host call and keeps a second
// device right.
template <typename Kernel>
inline cudaError_t allow_shared_bytes(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Rows per block to launch with, from the candidates 16 * mt * warps in
// falling order: the largest that still gives every SM two blocks, else the
// smallest.
inline int sm_count() {
  static int count = 0;  // of the first device used; cards of a host are alike
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}
inline bool fills_card(int B, int N, int rows) {
  return static_cast<long>(B) * ((N + rows - 1) / rows) >= 2L * sm_count();
}

}  // namespace attn
}  // namespace sg
