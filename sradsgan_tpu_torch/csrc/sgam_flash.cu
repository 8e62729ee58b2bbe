// K3: SGAM position attention forward, out = softmax(q k^T) v, unscaled.
//
// Replaces the Pallas TPU flash-attention forward that
// sradsgan_tpu/ops/sgam_flash.py:flash_position_attention calls.  As there,
// the (N, N) energy never reaches device memory: each query row keeps a
// float32 running max, running sum and output accumulator while the keys
// stream by, and the softmax has no 1/sqrt(d) scale (the reference SGAM).
//
// Bound: per query-key pair the function has d_qk + d_v = 72 multiply-adds
// and one exponential against 2 * N * 144 elements of input per image, so it
// is bound by operations: on the tensor cores the products take less time
// than the exponentials (16 a clock a multiprocessor), and on the CUDA cores
// they took ten times the bound, most of it shared-memory reads (six 16-byte
// loads for 24 multiply-adds, and each energy and exp computed four times).
// What this kernel does about it (building blocks in sgam_mma.cuh):
//   - both products run on the tensor cores, and a warp owns whole rows of
//     the d_v width, so each energy and each exponential is computed once.
//     bf16 at the flagship widths (d_qk 8, d_v 64) with enough rows to fill
//     the card: the block's four warps are one warpgroup and issue wgmma
//     (m64n64k16): the energies with q from registers, its depth padded to
//     16 by a tile of zeros behind the descriptor's leading offset, and
//     P . V with P rounded to bf16 in registers and V read in place through
//     a 128-byte-swizzled descriptor.  Other bf16 cases (narrow widths,
//     few rows): mma.sync m16n8k8 and m16n8k16 with ldmatrix.trans.
//     float32: error-compensated TF32 with mma.sync (three m16n8k8.tf32
//     products of rounded high parts and residuals, four for the energies),
//     which keeps float32 accuracy where one TF32 product keeps three
//     digits; wgmma cannot take the split B operands from registers;
//   - K and V tiles of 64 keys go through a three-stage ring in shared
//     memory filled by cp.async, two tiles in flight while one is used, one
//     barrier a tile; padded strides (or the swizzle) keep every fragment
//     load free of bank conflicts, and a thread's copy addresses are running
//     pointers, not recomputed (that arithmetic was a quarter of the time);
//   - keys past N are zero-filled in staging and set to -inf in registers,
//     so a ragged N needs no padding;
//   - registers are capped so that the train step's 736 blocks of 64 rows
//     are one wave (bf16 mma.sync) or two nearly full ones; a second wave of
//     a few blocks doubled the time;
//   - the launch takes the largest block (4 warps of 32 rows in float32, of
//     16 rows, or 2 warps) that still gives every multiprocessor two blocks.
//     Where none does (one image of 54^2 positions is 46 blocks of 64 rows
//     on 132 multiprocessors) it splits the keys instead: a block of four
//     warps owns 16 rows, warp w takes keys 16 w .. 16 w + 15 of every tile
//     with its own running max, sum and accumulator, and the four triples
//     are merged in float32 through shared memory at the end.  A warp of a
//     split block may see only masked keys; its max then stays -inf and its
//     weights are computed against 0, so they are 0 and never NaN.
// What holds it now: the softmax between the products.  With any one part
// taken out (the exponentials, P . V, the copies) the time fell by that
// part's share and no more, so no single unit is the limit; it is the
// instruction stream of max, scale, exp, sum and pack per pair.
// When a backward will follow, the kernel also writes each row's float32
// log-sum-exp, lse = m + log(l), from which the backward kernels
// (sgam_flash_bwd.cu) recompute the softmax; under no-grad the pointer is
// null and nothing more is stored.
#include "sgam_mma.cuh"

namespace {

using namespace sg::attn;

// How a block shares its work.  kRows: the NW warps own MT x 16 query rows
// each and every warp walks all keys.  kSplit (MT = 1): the warps share one
// tile of 16 query rows and warp w takes chunk w (16 keys) of every key
// tile; their (max, sum, accumulator) triples are merged through shared
// memory at the end.  kGroup (bf16, d_v = 64, MT = 1, four warps): as kRows,
// but the four warps issue each product together as one warpgroup (wgmma).
enum Mode { kRows, kSplit, kGroup };

// Blocks a multiprocessor should hold, which caps the registers: the train
// step's 16 x 2916 rows are 736 blocks of 64 rows, one wave at six blocks a
// multiprocessor (bf16 mma.sync) and two at three (float32) or four (the
// warpgroup, whose 64 accumulator registers do not fit six).
template <typename T, int MT, int NW, Mode MODE>
constexpr int kMinBlocks =
    MODE == kGroup ? 4 : MT == 2 ? 2 : (kIsF32<T> ? 3 : 6) * 4 / NW;

template <typename T, int DQK, int DV, int MT, int NW, Mode MODE>
__global__ void __launch_bounds__(NW * 32, kMinBlocks<T, MT, NW, MODE>)
    position_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              float* __restrict__ lse, int N) {
  constexpr bool SPLIT = MODE == kSplit, WG = MODE == kGroup;
  using L = Layout<T, DV, WG>;
  static_assert(MODE == kRows || (MT == 1 && NW == kChunks),
                "a chunk per warp; a warpgroup");
  constexpr int kThreads = NW * 32;
  constexpr int kStageBytes = L::kSmallBytes + L::kWideBytes;
  constexpr int kOwn = SPLIT ? 1 : kChunks;  // chunks of a tile a warp takes
  constexpr int kCols = DV / 8;
  // float32 chains end with the tile (sgam_mma.cuh): partials of kPart tiles
  constexpr int kPart = MT == 2 ? 2 : (kCols < 4 ? kCols : 4);
  extern __shared__ __align__(16) unsigned char smem_base[];
  // the swizzled tiles sit on 1024-byte lines (the launch adds the room)
  unsigned char* smem =
      WG ? smem_base + ((1024 - (smem_addr(smem_base) & 1023)) & 1023)
         : smem_base;
  // a tile of zeros after the ring: the energies' contraction is 16 deep,
  // the upper 8 all zero, for every stage
  const unsigned char* zeros = smem + kStages * kStageBytes;

  const long b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = SPLIT ? blockIdx.x * 16
                         : (blockIdx.x * NW + warp) * (MT * 16);
  const T* qb = q + b * N * DQK;
  const T* kb = k + b * N * DQK;
  const T* vb = v + b * N * DV;

  zero_smem<kThreads>(smem, kStages * kStageBytes + (WG ? L::kSmallBytes : 0));
  __syncthreads();
  TileCopier<T, DQK, DV, kThreads, WG> copier(kb, vb);
  const int tiles = (N + kTile - 1) / kTile;
  copier.issue(smem, 0, N);
  cp_async_commit();
  if (tiles > 1) copier.issue(smem + kStageBytes, kTile, N);
  cp_async_commit();

  SmallA<T> qa[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
    qa[m] = load_small_a<T, DQK>(qb, row0 + 16 * m, N, lane);

  float acc[MT][kCols][4];
  float mx[MT][2], sum[MT][2];  // rows g and g + 8; sum is this lane's share
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < kCols; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    mx[m][0] = mx[m][1] = -CUDART_INF_F;
    sum[m][0] = sum[m][1] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    const int j0 = it * kTile;
    ring_wait<WG>();
    if (it + 2 < tiles)
      copier.issue(smem + ((it + 2) % kStages) * kStageBytes, j0 + 2 * kTile,
                   N);
    cp_async_commit();
    const unsigned char* stage = smem + (it % kStages) * kStageBytes;
    const T* s_k = reinterpret_cast<const T*>(stage);
    const T* s_v = reinterpret_cast<const T*>(stage + L::kSmallBytes);

    float s[kOwn][MT][2][4];
    if constexpr (WG) {
      // 8 keys are 128 contiguous bytes, the next 8 follow: no swizzle; the
      // second half of the contraction reads the zeros
      float e[8][4];
      const uint32_t a[4] = {qa[0].a[0], qa[0].a[1], 0u, 0u};
      wgmma_fence();
      wgmma_m64n64k16<false>(
          e, a, wgmma_desc(s_k, static_cast<int>(zeros - stage), 128, 0),
          false);
      wgmma_commit_and_wait();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[j / 2][0][j % 2][x] = e[j][x];
    } else {
#pragma unroll
      for (int ci = 0; ci < kOwn; ++ci)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          chunk_small_product<T>(s[ci][m], qa[m], s_k, SPLIT ? warp : ci,
                                 lane);
    }

    if (j0 + kTile > N) {  // the ragged last tile: keys past N weigh nothing
#pragma unroll
      for (int ci = 0; ci < kOwn; ++ci)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + 16 * (SPLIT ? warp : ci) + 8 * i + 2 * t + (e & 1) >= N) {
#pragma unroll
              for (int m = 0; m < MT; ++m) s[ci][m][i][e] = -CUDART_INF_F;
            }
    }

#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // row g (h = 0) and row g + 8
        float tile_max = -CUDART_INF_F;
#pragma unroll
        for (int ci = 0; ci < kOwn; ++ci)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            tile_max = fmaxf(tile_max, fmaxf(s[ci][m][i][2 * h],
                                             s[ci][m][i][2 * h + 1]));
        const float m_new = fmaxf(mx[m][h], quad_max(tile_max));
        // -inf only while a warp of a split block has seen masked keys alone:
        // then every weight and the correction are exp2(-inf) = 0, not NaN
        const float m_ref = m_new == -CUDART_INF_F ? 0.f : m_new;
        const float corr = exp2_approx((mx[m][h] - m_ref) * kLog2e);
        mx[m][h] = m_new;
        const float shift = -m_ref * kLog2e;
        float part = 0.f;
#pragma unroll
        for (int ci = 0; ci < kOwn; ++ci)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              const float p = exp2_approx(fmaf(s[ci][m][i][e], kLog2e, shift));
              s[ci][m][i][e] = p;  // 0 for masked keys
              part += p;
            }
        sum[m][h] = fmaf(sum[m][h], corr, part);
        // after the first tiles the max rarely moves: corr is then 1
        if (__any_sync(0xffffffffu, corr != 1.f)) {
#pragma unroll
          for (int n = 0; n < kCols; ++n) {
            acc[m][n][2 * h] *= corr;
            acc[m][n][2 * h + 1] *= corr;
          }
        }
      }
    }

    if constexpr (kIsF32<T>) {
#pragma unroll
      for (int n0 = 0; n0 < kCols; n0 += kPart) {
        float part[MT][kPart][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < kPart; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
#pragma unroll
        for (int ci = 0; ci < kOwn; ++ci)
          chunk_wide_accumulate<T, DV, MT, kPart>(part, s[ci], s_v,
                                                  SPLIT ? warp : ci, n0, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < kPart; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n0 + n][e] += part[m][n][e];
      }
    } else if constexpr (WG) {
      // 16 keys a product: two groups of 8 swizzled rows, 1024 bytes each
      wgmma_fence();
#pragma unroll
      for (int ci = 0; ci < kChunks; ++ci) {
        const uint32_t a[4] = {pack_bf16(s[ci][0][0][0], s[ci][0][0][1]),
                               pack_bf16(s[ci][0][0][2], s[ci][0][0][3]),
                               pack_bf16(s[ci][0][1][0], s[ci][0][1][1]),
                               pack_bf16(s[ci][0][1][2], s[ci][0][1][3])};
        wgmma_m64n64k16<true>(
            acc[0], a,
            wgmma_desc(reinterpret_cast<const unsigned char*>(s_v) + 2048 * ci,
                       16, 1024, 1),
            true);
      }
      wgmma_commit_and_wait();
    } else {
#pragma unroll
      for (int ci = 0; ci < kOwn; ++ci)
        chunk_wide_accumulate<T, DV, MT, kCols>(acc, s[ci], s_v,
                                                SPLIT ? warp : ci, 0, lane);
    }
  }

  if constexpr (SPLIT) {
    __syncthreads();  // every warp is done with the last tile
    // every warp's triple for the 16 rows, then 128 threads merge them
    constexpr int kRow = DV + 2;  // accumulator, max, sum
    static_assert(NW * 16 * kRow * 4 <= kStages * kStageBytes, "fits");
    float* mem = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = mem + (warp * 16 + 8 * h + g) * kRow;
      const float l = quad_sum(sum[0][h]);
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        dst[8 * n + 2 * t] = acc[0][n][2 * h];
        dst[8 * n + 2 * t + 1] = acc[0][n][2 * h + 1];
      }
      if (t == 0) {
        dst[DV] = mx[0][h];
        dst[DV + 1] = l;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 16 * DV; i += kThreads) {
      const int r = i / DV, c = i % DV;
      if (row0 + r >= N) continue;
      float m_all = -CUDART_INF_F;  // finite: some warp saw key 0
#pragma unroll
      for (int w = 0; w < NW; ++w)
        m_all = fmaxf(m_all, mem[(w * 16 + r) * kRow + DV]);
      float l = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float* src = mem + (w * 16 + r) * kRow;
        const float wgt = exp2_approx((src[DV] - m_all) * kLog2e);
        l = fmaf(src[DV + 1], wgt, l);
        o = fmaf(src[c], wgt, o);
      }
      out[(b * N + row0 + r) * DV + c] = sg::from_f32<T>(o / l);
      if (lse != nullptr && c == 0) lse[b * N + row0 + r] = m_all + logf(l);
    }
    return;
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * m + 8 * h + g;
      const float l = quad_sum(sum[m][h]);
      if (row >= N) continue;
      const float inv = 1.f / l;
      T* o = out + (b * N + row) * DV + 2 * t;
#pragma unroll
      for (int n = 0; n < kCols; ++n)
        store_pair(o + 8 * n, acc[m][n][2 * h] * inv,
                   acc[m][n][2 * h + 1] * inv);
      if (lse != nullptr && t == 0) lse[b * N + row] = mx[m][h] + logf(l);
    }
}

template <typename T, int DQK, int DV, int MT, int NW, Mode MODE>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int N, cudaStream_t stream) {
  using L = Layout<T, DV, MODE == kGroup>;
  // the warpgroup layout adds its tile of zeros and room to align the ring
  constexpr int kBytes = kStages * (L::kSmallBytes + L::kWideBytes) +
                         (MODE == kGroup ? L::kSmallBytes + 1024 : 0);
  constexpr int kBlockRows = MODE == kSplit ? 16 : 16 * MT * NW;
  const dim3 grid((N + kBlockRows - 1) / kBlockRows, B);
  const auto kernel = position_attention_kernel<T, DQK, DV, MT, NW, MODE>;
  const cudaError_t allowed = allow_shared_bytes(kernel, kBytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  kernel<<<grid, NW * 32, kBytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), lse, N);
  return static_cast<int>(cudaGetLastError());
}

// The largest block that still gives every multiprocessor two blocks, else
// the split keys.
template <typename T, int DQK, int DV>
int dispatch_rows(const void* q, const void* k, const void* v, void* out,
                  float* lse, int B, int N, cudaStream_t st) {
  if constexpr (kIsF32<T>) {
    // two row tiles a warp share each B fragment's split
    if (fills_card(B, N, 128))
      return launch<T, DQK, DV, 2, 4, kRows>(q, k, v, out, lse, B, N, st);
  }
  if (fills_card(B, N, 64)) {
    if constexpr (!kIsF32<T> && DQK == 8 && DV == 64)
      return launch<T, DQK, DV, 1, 4, kGroup>(q, k, v, out, lse, B, N, st);
    else
      return launch<T, DQK, DV, 1, 4, kRows>(q, k, v, out, lse, B, N, st);
  }
  if (fills_card(B, N, 32))
    return launch<T, DQK, DV, 1, 2, kRows>(q, k, v, out, lse, B, N, st);
  return launch<T, DQK, DV, 1, 4, kSplit>(q, k, v, out, lse, B, N, st);
}

template <typename T>
int dispatch_width(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int N, int dqk, int dv,
                   cudaStream_t st) {
  // SGAM's widths are d_v = C and d_qk = C / 8.
  if (dqk == 8 && dv == 64)
    return dispatch_rows<T, 8, 64>(q, k, v, out, lse, B, N, st);
  if (dqk == 4 && dv == 32)
    return dispatch_rows<T, 4, 32>(q, k, v, out, lse, B, N, st);
  if (dqk == 2 && dv == 16)
    return dispatch_rows<T, 2, 16>(q, k, v, out, lse, B, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k: (B, N, dqk); v, out: (B, N, dv); all contiguous, of one type and
// 16-byte aligned.  lse: (B, N) float32, or null when no backward will need
// it.
extern "C" int sg_position_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int B, int N, int dqk, int dv, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lsef = static_cast<float*>(lse);
  if (dtype == sg::kFloat32)
    return dispatch_width<float>(q, k, v, out, lsef, B, N, dqk, dv, st);
  if (dtype == sg::kBFloat16)
    return dispatch_width<__nv_bfloat16>(q, k, v, out, lsef, B, N, dqk, dv,
                                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}
