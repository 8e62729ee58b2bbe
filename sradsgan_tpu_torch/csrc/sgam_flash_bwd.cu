// K5: SGAM position attention backward, for out = softmax(q k^T) v unscaled.
//
// Replaces the Pallas TPU flash-attention backward (its dkv and dq
// pallas_calls, behind the custom VJP of
// jax.experimental.pallas.ops.tpu.flash_attention) that
// sradsgan_tpu/ops/sgam_flash.py:flash_position_attention reaches.  As
// there, the (N, N) probabilities are recomputed tile by tile from q, k and
// the forward's row log-sum-exp (K3 writes it), and never reach device
// memory:
//   P_ij  = exp(q_i . k_j - lse_i)
//   dS_ij = P_ij (dO_i . v_j - delta_i),  delta_i = dO_i . O_i
//   dq_i  = sum_j dS_ij k_j,  dk_j = sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
// with no 1/sqrt(d) scale anywhere.
//
// Bound: operations.  Per query-key pair the function has 2 d_qk + 2 d_v +
// d_qk = 152 multiply-adds and one exponential (the two passes below spend
// 224 and two), against 2 * N * 288 elements of input per image.  On the
// CUDA cores the passes took ten times the bound: four threads shared a row
// and each recomputed its energy and exp, with two shuffles per key.  What
// this kernel does about it (building blocks in sgam_mma.cuh, shared with
// K3):
//   - three launches on one stream, no atomics, so two runs on the same
//     inputs give the same bits: a prologue that forms delta in float32
//     (one warp a row); the dq pass, where a warp owns 16 queries (q and dO
//     as register A fragments) and streams K/V tiles; the dk/dv pass, where
//     a warp owns 16 keys (k and v in registers) and streams q/dO tiles with
//     their lse and delta.  The passes are one template: rows x streamed
//     tiles, S = x8 . y8^T, dP = x64 . y64^T, then dS . y8 (and P . y64 in
//     the key pass);
//   - every product runs on the tensor cores.  bf16 at the flagship widths
//     (d_qk 8, d_v 64) with enough rows to fill the card: the block's four
//     warps are one warpgroup and issue the tile's three 64-wide products
//     as wgmma (m64n64k16) on the whole tile: S (its depth padded to 16 by
//     a tile of zeros), dP with the contraction along the tile's swizzled
//     128-byte rows, and P^T . dO over the same tile's rows; P and dS are
//     rounded to bf16 in registers, and the 8-wide dS products stay with
//     mma.sync, which runs while the last wgmma is in flight.  Other bf16
//     cases: mma.sync m16n8k8/k16, 16 streamed rows at a time.  float32:
//     the error-compensated three-product TF32 of sgam_mma.cuh with
//     mma.sync, 16 streamed rows at a time, so a warp holds two 16 x 8 tiles
//     of S and dP rather than a whole tile's and keeps its split dO (or v)
//     fragments in registers;
//   - a tile's products go into zeroed partials that a rounded add folds
//     into the sums (the tensor cores truncate their accumulator); only the
//     warpgroup's dv sums in place, far inside the bf16 tolerance;
//   - tiles of 64 rows in a three-stage cp.async ring, one barrier a tile;
//     rows past N are zero-filled and their P set to 0 in registers.
// What holds it now: as K3, the elementwise stream between the products
// (exp, the dS arithmetic, the packs), and in float32 the splits.
#include "sgam_mma.cuh"

namespace {

using namespace sg::attn;

// delta[r] = sum_c out[r, c] * dout[r, c] in float32; a warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
    attention_delta_kernel(const T* __restrict__ out,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, long rows, int dv) {
  const long r = blockIdx.x * 8L + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < dv; c += 32)
    s += sg::to_f32(out[r * dv + c]) * sg::to_f32(dout[r * dv + c]);
  s = sg::warp_sum(s);
  if (lane == 0) delta[r] = s;
}

// Bytes of one ring stage; the warpgroup layout keeps stages on 1024-byte
// lines.
template <typename L, bool BY_KEYS>
constexpr int kRawStageBytes =
    L::kSmallBytes + L::kWideBytes + (BY_KEYS ? L::kStatBytes : 0);
template <typename L, bool BY_KEYS, bool WG>
constexpr int kStageBytesOf =
    WG ? (kRawStageBytes<L, BY_KEYS> + 1023) / 1024 * 1024
       : kRawStageBytes<L, BY_KEYS>;

// BY_KEYS = false, the dq pass: x8 = q, x64 = dO, y8 = k, y64 = v, out8 = dq.
// BY_KEYS = true, the dk/dv pass: x8 = k, x64 = v, y8 = q, y64 = dO,
// out8 = dk, out64 = dv.  lse and delta belong to the queries: to the rows in
// the first, to the streamed columns in the second.  WG (bf16, d_v = 64, four
// warps): the warps issue the three 64-wide products of a tile together as
// one warpgroup (wgmma) on the whole tile; the 8-wide dS products stay with
// mma.sync and run while the last wgmma is in flight.
template <typename T, int DQK, int DV, int NW, bool BY_KEYS, bool WG>
__global__ void __launch_bounds__(NW * 32, WG ? 3 : 1)
    attention_bwd_kernel(const T* __restrict__ x8, const T* __restrict__ x64,
                         const T* __restrict__ y8, const T* __restrict__ y64,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ out8, T* __restrict__ out64, int N) {
  using L = Layout<T, DV, WG>;
  static_assert(!WG || NW == 4, "a warpgroup");
  constexpr int kThreads = NW * 32;
  constexpr int kStageBytes = kStageBytesOf<L, BY_KEYS, WG>;
  extern __shared__ __align__(16) unsigned char smem_base[];
  // the swizzled tiles sit on 1024-byte lines (the launch adds the room),
  // and a tile of zeros follows the ring: the upper half of the energies'
  // contraction, 16 deep for wgmma
  unsigned char* smem =
      WG ? smem_base + ((1024 - (smem_addr(smem_base) & 1023)) & 1023)
         : smem_base;
  const unsigned char* zeros = smem + kStages * kStageBytes;

  const long b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x * NW + warp) * 16;
  const T* y8b = y8 + b * N * DQK;
  const T* y64b = y64 + b * N * DV;
  const float* lb = lse + b * N;
  const float* db = delta + b * N;

  const int tiles = (N + kTile - 1) / kTile;
  TileCopier<T, DQK, DV, kThreads, WG> copier(y8b, y64b);
  // copies of tile `it`, or an empty group past the last tile
  auto stage = [&](int it) {
    unsigned char* dst = smem + (it % kStages) * kStageBytes;
    const int j0 = it * kTile;
    if (it < tiles) copier.issue(dst, j0, N);
    if (BY_KEYS && it < tiles) {
      float* stats =
          reinterpret_cast<float*>(dst + L::kSmallBytes + L::kWideBytes);
      for (unsigned i = threadIdx.x; i < 2 * kTile; i += kThreads) {
        const int r = i % kTile;
        const bool in = j0 + r < N;
        const float* src = (i < kTile ? lb : db) + (in ? j0 + r : 0);
        cp_async<4>(stats + i, src, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  zero_smem<kThreads>(smem, kStages * kStageBytes + (WG ? L::kSmallBytes : 0));
  __syncthreads();
  stage(0);
  stage(1);

  const SmallA<T> xa8 = load_small_a<T, DQK>(x8 + b * N * DQK, row0, N, lane);
  const WideA<T, DV> xa64 = load_wide_a<T, DV>(x64 + b * N * DV, row0, N, lane);
  float row_shift[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if (!BY_KEYS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h + g;
      if (row < N) {
        row_shift[h] = -lb[row] * kLog2e;
        row_delta[h] = db[row];
      }
    }
  }

  float acc8[4] = {0.f, 0.f, 0.f, 0.f};
  float acc64[1][DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc64[0][n][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int j0 = it * kTile;
    ring_wait<WG>();
    stage(it + 2);
    const unsigned char* cur = smem + (it % kStages) * kStageBytes;
    const T* s_y8 = reinterpret_cast<const T*>(cur);
    const T* s_y64 = reinterpret_cast<const T*>(cur + L::kSmallBytes);
    const float* s_lse =
        reinterpret_cast<const float*>(cur + L::kSmallBytes + L::kWideBytes);
    const float* s_delta = s_lse + kTile;

    // a tile's products go into zeroed partials: the tensor cores truncate
    // their accumulator, and a chain as long as N would bias the sums
    float part8[4] = {0.f, 0.f, 0.f, 0.f};
    float part64[1][DV / 8][4];
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part64[0][n][e] = 0.f;
    if constexpr (WG) {
      const unsigned char* wide = reinterpret_cast<const unsigned char*>(s_y64);
      float p[8][4], ds[8][4];  // the whole tile: 64 x 64 pairs
      const uint32_t a8[4] = {xa8.a[0], xa8.a[1], 0u, 0u};
      wgmma_fence();
      wgmma_m64n64k16<false>(
          p, a8, wgmma_desc(s_y8, static_cast<int>(zeros - cur), 128, 0),
          false);
      // dP: the contraction runs along the tile's swizzled 128-byte rows, 32
      // bytes a step
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_m64n64k16<false>(ds, xa64.a[kk],
                               wgmma_desc(wide + 32 * kk, 16, 1024, 1),
                               kk != 0);
      wgmma_commit_and_wait();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const float shift =
              BY_KEYS ? -s_lse[col] * kLog2e : row_shift[e >> 1];
          const float del = BY_KEYS ? s_delta[col] : row_delta[e >> 1];
          const float pe = j0 + col < N
                               ? exp2_approx(fmaf(p[j][e], kLog2e, shift))
                               : 0.f;
          p[j][e] = pe;
          ds[j][e] = pe * (ds[j][e] - del);
        }
      if (BY_KEYS) {  // dv += P^T . dO, over the tile's rows, 16 a step
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const uint32_t a[4] = {pack_bf16(p[2 * c][0], p[2 * c][1]),
                                 pack_bf16(p[2 * c][2], p[2 * c][3]),
                                 pack_bf16(p[2 * c + 1][0], p[2 * c + 1][1]),
                                 pack_bf16(p[2 * c + 1][2], p[2 * c + 1][3])};
          wgmma_m64n64k16<true>(acc64[0], a,
                                wgmma_desc(wide + 2048 * c, 16, 1024, 1), true);
        }
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float d2[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d2[0][e] = ds[2 * c][e];
          d2[1][e] = ds[2 * c + 1][e];
        }
        chunk_small_accumulate<T>(part8, d2, s_y8, c, lane);
      }
      if (BY_KEYS) wgmma_commit_and_wait();
    } else {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float p[1][2][4], ds[2][4];
      chunk_small_product<T>(p[0], xa8, s_y8, c, lane);
      chunk_wide_product<T, DV>(ds, xa64, s_y64, c, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * c + 8 * i + 2 * t + (e & 1);
          const float shift =
              BY_KEYS ? -s_lse[col] * kLog2e : row_shift[e >> 1];
          const float del = BY_KEYS ? s_delta[col] : row_delta[e >> 1];
          const float pe =
              j0 + col < N
                  ? exp2_approx(fmaf(p[0][i][e], kLog2e, shift))
                  : 0.f;  // a streamed row past N weighs nothing
          p[0][i][e] = pe;
          ds[i][e] = pe * (ds[i][e] - del);
        }
      if (BY_KEYS)
        chunk_wide_accumulate<T, DV, 1, DV / 8>(part64, p, s_y64, c, 0, lane);
      chunk_small_accumulate<T>(part8, ds, s_y8, c, lane);
    }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc8[e] += part8[e];
    if (BY_KEYS) {
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc64[0][n][e] += part64[0][n][e];
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h + g;
    if (row >= N) continue;
    if (2 * t < DQK)
      store_pair(out8 + (b * N + row) * DQK + 2 * t, acc8[2 * h],
                 acc8[2 * h + 1]);
    if (BY_KEYS) {
      T* o = out64 + (b * N + row) * DV + 2 * t;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        store_pair(o + 8 * n, acc64[0][n][2 * h], acc64[0][n][2 * h + 1]);
    }
  }
}

template <typename T, int DQK, int DV, int NW, bool WG = false>
int launch(const T* q, const T* k, const T* v, const T* dout,
           const float* lse, const float* delta, T* dq, T* dk, T* dv, int B,
           int N, cudaStream_t stream) {
  using L = Layout<T, DV, WG>;
  // the warpgroup layout adds its tile of zeros and room to align the ring
  constexpr int kExtra = WG ? L::kSmallBytes + 1024 : 0;
  constexpr int kBytes = kStages * kStageBytesOf<L, false, WG> + kExtra;
  constexpr int kKeyBytes = kStages * kStageBytesOf<L, true, WG> + kExtra;
  const dim3 grid((N + 16 * NW - 1) / (16 * NW), B);
  const auto by_queries = attention_bwd_kernel<T, DQK, DV, NW, false, WG>;
  const auto by_keys = attention_bwd_kernel<T, DQK, DV, NW, true, WG>;
  cudaError_t allowed = allow_shared_bytes(by_queries, kBytes);
  if (allowed == cudaSuccess) allowed = allow_shared_bytes(by_keys, kKeyBytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  by_queries<<<grid, NW * 32, kBytes, stream>>>(q, dout, k, v, lse, delta, dq,
                                                nullptr, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  by_keys<<<grid, NW * 32, kKeyBytes, stream>>>(k, v, q, dout, lse, delta, dk,
                                                dv, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DQK, int DV>
int dispatch_rows(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const float* lse, float* delta, void* dq,
                  void* dk, void* dv, int B, int N, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  const long rows = static_cast<long>(B) * N;
  attention_delta_kernel<T>
      <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
          static_cast<const T*>(out), dot, delta, rows, DV);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fills_card(B, N, 64))
    return launch<T, DQK, DV, 4, !kIsF32<T> && DQK == 8 && DV == 64>(
        qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, B, N, st);
  if (fills_card(B, N, 32))
    return launch<T, DQK, DV, 2>(qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, B,
                                 N, st);
  return launch<T, DQK, DV, 1>(qt, kt, vt, dot, lse, delta, dqt, dkt, dvt, B,
                               N, st);
}

template <typename T>
int dispatch_width(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int N,
                   int dqk, int dvw, cudaStream_t st) {
  // The widths K3 is built for: d_v = C and d_qk = C / 8.
  if (dqk == 8 && dvw == 64)
    return dispatch_rows<T, 8, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                   B, N, st);
  if (dqk == 4 && dvw == 32)
    return dispatch_rows<T, 4, 32>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                   B, N, st);
  if (dqk == 2 && dvw == 16)
    return dispatch_rows<T, 2, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                   B, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, dq, dk: (B, N, dqk); v, out, dout, dv: (B, N, dv), all contiguous, of
// one type and 16-byte aligned; lse: (B, N) float32 from the forward; delta:
// (B, N) float32 scratch, which the prologue fills.
extern "C" int sg_position_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* out,
                                         const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk,
                                         void* dv, int B, int N, int dqk,
                                         int dvw, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == sg::kFloat32)
    return dispatch_width<float>(q, k, v, out, dout, l, d, dq, dk, dv, B, N,
                                 dqk, dvw, st);
  if (dtype == sg::kBFloat16)
    return dispatch_width<__nv_bfloat16>(q, k, v, out, dout, l, d, dq, dk, dv,
                                         B, N, dqk, dvw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
