// K3: SGAM position attention forward, out = softmax(q k^T) v, unscaled.
//
// Replaces the Pallas TPU flash-attention forward that
// sradsgan_tpu/ops/sgam_flash.py:flash_position_attention calls.  As there,
// the (N, N) energy never reaches device memory: each query keeps a float32
// running max, running sum and output accumulator while the keys stream by.
// The softmax has no 1/sqrt(d) scale (the reference SGAM).
//
// Bound: arithmetic.  Per query-key pair it costs d_qk FMAs for the energy,
// one exp and d_v FMAs for P.V, about 2 * N^2 * 72 FLOPs per image at the
// flagship's d_qk = 8, d_v = 64 against 2 * N * 80 elements of input.  The
// contraction depths (8 and 64) are too shallow to be worth tensor-core
// tiles in a first kernel, so this one runs on the CUDA cores:
//   - kSlices threads share one query row, each owning d_v / kSlices of its
//     output channels; each computes the row's energies itself (d_qk FMAs
//     per key, cheap beside its share of P.V), which keeps a thread's state
//     (query, a tile of energies, its accumulator) in registers and gives
//     the card four times as many warps as one thread per query would;
//   - a block of kQueries rows walks the keys in tiles of kKeys, which the
//     block stages (converted to float32) in shared memory; the threads of a
//     warp read the same key row, so the reads broadcast, and value rows
//     are read as float4;
//   - per tile the running max is raised once, P.V is summed into a
//     tile-local partial, and the accumulator is rescaled and the partial
//     added once (online softmax).  Summing by tiles keeps float32 rounding
//     to about N / kKeys + kKeys additions per output instead of N;
//   - keys past N get energy -inf, so a ragged last tile needs no padding of
//     the inputs (the TPU path padded N to its 128/512 tiles and masked with
//     a -1e4 bias column instead).
// When a backward will follow, the kernel also writes each row's float32
// log-sum-exp, lse = m + log(l), from which the backward kernels
// (sgam_flash_bwd.cu) recompute the softmax; under no-grad the pointer is
// null and nothing more is stored.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kQueries = 64;
constexpr int kSlices = 4;
constexpr int kThreads = kQueries * kSlices;
constexpr int kKeys = 32;

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    position_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              float* __restrict__ lse, int N) {
  constexpr int DS = DV / kSlices;  // output channels per thread
  static_assert(DS % 4 == 0, "value slices are read as float4");
  __shared__ float s_k[kKeys][DQK];
  __shared__ __align__(16) float s_v[kKeys][DV];

  const long b = blockIdx.y;
  const int slice = threadIdx.x % kSlices;
  const int i = blockIdx.x * kQueries + threadIdx.x / kSlices;
  const bool valid = i < N;
  const T* kb = k + b * N * DQK;
  const T* vb = v + b * N * DV;

  float qr[DQK];
#pragma unroll
  for (int d = 0; d < DQK; ++d)
    qr[d] = valid ? sg::to_f32(q[(b * N + i) * DQK + d]) : 0.f;

  float acc[DS];
#pragma unroll
  for (int c = 0; c < DS; ++c) acc[c] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int j0 = 0; j0 < N; j0 += kKeys) {
    const int nk = min(kKeys, N - j0);
    __syncthreads();  // the previous tile has been consumed
    for (int t = threadIdx.x; t < kKeys * DQK; t += kThreads)
      s_k[t / DQK][t % DQK] =
          t / DQK < nk ? sg::to_f32(kb[static_cast<long>(j0) * DQK + t]) : 0.f;
    for (int t = threadIdx.x; t < kKeys * DV; t += kThreads)
      s_v[t / DV][t % DV] =
          t / DV < nk ? sg::to_f32(vb[static_cast<long>(j0) * DV + t]) : 0.f;
    __syncthreads();

    float e[kKeys];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DQK; ++d) s += qr[d] * s_k[jj][d];
      e[jj] = jj < nk ? s : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, e[jj]);
    }
    const float m_new = fmaxf(m, tile_max);  // finite: the tile has a key

    float part[DS];
#pragma unroll
    for (int c = 0; c < DS; ++c) part[c] = 0.f;
    float l_part = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const float p = expf(e[jj] - m_new);  // 0 for masked keys
      l_part += p;
      const float4* vr = reinterpret_cast<const float4*>(&s_v[jj][slice * DS]);
#pragma unroll
      for (int c4 = 0; c4 < DS / 4; ++c4) {
        const float4 vv = vr[c4];
        part[4 * c4 + 0] += p * vv.x;
        part[4 * c4 + 1] += p * vv.y;
        part[4 * c4 + 2] += p * vv.z;
        part[4 * c4 + 3] += p * vv.w;
      }
    }
    const float corr = expf(m - m_new);  // 0 on the first tile
    l = fmaf(l, corr, l_part);
#pragma unroll
    for (int c = 0; c < DS; ++c) acc[c] = fmaf(acc[c], corr, part[c]);
    m = m_new;
  }

  if (!valid) return;
  const float inv = 1.f / l;
  T* o = out + (b * N + i) * DV + slice * DS;
#pragma unroll
  for (int c = 0; c < DS; ++c) o[c] = sg::from_f32<T>(acc[c] * inv);
  if (lse != nullptr && slice == 0) lse[b * N + i] = m + logf(l);
}

template <typename T, int DQK, int DV>
void launch(const void* q, const void* k, const void* v, void* out,
            float* lse, int B, int N, cudaStream_t stream) {
  const dim3 grid((N + kQueries - 1) / kQueries, B);
  position_attention_kernel<T, DQK, DV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, N);
}

template <typename T>
int dispatch_width(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int N, int dqk, int dv,
                   cudaStream_t stream) {
  // SGAM's widths are d_v = C and d_qk = C / 8.
  if (dqk == 8 && dv == 64) {
    launch<T, 8, 64>(q, k, v, out, lse, B, N, stream);
  } else if (dqk == 4 && dv == 32) {
    launch<T, 4, 32>(q, k, v, out, lse, B, N, stream);
  } else if (dqk == 2 && dv == 16) {
    launch<T, 2, 16>(q, k, v, out, lse, B, N, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k: (B, N, dqk); v, out: (B, N, dv); all contiguous and of one type.
// lse: (B, N) float32, or null when no backward will need it.
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
