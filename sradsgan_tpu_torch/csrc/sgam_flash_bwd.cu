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
//   dS_ij = P_ij (dO_i . v_j - delta_i),  delta_i = dO_i . O_i (given)
//   dq_i  = sum_j dS_ij k_j,  dk_j = sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
// with no 1/sqrt(d) scale anywhere.
//
// Bound: arithmetic, as K3.  Per query-key pair the two passes below spend
// about 2 * d_qk + 3 * d_v FMAs and two exps against 2 * N * (2 d_qk +
// 2 d_v) elements of input.  Two launches, no atomics:
//   - dq pass: a block owns kRows queries and streams the keys in tiles of
//     kTile, staged (as float32) in shared memory; kSlices threads share a
//     query, each holding d_v / kSlices channels of dO_i, so dO_i . v_j is
//     a partial dot product finished by two shuffles among the four lanes;
//   - dkv pass: a block owns kRows keys and streams the queries (q, dO, lse,
//     delta) in tiles; the kSlices threads of a key each own d_v / kSlices
//     channels of v_j and dv_j.
// Each thread sums a tile into a partial before adding it to its
// accumulator (as K3 does), which keeps float32 rounding to about
// N / kTile + kTile additions per output.  Keys or queries past N are
// masked to P = 0 inside the kernel, so ragged N needs no padding.
#include "common.cuh"

namespace {

constexpr int kRows = 64;
constexpr int kSlices = 4;
constexpr int kThreads = kRows * kSlices;
constexpr int kTile = 32;

// Sum over the kSlices consecutive lanes that share a row.
__device__ __forceinline__ float slice_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int N) {
  constexpr int DS = DV / kSlices;
  static_assert(kSlices == 4, "slice_sum reduces over four lanes");
  __shared__ float s_k[kTile][DQK];
  __shared__ float s_v[kTile][DV];

  const long b = blockIdx.y;
  const int slice = threadIdx.x % kSlices;
  const int i = blockIdx.x * kRows + threadIdx.x / kSlices;
  const bool valid = i < N;
  const long row = b * N + i;
  const T* kb = k + b * N * DQK;
  const T* vb = v + b * N * DV;

  float qr[DQK];
  float dor[DS];
#pragma unroll
  for (int d = 0; d < DQK; ++d)
    qr[d] = valid ? sg::to_f32(q[row * DQK + d]) : 0.f;
#pragma unroll
  for (int c = 0; c < DS; ++c)
    dor[c] = valid ? sg::to_f32(dout[row * DV + slice * DS + c]) : 0.f;
  const float lse_i = valid ? lse[row] : 0.f;
  const float delta_i = valid ? delta[row] : 0.f;

  float acc[DQK];
#pragma unroll
  for (int d = 0; d < DQK; ++d) acc[d] = 0.f;

  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int nk = min(kTile, N - j0);
    __syncthreads();  // the previous tile has been consumed
    for (int t = threadIdx.x; t < kTile * DQK; t += kThreads)
      s_k[t / DQK][t % DQK] =
          t / DQK < nk ? sg::to_f32(kb[static_cast<long>(j0) * DQK + t]) : 0.f;
    for (int t = threadIdx.x; t < kTile * DV; t += kThreads)
      s_v[t / DV][t % DV] =
          t / DV < nk ? sg::to_f32(vb[static_cast<long>(j0) * DV + t]) : 0.f;
    __syncthreads();

    float part[DQK];
#pragma unroll
    for (int d = 0; d < DQK; ++d) part[d] = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float e = 0.f;
#pragma unroll
      for (int d = 0; d < DQK; ++d) e += qr[d] * s_k[jj][d];
      const float p = (valid && jj < nk) ? expf(e - lse_i) : 0.f;
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < DS; ++c) dp += dor[c] * s_v[jj][slice * DS + c];
      dp = slice_sum(dp);
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int d = 0; d < DQK; ++d) part[d] += ds * s_k[jj][d];
    }
#pragma unroll
    for (int d = 0; d < DQK; ++d) acc[d] += part[d];
  }

  if (!valid || slice != 0) return;
#pragma unroll
  for (int d = 0; d < DQK; ++d) dq[row * DQK + d] = sg::from_f32<T>(acc[d]);
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int N) {
  constexpr int DS = DV / kSlices;
  static_assert(kSlices == 4, "slice_sum reduces over four lanes");
  __shared__ float s_q[kTile][DQK];
  __shared__ float s_do[kTile][DV];
  __shared__ float s_lse[kTile];
  __shared__ float s_delta[kTile];

  const long b = blockIdx.y;
  const int slice = threadIdx.x % kSlices;
  const int j = blockIdx.x * kRows + threadIdx.x / kSlices;
  const bool valid = j < N;
  const long row = b * N + j;
  const T* qb = q + b * N * DQK;
  const T* dob = dout + b * N * DV;
  const float* lb = lse + b * N;
  const float* db = delta + b * N;

  float kr[DQK];
  float vr[DS];
#pragma unroll
  for (int d = 0; d < DQK; ++d)
    kr[d] = valid ? sg::to_f32(k[row * DQK + d]) : 0.f;
#pragma unroll
  for (int c = 0; c < DS; ++c)
    vr[c] = valid ? sg::to_f32(v[row * DV + slice * DS + c]) : 0.f;

  float dk_acc[DQK];
  float dv_acc[DS];
#pragma unroll
  for (int d = 0; d < DQK; ++d) dk_acc[d] = 0.f;
#pragma unroll
  for (int c = 0; c < DS; ++c) dv_acc[c] = 0.f;

  for (int i0 = 0; i0 < N; i0 += kTile) {
    const int nq = min(kTile, N - i0);
    __syncthreads();  // the previous tile has been consumed
    for (int t = threadIdx.x; t < kTile * DQK; t += kThreads)
      s_q[t / DQK][t % DQK] =
          t / DQK < nq ? sg::to_f32(qb[static_cast<long>(i0) * DQK + t]) : 0.f;
    for (int t = threadIdx.x; t < kTile * DV; t += kThreads)
      s_do[t / DV][t % DV] =
          t / DV < nq ? sg::to_f32(dob[static_cast<long>(i0) * DV + t]) : 0.f;
    if (threadIdx.x < kTile) {
      const bool in = threadIdx.x < nq;
      s_lse[threadIdx.x] = in ? lb[i0 + threadIdx.x] : 0.f;
      s_delta[threadIdx.x] = in ? db[i0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    float pk[DQK];
    float pv[DS];
#pragma unroll
    for (int d = 0; d < DQK; ++d) pk[d] = 0.f;
#pragma unroll
    for (int c = 0; c < DS; ++c) pv[c] = 0.f;
#pragma unroll 4
    for (int ii = 0; ii < kTile; ++ii) {
      float e = 0.f;
#pragma unroll
      for (int d = 0; d < DQK; ++d) e += s_q[ii][d] * kr[d];
      const float p = ii < nq ? expf(e - s_lse[ii]) : 0.f;
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < DS; ++c) dp += s_do[ii][slice * DS + c] * vr[c];
      dp = slice_sum(dp);
      const float ds = p * (dp - s_delta[ii]);
#pragma unroll
      for (int c = 0; c < DS; ++c) pv[c] += p * s_do[ii][slice * DS + c];
#pragma unroll
      for (int d = 0; d < DQK; ++d) pk[d] += ds * s_q[ii][d];
    }
#pragma unroll
    for (int d = 0; d < DQK; ++d) dk_acc[d] += pk[d];
#pragma unroll
    for (int c = 0; c < DS; ++c) dv_acc[c] += pv[c];
  }

  if (!valid) return;
#pragma unroll
  for (int c = 0; c < DS; ++c)
    dv[row * DV + slice * DS + c] = sg::from_f32<T>(dv_acc[c]);
  if (slice != 0) return;
#pragma unroll
  for (int d = 0; d < DQK; ++d)
    dk[row * DQK + d] = sg::from_f32<T>(dk_acc[d]);
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int B, int N, cudaStream_t stream) {
  const dim3 grid((N + kRows - 1) / kRows, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  attention_bwd_dq_kernel<T, DQK, DV><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<T, DQK, DV><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_width(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int B, int N, int dqk,
                   int dvw, cudaStream_t st) {
  // The widths K3 is built for: d_v = C and d_qk = C / 8.
  if (dqk == 8 && dvw == 64)
    return launch<T, 8, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, N, st);
  if (dqk == 4 && dvw == 32)
    return launch<T, 4, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, N, st);
  if (dqk == 2 && dvw == 16)
    return launch<T, 2, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, dq, dk: (B, N, dqk); v, dout, dv: (B, N, dv), all contiguous and of
// one type; lse, delta: (B, N) float32.
extern "C" int sg_position_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, void* dk, void* dv, int B,
                                         int N, int dqk, int dvw, int dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  if (dtype == sg::kFloat32)
    return dispatch_width<float>(q, k, v, dout, l, d, dq, dk, dv, B, N, dqk,
                                 dvw, st);
  if (dtype == sg::kBFloat16)
    return dispatch_width<__nv_bfloat16>(q, k, v, dout, l, d, dq, dk, dv, B,
                                         N, dqk, dvw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
