// K4: SLAM spatial-gate backward on NCHW, for out = x * gate,
//   gate = sigmoid(conv7x7([mean_c x; max_c x], w)), zero-padded planes.
//
// Replaces sradsgan_tpu/ops/pallas/slam.py:_bwd_pallas (kernel _bwd_kernel).
// Given x and the output cotangent g it computes
//   ds    = sum_c(g * x) * gate * (1 - gate)                    (per pixel)
//   dmean, dmax = the transposed 7x7 stencil of ds with w's two planes
//   dx    = g * gate + dmean / C + (dmax / ties) * [x == max_c x]
// with ties = max(count of channels equal to the max, 1), and writes the
// ds, mean and max planes, from which the caller contracts dw
// (slam.py:_dw_contraction, outside the kernel as there).  All gate math is
// float32.  Ties are recounted from x here, never compared against a saved
// max (slam.py:15-20).
//
// Bound: device-memory bytes, as K2: x and g are read twice and dx written
// once; the stencils are a few hundred FLOPs per position.  The TPU kernel
// held a whole image in VMEM.  Here a 16x16 output tile needs ds on a
// 3-pixel halo, hence the gate there, hence the statistics on a 6-pixel
// halo (28^2 positions of C channels for 16^2 outputs).  Rather than have
// every block recompute that wider halo (three reads of x per output for
// the statistics alone), the work is split in two launches over K2's
// tiling (16x16 tile, 3-pixel halo, statistics in shared memory):
//   1. planes: statistics on the tile's halo, the stencil and the gate for
//      each pixel of the tile, then sum_c(g * x) and ds; writes the ds,
//      gate, mean and max planes (float32, (B, H, W) each);
//   2. dx: ds on the tile's 3-pixel halo from the plane (zeros outside the
//      image), the transposed stencil for dmean and dmax, then per pixel
//      one pass over the channels for the max and its tie count and one
//      for dx.
// The planes are 1 / C of x's size, so the second launch reads them from
// L2 at little cost.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kK = 7;
constexpr int kPad = kK / 2;
constexpr int kTile = 16;
constexpr int kHalo = kTile + 2 * kPad;
constexpr int kThreads = kTile * kTile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gate_bwd_planes_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ w, float* __restrict__ ds,
                           float* __restrict__ gate_out,
                           float* __restrict__ mean_out,
                           float* __restrict__ max_out, int C, int H, int W) {
  __shared__ float s_mean[kHalo][kHalo];
  __shared__ float s_max[kHalo][kHalo];
  __shared__ float s_w[2 * kK * kK];

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const long plane = static_cast<long>(H) * W;
  const long base = static_cast<long>(blockIdx.z) * C * plane;
  const T* xb = x + base;
  const T* gb = g + base;

  if (tid < 2 * kK * kK) s_w[tid] = w[tid];  // OIHW (1, 2, 7, 7)

  for (int p = tid; p < kHalo * kHalo; p += kThreads) {
    const int hy = p / kHalo;
    const int hx = p - hy * kHalo;
    const int yy = y0 + hy - kPad;
    const int xx = x0 + hx - kPad;
    float mean = 0.f;
    float mx = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const T* px = xb + static_cast<long>(yy) * W + xx;
      float s = 0.f;
      float m = -CUDART_INF_F;
#pragma unroll 8
      for (int c = 0; c < C; ++c) {
        const float v = sg::to_f32(px[c * plane]);
        s += v;
        m = fmaxf(m, v);
      }
      mean = s / static_cast<float>(C);
      mx = m;
    }
    s_mean[hy][hx] = mean;
    s_max[hy][hx] = mx;
  }
  __syncthreads();

  const int ty = tid / kTile;
  const int tx = tid - ty * kTile;
  const int yy = y0 + ty;
  const int xx = x0 + tx;
  if (yy >= H || xx >= W) return;  // no barrier follows

  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < kK; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kK; ++dx) {
      acc += s_w[dy * kK + dx] * s_mean[ty + dy][tx + dx] +
             s_w[kK * kK + dy * kK + dx] * s_max[ty + dy][tx + dx];
    }
  }
  const float gate = 1.f / (1.f + expf(-acc));

  const long off = static_cast<long>(yy) * W + xx;
  float dgate = 0.f;
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    const long i = c * plane + off;
    dgate += sg::to_f32(gb[i]) * sg::to_f32(xb[i]);
  }
  const long po = static_cast<long>(blockIdx.z) * plane + off;
  ds[po] = dgate * gate * (1.f - gate);
  gate_out[po] = gate;
  mean_out[po] = s_mean[ty + kPad][tx + kPad];
  max_out[po] = s_max[ty + kPad][tx + kPad];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gate_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ w,
                       const float* __restrict__ ds,
                       const float* __restrict__ gate_in, T* __restrict__ dx,
                       int C, int H, int W) {
  __shared__ float s_ds[kHalo][kHalo];
  __shared__ float s_w[2 * kK * kK];

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const long plane = static_cast<long>(H) * W;
  const long base = static_cast<long>(blockIdx.z) * C * plane;
  const float* dsb = ds + static_cast<long>(blockIdx.z) * plane;

  if (tid < 2 * kK * kK) s_w[tid] = w[tid];
  for (int p = tid; p < kHalo * kHalo; p += kThreads) {
    const int hy = p / kHalo;
    const int hx = p - hy * kHalo;
    const int yy = y0 + hy - kPad;
    const int xx = x0 + hx - kPad;
    s_ds[hy][hx] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                       ? dsb[static_cast<long>(yy) * W + xx]
                       : 0.f;
  }
  __syncthreads();

  const int ty = tid / kTile;
  const int tx = tid - ty * kTile;
  const int yy = y0 + ty;
  const int xx = x0 + tx;
  if (yy >= H || xx >= W) return;  // no barrier follows

  // The forward reads plane[y + dy - 3][x + dx - 3] with tap w[dy][dx], so
  // the plane's cotangent at (y, x) gathers ds[y - dy + 3][x - dx + 3]:
  // row ty + 6 - dy of the halo tile.
  float dmean = 0.f;
  float dmax = 0.f;
#pragma unroll
  for (int dy = 0; dy < kK; ++dy) {
#pragma unroll
    for (int dxx = 0; dxx < kK; ++dxx) {
      const float d = s_ds[ty + 2 * kPad - dy][tx + 2 * kPad - dxx];
      dmean += s_w[dy * kK + dxx] * d;
      dmax += s_w[kK * kK + dy * kK + dxx] * d;
    }
  }

  const long off = static_cast<long>(yy) * W + xx;
  const T* px = x + base + off;
  const T* pg = g + base + off;
  T* pd = dx + base + off;
  float m = -CUDART_INF_F;
  float ties = 0.f;
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    const float v = sg::to_f32(px[c * plane]);
    if (v > m) {
      m = v;
      ties = 1.f;
    } else if (v == m) {
      ties += 1.f;
    }
  }
  const float gate = gate_in[static_cast<long>(blockIdx.z) * plane + off];
  const float d_avg = dmean / static_cast<float>(C);
  const float d_top = dmax / fmaxf(ties, 1.f);
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    const float v = sg::to_f32(px[c * plane]);
    float r = sg::to_f32(pg[c * plane]) * gate + d_avg;
    if (v == m) r += d_top;
    pd[c * plane] = sg::from_f32<T>(r);
  }
}

template <typename T>
int launch(const void* x, const void* g, const float* w, float* ds,
           float* gate, float* mean, float* mx, void* dx, int B, int C, int H,
           int W, cudaStream_t stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  gate_bwd_planes_kernel<T><<<grid, kThreads, 0, stream>>>(
      xt, gt, w, ds, gate, mean, mx, C, H, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gate_bwd_dx_kernel<T><<<grid, kThreads, 0, stream>>>(
      xt, gt, w, ds, gate, static_cast<T*>(dx), C, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, g, dx: (B, C, H, W) contiguous of one type; w: (1, 2, 7, 7) float32;
// ds, gate, mean, max: (B, H, W) float32 (gate is scratch for the second
// launch).
extern "C" int sg_spatial_gate_bwd(const void* x, const void* g,
                                   const void* w, void* ds, void* gate,
                                   void* mean, void* mx, void* dx, int B,
                                   int C, int H, int W, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* dsf = static_cast<float*>(ds);
  float* gf = static_cast<float*>(gate);
  float* mf = static_cast<float*>(mean);
  float* xf = static_cast<float*>(mx);
  if (dtype == sg::kFloat32)
    return launch<float>(x, g, wf, dsf, gf, mf, xf, dx, B, C, H, W, st);
  if (dtype == sg::kBFloat16)
    return launch<__nv_bfloat16>(x, g, wf, dsf, gf, mf, xf, dx, B, C, H, W,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}
