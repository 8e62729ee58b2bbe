// K4: SLAM spatial-gate backward on NCHW, for out = x * gate,
//   gate = sigmoid(conv7x7([mean_c x; max_c x], w)), zero-padded planes.
//
// Replaces sradsgan_tpu/ops/pallas/slam.py:_bwd_pallas (kernel _bwd_kernel)
// and the dw contraction after it (slam.py:_dw_contraction).  Given x and
// the output cotangent g it computes
//   ds    = sum_c(g * x) * gate * (1 - gate)                    (per pixel)
//   dmean, dmax = the transposed 7x7 stencil of ds with w's two planes
//   dx    = g * gate + dmean / C + (dmax / ties) * [x == max_c x]
//   dw    = sum over the batch and the pixels of ds times the shifted
//           mean and max planes (98 sums)
// with ties = max(count of channels equal to the max, 1).  All gate math is
// float32.  Ties are recounted from x here, never compared against a saved
// max (slam.py:15-20).
//
// Bound: device-memory bytes: x and g read once, dx written once; the
// arithmetic is a few operations an element.  What stands between a kernel
// and that bound is the chain of stages, each needing its neighbours' rows
// of the one before:
//   A. per pixel, over the channels: mean, max, tie count, sum_c(g * x);
//   B. the stencil and the gate, ds (needs A on a 3-row halo);
//   C. the transposed stencil for dmean and dmax (needs ds on a 3-row halo),
//      then dx for every channel;
//   D. dw: 98 products a pixel, summed by warps over a block's rows and
//      written as one row of partials, which one more block of the last
//      launch adds in a fixed order (no atomics: two runs give the same
//      bits).
// The TPU kernel held a whole image in VMEM and ran the chain in one go.
// Here it is three launches over strips of whole rows (strip.cuh): A over
// strips of a row or two, writing the four per-pixel planes (1 / C of a
// tensor, so they stay in the L2); B, the stencil of C and D over bands of
// a few rows, reading those planes on the band's halo and writing the gate
// and the two plane cotangents; then dx over the small strips again,
// streaming x and g a second time (from the L2) with the three per-pixel
// values.  No load of x or g is on a halo or a ragged tile, every one is
// coalesced along a row, and in C a thread's loads go out in batches ahead
// of its stores.
#include <math_constants.h>

#include "strip.cuh"

namespace {

using namespace sg::strip;

constexpr int kValues = 4;  // sum, max, ties, sum_c(g x) a slice
constexpr int kDwTaps = (kTaps + kWarps - 1) / kWarps;  // taps a warp in D
constexpr int kDwPixels = 4;       // pixels a lane holds at a time in D
constexpr int kDwLanes = kThreads / 128;  // interleaved sums a tap of dw

__host__ __device__ constexpr int min_blocks_of(int mode) {
  return mode == kPlanes ? 2 : 4;
}

// Shared memory in bytes, as the kernel lays it out: the slices' partials
// where A runs, the taps and the planes where the stencils run, none for dx.
inline int total_bytes(int mode, const Geom& G, int slices) {
  const int planes = (G.rmax + 2 * kPad) * (G.W + 2 * kPad);
  const int npx = G.rmax * G.W;
  if (mode == kStats) return slices * kValues * npx * 4;
  if (mode == kPlanes) return (kTapFloats + 100 + 3 * planes + 4 * npx) * 4;
  return 0;
}

// dx for one pixel and the channels [c0, c1): kBatch channels' loads before
// their stores, since a store may alias a later load for all the compiler
// knows, and would keep it waiting.
template <typename T>
__device__ __forceinline__ void dx_pixel(const StripView<T>& vx,
                                         const StripView<T>& vg, T* po,
                                         long plane, int p, int c0, int c1,
                                         float gate, float d_avg, float d_top,
                                         float m) {
  constexpr int kBatch = 8;
  auto kx = vx.at(c0);
  auto kg = vg.at(c0);
  for (int c = c0; c < c1; c += kBatch) {
    float xv[kBatch], gv[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c + j < c1) {
        xv[j] = vx.get(kx, p);
        gv[j] = vg.get(kg, p);
        vx.next(kx);
        vg.next(kg);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c + j < c1) {
        float v = gv[j] * gate + d_avg;
        if (xv[j] == m) v += d_top;
        *po = sg::from_f32<T>(v);
        po += plane;
      }
    }
  }
}

// dw = the partials' sum in a fixed order: kDwLanes interleaved partial sums
// a tap, each in the order of its rows, then those in turn.  By all the
// threads of one block.
__device__ inline void sum_dw(const float* __restrict__ part,
                              float* __restrict__ dw, int nparts) {
  __shared__ float s_sum[kDwLanes][128];
  const int t = threadIdx.x & 127;
  const int q = threadIdx.x >> 7;
  float acc = 0.f;
  if (t < kTaps) {
#pragma unroll 16
    for (int i = q; i < nparts; i += kDwLanes)
      acc += part[static_cast<long>(i) * kTaps + t];
  }
  s_sum[q][t] = acc;
  __syncthreads();
  if (q == 0 && t < kTaps) {
    acc = 0.f;
#pragma unroll
    for (int j = 0; j < kDwLanes; ++j) acc += s_sum[j][t];
    dw[t] = acc;
  }
}

// planes: (7, B, H, W) float32 scratch in global memory: mean, max,
// sum_c(g x) and ties from A; the gate, dmean / C and dmax / ties from C.
// dw_part: a row of 98 partials for each block of the kPlanes launch (nparts
// rows).  The kStream launch has one block more than strips: it adds up dw
// while the others are at their dx.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, min_blocks_of(kMode))
    gate_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ w, T* __restrict__ dx,
                    float* __restrict__ dw_part, float* __restrict__ planes,
                    float* __restrict__ dw, const Geom G, const int slices,
                    const int with_dw, const int nparts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int C = G.C;
  const int W = G.W;
  const int wp = plane_width(W);
  const int npx_max = G.rmax * W;
  const int plane_size = (G.rmax + 2 * kPad) * wp;

  // kStats: the slices' partials are all there is
  float* s_part = reinterpret_cast<float*>(smem);
  // kPlanes
  float* s_w = reinterpret_cast<float*>(smem);
  float* s_dw = s_w + kTapFloats;
  float* s_mean = s_dw + 100;          // three padded planes in a row
  float* s_max = s_mean + plane_size;
  float* s_ds = s_max + plane_size;
  float* s_a = s_ds + plane_size;      // sum_c(g x)
  float* s_b = s_a + npx_max;          // ties
  float* s_gate = s_b + npx_max;
  int* s_pidx = reinterpret_cast<int*>(s_gate + npx_max);

  if (kMode == kPlanes) stage_taps(s_w, w);

  if (kMode == kStream && blockIdx.y == G.nstrips) {
    if (blockIdx.z == 0) sum_dw(dw_part, dw, nparts);
    return;
  }
  const long plane = static_cast<long>(G.H) * W;
  const long gstep = static_cast<long>(G.B) * plane;  // between global planes
  const Rows r = rows_of(G, blockIdx.y);
  const int npx = r.npx;

  for (int b = blockIdx.z; b < G.B; b += gridDim.z) {
    const long off = static_cast<long>(b) * C * plane +
                     static_cast<long>(r.r0) * W;
    const long poff = static_cast<long>(b) * plane +
                      static_cast<long>(r.r0) * W;
    const StripView<T> vx = make_view<T>(x + off, nullptr, plane, 0);
    const StripView<T> vg = make_view<T>(g + off, nullptr, plane, 0);

    if (kMode == kStats) {
      // ---- A: channel statistics, by slices of the channels
      for (int i = tid; i < slices * npx; i += kThreads) {
        const int sl = i / npx;
        const int p = i - sl * npx;
        const int c0 = sl * C / slices;
        const int c1 = (sl + 1) * C / slices;
        float s = 0.f, m = -CUDART_INF_F, ties = 0.f, dg = 0.f;
        auto kx = vx.at(c0);
        auto kg = vg.at(c0);
#pragma unroll 8
        for (int c = c0; c < c1; ++c) {
          const float v = vx.get(kx, p);
          s += v;
          if (v > m) {
            m = v;
            ties = 1.f;
          } else if (v == m) {
            ties += 1.f;
          }
          dg += vg.get(kg, p) * v;
          vx.next(kx);
          vg.next(kg);
        }
        float* part = s_part + sl * kValues * npx_max + p;
        part[0] = s;
        part[npx_max] = m;
        part[2 * npx_max] = ties;
        part[3 * npx_max] = dg;
      }
      __syncthreads();
      for (int p = tid; p < npx; p += kThreads) {
        float s = 0.f, m = -CUDART_INF_F, ties = 0.f, dg = 0.f;
        for (int sl = 0; sl < slices; ++sl) {
          const float* part = s_part + sl * kValues * npx_max + p;
          s += part[0];
          const float ms = part[npx_max];
          const float ts = part[2 * npx_max];
          if (ms > m) {
            m = ms;
            ties = ts;
          } else if (ms == m) {
            ties += ts;
          }
          dg += part[3 * npx_max];
        }
        planes[poff + p] = s / static_cast<float>(C);
        planes[gstep + poff + p] = m;
        planes[2 * gstep + poff + p] = dg;
        planes[3 * gstep + poff + p] = ties;
      }
      __syncthreads();  // the partials are free for the next image
      continue;
    }

    if (kMode == kStream) {
      // ---- C, second half: dx from the planes of the launch before
      for (int i = tid; i < slices * npx; i += kThreads) {
        const int sl = i / npx;
        const int p = i - sl * npx;
        dx_pixel(vx, vg, dx + off + (sl * C / slices) * plane + p, plane, p,
                 sl * C / slices, (sl + 1) * C / slices,
                 planes[4 * gstep + poff + p], planes[5 * gstep + poff + p],
                 planes[6 * gstep + poff + p], planes[gstep + poff + p]);
      }
      continue;
    }

    // ---- kPlanes.  The block works on its band and kPad rows beside it:
    // ds there feeds the band's dmean and dmax.
    for (int i = tid; i < 3 * plane_size; i += kThreads) s_mean[i] = 0.f;
    for (int p = tid; p < npx; p += kThreads) {
      const int y = p / W;
      s_pidx[p] = (y + kPad) * wp + (p - y * W) + kPad;
      s_a[p] = planes[2 * gstep + poff + p];
      s_b[p] = planes[3 * gstep + poff + p];
    }
    __syncthreads();
    load_planes(s_mean, 2, plane_size, planes, gstep,
                static_cast<long>(b) * plane, G, r);
    __syncthreads();

    // ---- B: the stencil, the gate, ds
    for (int p = tid; p < npx; p += kThreads) {
      const int at = s_pidx[p] - kPad * wp - kPad;
      float acc = 0.f, acc2 = 0.f;  // two chains of sums, not one
#pragma unroll
      for (int dy = 0; dy < kK; ++dy) {
        float wr[16];
        load_taps(wr, s_w, dy);
#pragma unroll
        for (int dxx = 0; dxx < kK; ++dxx) {
          acc += wr[dxx] * s_mean[at + dy * wp + dxx];
          acc2 += wr[8 + dxx] * s_max[at + dy * wp + dxx];
        }
      }
      const float gate = 1.f / (1.f + expf(-(acc + acc2)));
      s_gate[p] = gate;
      s_ds[s_pidx[p]] = s_a[p] * gate * (1.f - gate);
    }
    __syncthreads();

    // ---- C, first half: the transposed stencil.  The forward reads
    // plane[y + dy - 3][x + dx - 3] with tap w[dy][dx], so the plane's
    // cotangent at (y, x) gathers ds[y - dy + 3][x - dx + 3].
    for (int p = r.plo + tid; p < r.phi; p += kThreads) {
      const int at = s_pidx[p] + kPad * wp + kPad;
      float dmean = 0.f, dmax = 0.f;
#pragma unroll
      for (int dy = 0; dy < kK; ++dy) {
        float wr[16];
        load_taps(wr, s_w, dy);
#pragma unroll
        for (int dxx = 0; dxx < kK; ++dxx) {
          const float d = s_ds[at - dy * wp - dxx];
          dmean += wr[dxx] * d;
          dmax += wr[8 + dxx] * d;
        }
      }
      planes[4 * gstep + poff + p] = s_gate[p];
      planes[5 * gstep + poff + p] = dmean / static_cast<float>(C);
      planes[6 * gstep + poff + p] = dmax / fmaxf(s_b[p], 1.f);
    }

    // ---- D: this band's part of dw, a warp a tap at a time.  A lane holds
    // kDwPixels pixels' ds and plane index at a time and runs its warp's
    // taps over them: one shared-memory read a product.
    if (with_dw) {
      float acc[kDwTaps];
#pragma unroll
      for (int t = 0; t < kDwTaps; ++t) acc[t] = 0.f;
      for (int p0 = r.plo; p0 < r.phi; p0 += 32 * kDwPixels) {
        float d[kDwPixels];
        int at[kDwPixels];
#pragma unroll
        for (int j = 0; j < kDwPixels; ++j) {
          const int p = p0 + j * 32 + lane;
          at[j] = p < r.phi ? s_pidx[p] : s_pidx[r.plo];
          d[j] = p < r.phi ? s_ds[at[j]] : 0.f;
        }
#pragma unroll
        for (int t = 0; t < kDwTaps; ++t) {
          const int tap = warp + t * kWarps;
          if (tap >= kTaps) break;
          const int pl = tap / (kK * kK);
          const int k = tap - pl * kK * kK;
          const int dy = k / kK;
          const float* stat = (pl == 0 ? s_mean : s_max) +
                              (dy - kPad) * wp + (k - dy * kK) - kPad;
#pragma unroll
          for (int j = 0; j < kDwPixels; ++j) acc[t] += d[j] * stat[at[j]];
        }
      }
#pragma unroll
      for (int t = 0; t < kDwTaps; ++t) {
        const int tap = warp + t * kWarps;
        const float sum = sg::warp_sum(acc[t]);
        if (lane == 0 && tap < kTaps) s_dw[tap] = sum;
      }
      __syncthreads();
      const long part = static_cast<long>(b) * G.nstrips + blockIdx.y;
      if (tid < kTaps) dw_part[part * kTaps + tid] = s_dw[tid];
    }
    __syncthreads();  // the planes are free for the next image
  }
}

template <typename T>
bool choose_for(int B, int C, int H, int W, Plan* plan) {
  return choose(total_bytes, B, C, H, W, sizeof(T), kPad, 8, 8, plan);
}

template <typename T>
int launch_all(const void* x, const void* g, const float* w, void* dx,
               float* dw, float* dw_part, float* planes, int B, int C, int H,
               int W, const Plan& plan, int with_dw, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  const int nparts = B * plan.bands;
  const auto run = [&](auto kernel, int mode, int reach, int nstrips) {
    const Geom G = geom_for(B, C, H, W, sizeof(T), reach, nstrips);
    // the dx launch's extra block adds up dw
    return launch(kernel, G, mode == kStream && with_dw ? 1 : 0,
                  total_bytes(mode, G, plan.slices), stream, xt, gt, w, dxt,
                  dw_part, planes, dw, G, plan.slices, with_dw, nparts);
  };
  cudaError_t err =
      run(gate_bwd_kernel<T, kStats>, kStats, 0, plan.stats_strips);
  if (err == cudaSuccess)
    err = run(gate_bwd_kernel<T, kPlanes>, kPlanes, kPad, plan.bands);
  if (err == cudaSuccess)
    err = run(gate_bwd_kernel<T, kStream>, kStream, 0, plan.stream_strips);
  return static_cast<int>(err);
}

}  // namespace

// The launches for this shape (strip.cuh: choose): out[0..5] = bands an image
// of the stencils' launch, strips an image of the statistics launch and of
// the dx launch, channel slices, the most shared bytes a block asks for,
// rows of dw partials the caller provides room for.
extern "C" int sg_spatial_gate_bwd_plan(int B, int C, int H, int W, int dtype,
                                        int* out) {
  Plan plan;
  if (dtype != sg::kFloat32 && dtype != sg::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(dtype == sg::kFloat32 ? choose_for<float>(B, C, H, W, &plan)
                              : choose_for<__nv_bfloat16>(B, C, H, W, &plan)))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = plan.bands;
  out[1] = plan.stats_strips;
  out[2] = plan.stream_strips;
  out[3] = plan.slices;
  out[4] = plan.shared_bytes;
  out[5] = B * plan.bands;
  return 0;
}

// x, g, dx: (B, C, H, W) contiguous of one type; w, dw: (1, 2, 7, 7) float32;
// dw_part: float32 scratch of 98 floats for each row the plan names; planes:
// float32 scratch of 7 B H W floats; bands, stats_strips, stream_strips,
// slices: the plan's out[0..3].  With with_dw = 0 the dw stage and its sum
// are left out (dw is not written): for timing the stage apart.
extern "C" int sg_spatial_gate_bwd(const void* x, const void* g,
                                   const void* w, void* dx, void* dw,
                                   void* dw_part, void* planes, int B, int C,
                                   int H, int W, int dtype, int bands,
                                   int stats_strips, int stream_strips,
                                   int slices, int with_dw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* dwf = static_cast<float*>(dw);
  float* pf = static_cast<float*>(dw_part);
  float* sf = static_cast<float*>(planes);
  if (bands < 1 || stats_strips < 1 || stream_strips < 1 || slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan{bands, stats_strips, stream_strips, slices, 0};
  if (dtype == sg::kFloat32)
    return launch_all<float>(x, g, wf, dx, dwf, pf, sf, B, C, H, W, plan,
                             with_dw, st);
  if (dtype == sg::kBFloat16)
    return launch_all<__nv_bfloat16>(x, g, wf, dx, dwf, pf, sf, B, C, H, W,
                                     plan, with_dw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
