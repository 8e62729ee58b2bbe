// K2: SLAM spatial-gate forward on NCHW,
//   out = x * sigmoid(conv7x7([mean_c x; max_c x], w)),
// with zero-padded planes (SAME), float32 gate math, x float32 or bfloat16.
//
// Replaces sradsgan_tpu/ops/pallas/slam.py:_fwd_pallas (kernel _fwd_kernel),
// which held a whole (H, W, C) image in VMEM and read x once.
//
// Bound: device-memory bytes, x read once and out written once (23.89 MB
// in float32 at (16, 64, 54, 54)); the stencil is 196 FLOPs a pixel, 1/C of
// the elementwise work.  What stands between a kernel and that bound is the
// chain statistics -> 7x7 stencil -> multiply: a pixel's gate needs the
// statistics of every channel on 3 rows around it.
//
// The work goes by strips of whole rows (strip.cuh), per channel one
// contiguous span with no halo and no ragged tile, in two launches:
//   kStats   per strip, mean_c and max_c of each pixel: a warp takes every
//            8th channel, a lane 4 pixels 32 apart, 16 loads in flight a
//            lane, none behind a branch; the warps' partials meet in shared
//            memory in a fixed order, and the two float32 planes go to
//            global memory (1/C of x, so they stay in the L2);
//   kStream  per strip, the planes on its rows and 3 rows beside them into
//            shared memory, the 98-tap stencil and the sigmoid a pixel,
//            then x * gate over every channel, x read a second time from
//            the L2 (the statistics launch has just read it).
// The outputs' launch is a programmatic dependent launch: its blocks start
// on the SMs the statistics launch leaves free, issue their first round of
// x loads and stage the taps, and only then wait for that launch to end.
// A strip holds about one round of 128 pixels a lane (2 rows of 54,
// 4 of 27, 1 of 216).
//
// A one-launch design was built first and measured against this one: a
// block takes a ticket from a counter in device memory, reduces its strip,
// publishes a flag, waits on the flags of the strips within 3 rows of the
// strip before it, and emits that one (no deadlock whatever the residency,
// since it waits only on lower tickets; flags held an epoch number, so no
// memset between launches).  It read x once from device memory as well, but
// with every block resident at once its blocks reduce and then emit in
// lockstep, as the two launches do, and the ticket's round trip starts every
// block late: it was slower at every shape and type (PERF.md, section 6).
#include <math_constants.h>

#include "strip.cuh"

namespace {

using namespace sg::strip;

constexpr int kPx = 4;            // pixels a lane holds at a time
constexpr int kUnroll = 4;        // channels a warp loads at a time
constexpr int kChunk = 32 * kPx;  // pixels a round of loads covers
constexpr int kBlocksAnSm = 4;

// Shared memory in floats: the taps, the warps' partial statistics of a
// chunk, the two planes on a strip's rows and 3 rows beside them with a
// zero border, the gate.
__host__ __device__ inline int shared_floats(int rows, int W) {
  return kTapFloats + 2 * kWarps * kChunk +
         2 * (rows + 2 * kPad) * (W + 2 * kPad) + rows * W;
}

// One round of loads: channels c + u * kWarps (u < kUnroll) of the pixels
// p0 + 32 j + lane (j < kPx) from xs on.  Every load is of an element that
// exists (indices past the end are clamped to the last channel and pixel),
// so none waits on a branch and all go out at once; the caller ignores the
// clamped ones.
template <typename T>
__device__ __forceinline__ void load_round(float (&v)[kUnroll][kPx],
                                           const T* __restrict__ xs,
                                           long plane, int C, int npx, int c,
                                           int p0, int lane) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const T* row = xs + min(c + u * kWarps, C - 1) * plane;
#pragma unroll
    for (int j = 0; j < kPx; ++j)
      v[u][j] = sg::to_f32(row[min(p0 + j * 32 + lane, npx - 1)]);
  }
}

// Mean and max over the C channels of the npx pixels from xs on (channel c
// at xs + c * plane), into gmean and gmax (through the L2).
template <typename T>
__device__ inline void strip_stats(const T* __restrict__ xs, long plane,
                                   int C, int npx, float* s_part,
                                   float* gmean, float* gmax) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int p0 = 0; p0 < npx; p0 += kChunk) {
    float s[kPx], m[kPx];
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      s[j] = 0.f;
      m[j] = -CUDART_INF_F;
    }
    for (int c = warp; c < C; c += kUnroll * kWarps) {
      float v[kUnroll][kPx];
      load_round(v, xs, plane, C, npx, c, p0, lane);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c + u * kWarps < C) {
#pragma unroll
          for (int j = 0; j < kPx; ++j) {
            s[j] += v[u][j];
            m[j] = fmaxf(m[j], v[u][j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      s_part[warp * kChunk + j * 32 + lane] = s[j];
      s_part[(kWarps + warp) * kChunk + j * 32 + lane] = m[j];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < kChunk && p0 + p < npx; p += kThreads) {
      float sum = 0.f, mx = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sum += s_part[w * kChunk + p];
        mx = fmaxf(mx, s_part[(kWarps + w) * kChunk + p]);
      }
      __stcg(gmean + p0 + p, sum / static_cast<float>(C));
      __stcg(gmax + p0 + p, mx);
    }
    __syncthreads();  // the partials are free for the next chunk
  }
}

// The output of the strip r of one image.  xb, ob: the image's first
// element; gmean, gmax: its planes, written by the launch before.
template <typename T>
__device__ inline void strip_out(const T* __restrict__ xb, T* __restrict__ ob,
                                 const float* gmean, const float* gmax,
                                 const Geom& G, const Rows& r,
                                 const float* s_w, float* s_pl,
                                 float* s_gate) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int W = G.W;
  const int y0 = r.r0;
  const int npx = r.npx;
  const long plane = static_cast<long>(G.H) * W;
  const T* xs = xb + static_cast<long>(y0) * W;
  T* os = ob + static_cast<long>(y0) * W;
  float v[kUnroll][kPx];
  load_round(v, xs, plane, G.C, npx, warp, 0, lane);
  // launched before the statistics launch ended: wait for it, and so for
  // its planes, from here on
  asm volatile("griddepcontrol.wait;" ::: "memory");

  const int wp = plane_width(W);
  const int psize = (r.r1 - y0 + 2 * kPad) * wp;
  for (int i = tid; i < 2 * psize; i += kThreads) {
    const int pl = i >= psize;
    const int k = i - pl * psize;
    const int row = k / wp;
    const int y = y0 - kPad + row;
    const int xx = k - row * wp - kPad;
    float pv = 0.f;
    if (y >= 0 && y < G.H && xx >= 0 && xx < W)
      pv = __ldcg((pl ? gmax : gmean) + y * W + xx);
    s_pl[i] = pv;
  }
  __syncthreads();
  for (int p = tid; p < npx; p += kThreads) {
    const int row = p / W;
    const float* a = s_pl + row * wp + (p - row * W);
    float acc = 0.f, acc2 = 0.f;  // two chains of sums, not one
#pragma unroll
    for (int dy = 0; dy < kK; ++dy) {
      float wr[16];
      load_taps(wr, s_w, dy);
#pragma unroll
      for (int dx = 0; dx < kK; ++dx) {
        acc += wr[dx] * a[dy * wp + dx];
        acc2 += wr[8 + dx] * a[psize + dy * wp + dx];
      }
    }
    s_gate[p] = 1.f / (1.f + expf(-(acc + acc2)));
  }
  __syncthreads();

  for (int p0 = 0; p0 < npx; p0 += kChunk) {
    float gate[kPx];
#pragma unroll
    for (int j2 = 0; j2 < kPx; ++j2)
      gate[j2] = s_gate[min(p0 + j2 * 32 + lane, npx - 1)];
    for (int c = warp; c < G.C; c += kUnroll * kWarps) {
      if (p0 > 0 || c > warp) load_round(v, xs, plane, G.C, npx, c, p0, lane);
      // all of a round's loads before its stores: a store may alias a
      // later load for all the compiler knows, and would keep it waiting
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        T* row = os + (c + u * kWarps) * plane + p0 + lane;
#pragma unroll
        for (int j2 = 0; j2 < kPx; ++j2)
          if (c + u * kWarps < G.C && p0 + j2 * 32 + lane < npx)
            row[j2 * 32] = sg::from_f32<T>(v[u][j2] * gate[j2]);
      }
    }
  }
}

// One block a strip and image.  planes: (2, B, H, W) float32 scratch, mean
// then max.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, kBlocksAnSm)
    gate_kernel(const T* __restrict__ x, const float* __restrict__ w,
                T* __restrict__ out, float* planes, const Geom G) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;
  float* s_part = s_w + kTapFloats;
  float* s_pl = s_part + 2 * kWarps * kChunk;
  float* s_gate = s_pl + 2 * (G.rows + 2 * kPad) * plane_width(G.W);

  const int b = blockIdx.x / G.nstrips;
  const Rows r = rows_of(G, blockIdx.x - b * G.nstrips);
  const long plane = static_cast<long>(G.H) * G.W;
  const T* xb = x + static_cast<long>(b) * G.C * plane;
  float* gmean = planes + b * plane;
  float* gmax = gmean + static_cast<long>(G.B) * plane;

  if (kMode == kStats) {
    // let the outputs' launch start on the SMs this one leaves free
    asm volatile("griddepcontrol.launch_dependents;");
    const long off = static_cast<long>(r.r0) * G.W;
    strip_stats(xb + off, plane, G.C, r.npx, s_part, gmean + off,
                gmax + off);
    return;
  }
  stage_taps(s_w, w);  // strip_out's first barrier comes before any use
  strip_out(xb, out + static_cast<long>(b) * G.C * plane, gmean, gmax, G, r,
            s_w, s_pl, s_gate);
}

// Rows a strip: enough for a round of kChunk pixels, fewer where that would
// leave SMs without a strip or shared memory would not hold them; 0 where
// one row does not fit.
int choose_rows(int B, int H, int W) {
  const long rows_all = static_cast<long>(B) * H;
  const long sms = sg::attn::sm_count();
  int rows = static_cast<int>(
      min(static_cast<long>(min(H, max(1, kChunk / W))),
          max(1L, (rows_all + sms - 1) / sms)));
  for (; rows >= 1; --rows)
    if (shared_floats(rows, W) * 4 <= kMaxShared) return rows;
  return 0;
}

template <typename T>
int launch_all(const void* x, const float* w, void* out, float* planes,
               int B, int C, int H, int W, int rows, cudaStream_t stream) {
  const Geom G = geom_for(B, C, H, W, sizeof(T), 0, (H + rows - 1) / rows);
  const int bytes = shared_floats(G.rows, W) * 4;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const auto run = [&](auto kernel, bool early) {
    cudaError_t err = sg::attn::allow_shared_bytes(kernel, bytes);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(B * G.nstrips));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = early ? 1 : 0;
    return cudaLaunchKernelEx(&cfg, kernel, xt, w, ot, planes, G);
  };
  cudaError_t err = run(gate_kernel<T, kStats>, false);
  if (err == cudaSuccess) err = run(gate_kernel<T, kStream>, true);
  return static_cast<int>(err);
}

}  // namespace

// The launches for this shape: out[0] = rows a strip, out[1] = strips an
// image, out[2] = the shared bytes a block asks for.
extern "C" int sg_spatial_gate_plan(int B, int C, int H, int W, int dtype,
                                    int* out) {
  if (dtype != sg::kFloat32 && dtype != sg::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = choose_rows(B, H, W);
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = rows;
  out[1] = (H + rows - 1) / rows;
  out[2] = shared_floats(rows, W) * 4;
  return 0;
}

// x, out: (B, C, H, W) contiguous of one type; w: (1, 2, 7, 7) float32;
// planes: float32 scratch of 2 B H W floats; rows: the plan's out[0] (or
// any height whose strip fits shared memory).
extern "C" int sg_spatial_gate(const void* x, const void* w, void* out,
                               void* planes, int B, int C, int H, int W,
                               int dtype, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(planes);
  if (rows < 1 || rows > H || shared_floats(rows, W) * 4 > kMaxShared ||
      static_cast<long>(B) * ((H + rows - 1) / rows) >= (1L << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == sg::kFloat32)
    return launch_all<float>(x, wf, out, pf, B, C, H, W, rows, st);
  if (dtype == sg::kBFloat16)
    return launch_all<__nv_bfloat16>(x, wf, out, pf, B, C, H, W, rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
