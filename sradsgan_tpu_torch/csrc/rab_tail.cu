// K6: the fused RAB tail on NCHW,
//   u   = t * sigmoid(mlp(avg_hw t) + mlp(max_hw t))     CLAM, mlp = relu(. W1) W2
//   w   = u * sigmoid(conv7x7([mean_c u; max_c u]))      SLAM, zero padding
//   out = w . W_fuse + b_fuse + x_res                    1x1 fuse + residual
// with the byproducts the backward consumes: gate_c, avg_t, max_t (B, C) and
// gate_s, mean_u, max_u (B, H, W), all float32.
//
// Replaces sradsgan_tpu/ops/pallas/rab_tail.py:_fwd_pallas (kernel
// _fwd_kernel).  The TPU kernel held one whole (H, W, C) slice in VMEM and
// ran the grid over the batch.  One 54x54x64 float32 slice is 746 KB, over a
// Hopper SM's 227 KB of shared memory, and the SLAM needs the CLAM's
// image-wide pools before any tile can start.  So two launches:
//   1. rab_tail_pool_kernel: one block per (b, c) row of t reduces its
//      float32 mean and max (the byproducts avg_t and max_t);
//   2. rab_tail_tile_kernel: one block per 16x16 tile of one image.  Its
//      prologue recomputes the (2, C) x (C, hidden) x (hidden, C) MLP and
//      the sigmoid from the pooled vectors (a few hundred FMAs); then
//      mean_c and max_c of t * gate_c over the tile and a 3-pixel halo go to
//      shared memory (0 outside the image: the SAME conv's zero padding);
//      each thread runs the 7x7 stencil and the sigmoid for its pixel; the
//      fuse is a per-pixel C x C product in passes of kCo output channels,
//      the W_fuse slab of each pass staged in shared memory and read as
//      broadcast float4, the pixel's kCo sums in registers; bias and
//      residual are added in float32 and cast once.
//
// Bound: device-memory bytes (t and x_res read once, out written once; at
// C = 64 the fuse is 2*64 FLOPs per element moved, well under the card's
// float32 rate over its memory rate).  The tile kernel rereads t from L1/L2
// for the statistics and once per pass of the fuse (C / kCo passes), and
// nothing but out and the small byproducts goes back to device memory.
// Plain float32 FMAs: float32 inputs keep float32 operands.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kK = 7;
constexpr int kPad = kK / 2;
constexpr int kTile = 16;
constexpr int kHalo = kTile + 2 * kPad;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kCo = 32;  // output channels per pass of the fuse product

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rab_tail_pool_kernel(const T* __restrict__ t, float* __restrict__ avg,
                         float* __restrict__ mx, int n) {
  const long row = blockIdx.x;
  const T* p = t + row * static_cast<long>(n);
  float s = 0.f;
  float m = -CUDART_INF_F;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = sg::to_f32(p[i]);
    s += v;
    m = fmaxf(m, v);
  }
  s = sg::warp_sum(s);
  m = sg::warp_max(m);

  __shared__ float part_s[kWarps];
  __shared__ float part_m[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    part_s[warp] = s;
    part_m[warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? part_s[lane] : 0.f;
    m = lane < kWarps ? part_m[lane] : -CUDART_INF_F;
    s = sg::warp_sum(s);
    m = sg::warp_max(m);
    if (lane == 0) {
      avg[row] = s / static_cast<float>(n);
      mx[row] = m;
    }
  }
}

// Dynamic shared memory, in floats: the W_fuse slab (C * kCo, first, so that
// its float4 reads are 16-byte aligned), gate_c (C), the two pooled vectors
// (2 * C) and the MLP's hidden units (2 * hidden).
__host__ __device__ inline size_t tile_smem_floats(int C, int hidden) {
  return static_cast<size_t>(C) * kCo + 3 * static_cast<size_t>(C) +
         2 * static_cast<size_t>(hidden);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rab_tail_tile_kernel(const T* __restrict__ t, const T* __restrict__ x_res,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2,
                         const float* __restrict__ slam_w,
                         const float* __restrict__ fuse_w,
                         const float* __restrict__ fuse_b,
                         const float* __restrict__ avg_t,
                         const float* __restrict__ max_t, T* __restrict__ out,
                         float* __restrict__ gate_c,
                         float* __restrict__ gate_s,
                         float* __restrict__ mean_u,
                         float* __restrict__ max_u, int C, int hidden, int H,
                         int W) {
  extern __shared__ __align__(16) float smem[];
  float* s_wf = smem;                   // (C, kCo) slab of W_fuse
  float* s_gc = s_wf + C * kCo;         // (C,)
  float* s_pool = s_gc + C;             // (2, C): avg_t, max_t
  float* s_hid = s_pool + 2 * C;        // (2, hidden)
  __shared__ float s_mean[kHalo][kHalo];
  __shared__ float s_max[kHalo][kHalo];
  __shared__ float s_slam[2 * kK * kK];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const long plane = static_cast<long>(H) * W;
  const long base = static_cast<long>(b) * C * plane;
  const T* tb = t + base;
  const T* xb = x_res + base;
  T* ob = out + base;
  const long pbase = static_cast<long>(b) * plane;

  // ---- CLAM: the shared MLP over both pooled vectors, then the sigmoid
  for (int c = tid; c < C; c += kThreads) {
    s_pool[c] = avg_t[b * C + c];
    s_pool[C + c] = max_t[b * C + c];
  }
  if (tid < 2 * kK * kK) s_slam[tid] = slam_w[tid];  // OIHW (1, 2, 7, 7)
  __syncthreads();
  for (int j = tid; j < 2 * hidden; j += kThreads) {
    const float* p = s_pool + (j / hidden) * C;
    const int jj = j % hidden;
    float h = 0.f;
    for (int c = 0; c < C; ++c) h += p[c] * w1[c * hidden + jj];
    s_hid[j] = fmaxf(h, 0.f);
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float za = 0.f;
    float zm = 0.f;
    for (int j = 0; j < hidden; ++j) {
      const float w = w2[j * C + c];
      za += s_hid[j] * w;
      zm += s_hid[hidden + j] * w;
    }
    const float g = 1.f / (1.f + expf(-(za + zm)));
    s_gc[c] = g;
    if (blockIdx.x == 0 && blockIdx.y == 0) gate_c[b * C + c] = g;
  }
  __syncthreads();

  // ---- SLAM statistics of u = t * gate_c over the tile and its halo
  for (int p = tid; p < kHalo * kHalo; p += kThreads) {
    const int hy = p / kHalo;
    const int hx = p - hy * kHalo;
    const int yy = y0 + hy - kPad;
    const int xx = x0 + hx - kPad;
    float mean = 0.f;
    float mx = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const long off = static_cast<long>(yy) * W + xx;
      const T* px = tb + off;
      float s = 0.f;
      float m = -CUDART_INF_F;
#pragma unroll 8
      for (int c = 0; c < C; ++c) {
        // one rounded product, as the backward recomputes u, so that the
        // stored max equals an element of u bit for bit
        const float v = __fmul_rn(sg::to_f32(px[c * plane]), s_gc[c]);
        s += v;
        m = fmaxf(m, v);
      }
      mean = s / static_cast<float>(C);
      mx = m;
      if (hy >= kPad && hy < kPad + kTile && hx >= kPad &&
          hx < kPad + kTile) {  // each pixel lies inside exactly one tile
        mean_u[pbase + off] = mean;
        max_u[pbase + off] = mx;
      }
    }
    s_mean[hy][hx] = mean;
    s_max[hy][hx] = mx;
  }
  __syncthreads();

  // ---- the 7x7 stencil and its sigmoid, one pixel per thread
  const int ty = tid / kTile;
  const int tx = tid - ty * kTile;
  const int yy = y0 + ty;
  const int xx = x0 + tx;
  const bool valid = yy < H && xx < W;  // barriers follow: no early return
  const long off = static_cast<long>(yy) * W + xx;
  float gate = 0.f;
  if (valid) {
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < kK; ++dy) {
#pragma unroll
      for (int dx = 0; dx < kK; ++dx) {
        acc += s_slam[dy * kK + dx] * s_mean[ty + dy][tx + dx] +
               s_slam[kK * kK + dy * kK + dx] * s_max[ty + dy][tx + dx];
      }
    }
    gate = 1.f / (1.f + expf(-acc));
    gate_s[pbase + off] = gate;
  }

  // ---- 1x1 fuse + bias + residual, kCo output channels per pass
  for (int co0 = 0; co0 < C; co0 += kCo) {
    __syncthreads();  // the previous slab has been consumed
    for (int i = tid; i < C * kCo; i += kThreads) {
      const int ci = i / kCo;
      const int co = co0 + (i - ci * kCo);
      s_wf[i] = co < C ? fuse_w[ci * C + co] : 0.f;  // (C_in, C_out)
    }
    __syncthreads();
    if (!valid) continue;
    float acc[kCo];
#pragma unroll
    for (int j = 0; j < kCo; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      const float a =
          __fmul_rn(sg::to_f32(tb[ci * plane + off]), s_gc[ci]) * gate;
      const float4* wrow = reinterpret_cast<const float4*>(s_wf + ci * kCo);
#pragma unroll
      for (int j4 = 0; j4 < kCo / 4; ++j4) {
        const float4 w = wrow[j4];
        acc[4 * j4 + 0] += a * w.x;
        acc[4 * j4 + 1] += a * w.y;
        acc[4 * j4 + 2] += a * w.z;
        acc[4 * j4 + 3] += a * w.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kCo; ++j) {
      const int co = co0 + j;
      if (co < C) {
        const long i = co * plane + off;
        ob[i] = sg::from_f32<T>(acc[j] + fuse_b[co] + sg::to_f32(xb[i]));
      }
    }
  }
}

template <typename T>
void launch(const void* t, const void* x_res, const float* w1, const float* w2,
            const float* slam_w, const float* fuse_w, const float* fuse_b,
            void* out, float* gate_c, float* gate_s, float* mean_u,
            float* max_u, float* avg_t, float* max_t, int B, int C,
            int hidden, int H, int W, cudaStream_t stream) {
  rab_tail_pool_kernel<T><<<B * C, kThreads, 0, stream>>>(
      static_cast<const T*>(t), avg_t, max_t, H * W);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  const size_t smem = tile_smem_floats(C, hidden) * sizeof(float);
  rab_tail_tile_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(x_res), w1, w2, slam_w,
      fuse_w, fuse_b, avg_t, max_t, static_cast<T*>(out), gate_c, gate_s,
      mean_u, max_u, C, hidden, H, W);
}

}  // namespace

// t, x_res, out: (B, C, H, W) contiguous of one type.  Float32: w1
// (C, hidden), w2 (hidden, C), slam_w (1, 2, 7, 7), fuse_w (C_in, C_out),
// fuse_b (C,); outputs gate_c, avg_t, max_t (B, C) and gate_s, mean_u, max_u
// (B, H, W).  C is at most 256: the slab and the vectors then fit the 48 KB
// of shared memory a block gets without asking for more.
extern "C" int sg_rab_tail(const void* t, const void* x_res, const void* w1,
                           const void* w2, const void* slam_w,
                           const void* fuse_w, const void* fuse_b, void* out,
                           void* gate_c, void* gate_s, void* mean_u,
                           void* max_u, void* avg_t, void* max_t, int B, int C,
                           int hidden, int H, int W, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 256 || hidden < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  if (dtype == sg::kFloat32) {
    launch<float>(t, x_res, f(w1), f(w2), f(slam_w), f(fuse_w), f(fuse_b), out,
                  g(gate_c), g(gate_s), g(mean_u), g(max_u), g(avg_t),
                  g(max_t), B, C, hidden, H, W, st);
  } else if (dtype == sg::kBFloat16) {
    launch<__nv_bfloat16>(t, x_res, f(w1), f(w2), f(slam_w), f(fuse_w),
                          f(fuse_b), out, g(gate_c), g(gate_s), g(mean_u),
                          g(max_u), g(avg_t), g(max_t), B, C, hidden, H, W,
                          st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
