// K6: the fused RAB tail on NCHW,
//   u   = t * sigmoid(mlp(avg_hw t) + mlp(max_hw t))     CLAM, mlp = relu(. W1) W2
//   w   = u * sigmoid(conv7x7([mean_c u; max_c u]))      SLAM, zero padding
//   out = w . W_fuse + b_fuse + x_res                    1x1 fuse + residual
// with the byproducts the backward consumes: gate_c, avg_t, max_t (B, C) and
// gate_s, mean_u, max_u (B, H, W), all float32.
//
// Replaces sradsgan_tpu/ops/pallas/rab_tail.py:_fwd_pallas (kernel
// _fwd_kernel).  The TPU kernel held one whole (H, W, C) slice in VMEM and
// ran the grid over the batch.
//
// Bound: device-memory bytes (t and x_res read once, out written once).  Two
// things stand between a kernel and that bound.  The SLAM needs the CLAM's
// image-wide pools before any pixel can start, and its stencil needs the
// statistics of u on a halo, so t is wanted three times (pool, statistics,
// fuse); and the fuse is a (pixels x C) . (C x C) product which, on the CUDA
// cores, is alone of the size of the byte bound.  So, over strips of whole
// rows (strip.cuh), four launches:
//   1. the pool: a block a (b, c) plane;
//   2. kStats: the MLP and its sigmoid in every block (a few hundred FMAs),
//      then mean_c and max_c of u = t * gate_c (one rounded product, so that
//      max_u is an element of u bit for bit), over strips of a row or two;
//   3. kPlanes: the 7x7 stencil and its sigmoid over bands of a few rows,
//      the halo read from the mean_u and max_u planes that 2 wrote;
//   4. kStream: the fuse on the tensor cores, over strips of a few rows
//      copied into shared memory by cp.async, 16 pixels x 32 output channels
//      a warp at a time.  The two gates leave the operands: with
//      W' = diag(gate_c) W_fuse, staged for the block's image while the copy
//      is on its way, out = gate_s * (t . W') + b_fuse + x_res, so the A
//      fragments are t as it lies in the copy and gate_s scales a row of the
//      result.  bfloat16 operands by mma.sync m16n8k16; float32 operands as
//      the error-compensated sum of three TF32 products (high parts and
//      residuals, sgam_mma.cuh), which keeps float32 accuracy; float32
//      accumulation, bias and residual added in float32, one cast.
// t crosses from device memory once and twice more from the L2; nothing is
// read on a halo but the two small planes.
#include <math_constants.h>

#include "strip.cuh"

namespace {

using namespace sg::strip;
using sg::attn::mma_bf16_k16;
using sg::attn::mma_tf32;
using sg::attn::split_a;
using sg::attn::SplitA;
using sg::attn::split_tf32;

constexpr int kPass = 64;        // output channels a pass of the fuse
constexpr int kLdw = kPass + 8;  // float32 slab: words a row of W'
constexpr int kPoolThreads = 256;

__host__ __device__ constexpr int min_blocks_of(int mode) {
  return mode == kStream ? 2 : 4;
}
__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// bfloat16 slab: elements a row (one output channel, the inputs along it)
__host__ __device__ inline int slab_ld(int C) { return round_up(C, 16) + 8; }

// Shared memory as the kernel lays it out, in bytes from its base: each
// piece only in the mode that uses it.
struct Layout {
  int slab, taps, gc, bias, pool, hid, w1, w2, mean, gate, pidx, part, total;
};

__host__ __device__ inline Layout layout_of(int mode, const Geom& G,
                                            int hidden, int slices,
                                            int elem_size) {
  const bool stats = mode == kStats;
  const bool planes = mode == kPlanes;
  const bool fuse = mode == kStream;
  const int plane_size = (G.rmax + 2 * kPad) * (G.W + 2 * kPad);
  const int npx = G.rmax * G.W;
  Layout l;
  int at = fuse ? G.C * G.stride * elem_size : 0;  // the copy of t first
  const auto take = [&at](bool used, int bytes) {
    const int here = at;
    if (used) at += (bytes + 15) / 16 * 16;
    return here;
  };
  l.slab = take(fuse, elem_size == 4 ? 2 * round_up(G.C, 8) * kLdw * 4
                                     : kPass * slab_ld(G.C) * 2);
  l.taps = take(planes, kTapFloats * 4);
  l.gc = take(stats || fuse, G.C * 4);
  l.bias = take(fuse, G.C * 4);
  l.pool = take(stats, 2 * G.C * 4);
  l.hid = take(stats, 2 * hidden * 4);
  l.w1 = take(stats, G.C * hidden * 4);
  l.w2 = take(stats, G.C * hidden * 4);
  l.mean = take(planes, 2 * plane_size * 4);
  l.gate = take(fuse, npx * 4);
  l.pidx = take(planes, npx * 4);
  l.part = take(stats, slices * 2 * npx * 4);
  l.total = at;
  return l;
}

// The image-wide pool: one block a (b, c) plane.
template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
    rab_tail_pool_kernel(const T* __restrict__ t, float* __restrict__ avg,
                         float* __restrict__ mx, int n) {
  const long row = blockIdx.x;
  const T* p = t + row * static_cast<long>(n);
  float s = 0.f;
  float m = -CUDART_INF_F;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kPoolThreads) {
    const float v = sg::to_f32(p[i]);
    s += v;
    m = fmaxf(m, v);
  }
  s = sg::warp_sum(s);
  m = sg::warp_max(m);
  __shared__ float part_s[kPoolThreads / 32];
  __shared__ float part_m[kPoolThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    part_s[warp] = s;
    part_m[warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kPoolThreads / 32 ? part_s[lane] : 0.f;
    m = lane < kPoolThreads / 32 ? part_m[lane] : -CUDART_INF_F;
    s = sg::warp_sum(s);
    m = sg::warp_max(m);
    if (lane == 0) {
      avg[row] = s / static_cast<float>(n);
      mx[row] = m;
    }
  }
}

// Stage output channels [co0, co0 + kPass) of W' = diag(gate_c) W_fuse
// (C_in, C_out), zeros beyond C: float32 as TF32 high parts and residuals,
// [ci][kLdw] each; bfloat16 as [co][slab_ld] with the inputs along a row.
// A batch of loads ahead of its stores, as in load_async.
template <typename T>
__device__ inline void stage_slab(unsigned char* slab,
                                  const float* __restrict__ fuse_w,
                                  const float* s_gc, int C, int co0) {
  constexpr int kBatch = 8;
  const int kp = round_up(C, sizeof(T) == 4 ? 8 : 16);
  const int ld = slab_ld(C);
  uint32_t* hi = reinterpret_cast<uint32_t*>(slab);
  uint32_t* lo = hi + kp * kLdw;
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(slab);
  const int n = kp * kPass;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      const int ci = i / kPass;
      const int co = co0 + i - ci * kPass;
      v[j] = (i < n && ci < C && co < C) ? fuse_w[ci * C + co] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i >= n) break;
      const int ci = i / kPass;
      const int col = i - ci * kPass;
      const float scaled = v[j] * s_gc[min(ci, C - 1)];
      if constexpr (sizeof(T) == 4) {
        split_tf32(scaled, hi[ci * kLdw + col], lo[ci * kLdw + col]);
      } else {
        wb[col * ld + ci] = __float2bfloat16(scaled);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pair_bits(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One 16-pixel x 32-channel tile of the fuse: pixels 16 mt .. of the strip's
// n, output channels co0 + 32 nh ...  vt reads the copy of t.
template <typename T>
__device__ __forceinline__ void fuse_tile(
    const StripView<T> vt, const float* s_gate, const unsigned char* slab,
    const float* s_bias, const T* __restrict__ xs, T* __restrict__ os,
    long plane, int C, int n, int mt, int co0, int nh) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int pa = mt * 16 + gq;
  const int pb = pa + 8;
  const bool va = pa < n;
  const bool vb = pb < n;
  const int ra = va ? pa : 0;  // a pixel that is safe to read
  const int rb = vb ? pb : 0;
  const int cbase = co0 + nh * 32;

  float acc[4][4];
  float xr[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[nt][e] = 0.f;
      const int co = cbase + nt * 8 + 2 * tq + (e & 1);
      const bool ok = co < C && (e < 2 ? va : vb);
      xr[nt][e] = ok ? sg::to_f32(xs[co * plane + (e < 2 ? pa : pb)]) : 0.f;
    }
  }

  if constexpr (sizeof(T) == 4) {
    const int kp = round_up(C, 8);
    const uint32_t* whi = reinterpret_cast<const uint32_t*>(slab);
    const uint32_t* wlo = whi + kp * kLdw;
    // The tensor cores cut the float32 accumulator after every product, so
    // a chain of products carries a bias that grows with its length, the
    // same way for every pixel.  The large term (high . high) therefore
    // starts from zero at every step and joins the sum by a rounded add;
    // the two small terms run as one chain, whose bias is 2^-11 of that.
    float small[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) small[nt][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < kp; k0 += 8) {
      const int cl = k0 + tq;
      // channels beyond C meet zero rows of W'
      const auto k_lo = vt.at(min(cl, C - 1));
      const auto k_hi = vt.at(min(cl + 4, C - 1));
      const SplitA a = split_a(vt.get(k_lo, ra), vt.get(k_lo, rb),
                               vt.get(k_hi, ra), vt.get(k_hi, rb));
      const int at = cl * kLdw + nh * 32 + gq;
      float large[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) large[nt][e] = 0.f;
        mma_tf32(large[nt], a.hi, whi[at + nt * 8],
                 whi[at + nt * 8 + 4 * kLdw]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_tf32(small[nt], a.lo, whi[at + nt * 8],
                 whi[at + nt * 8 + 4 * kLdw]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_tf32(small[nt], a.hi, wlo[at + nt * 8],
                 wlo[at + nt * 8 + 4 * kLdw]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += large[nt][e];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += small[nt][e];
  } else {
    const int kp = round_up(C, 16);
    const int ld = slab_ld(C);
    const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(slab);
#pragma unroll 2
    for (int k0 = 0; k0 < kp; k0 += 16) {
      const int cl = k0 + 2 * tq;
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // channels cl, cl + 1, then + 8
        const auto k0c = vt.at(min(cl + 8 * h, C - 1));
        const auto k1c = vt.at(min(cl + 8 * h + 1, C - 1));
        a[2 * h] = pair_bits(vt.raw(k0c, ra), vt.raw(k1c, ra));
        a[2 * h + 1] = pair_bits(vt.raw(k0c, rb), vt.raw(k1c, rb));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* row = wb + (nh * 32 + nt * 8 + gq) * ld + cl;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + 8);
        mma_bf16_k16(acc[nt], a, b0, b1);
      }
    }
  }

  const float ga = va ? s_gate[pa] : 0.f;
  const float gb = vb ? s_gate[pb] : 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = cbase + nt * 8 + 2 * tq + (e & 1);
      if (co < C && (e < 2 ? va : vb))
        os[co * plane + (e < 2 ? pa : pb)] = sg::from_f32<T>(
            acc[nt][e] * (e < 2 ? ga : gb) + s_bias[co] + xr[nt][e]);
    }
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, min_blocks_of(kMode))
    rab_tail_kernel(const T* __restrict__ t, const T* __restrict__ x_res,
                    const float* __restrict__ w1, const float* __restrict__ w2,
                    const float* __restrict__ slam_w,
                    const float* __restrict__ fuse_w,
                    const float* __restrict__ fuse_b, T* __restrict__ out,
                    float* __restrict__ gate_c, float* __restrict__ gate_s,
                    float* __restrict__ mean_u, float* __restrict__ max_u,
                    const float* __restrict__ avg_t,
                    const float* __restrict__ max_t, const Geom G,
                    const int hidden, const int slices) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int C = G.C;
  const int W = G.W;
  const int wp = plane_width(W);
  const int npx_max = G.rmax * W;
  const int plane_size = (G.rmax + 2 * kPad) * wp;
  const Layout L = layout_of(kMode, G, hidden, slices, sizeof(T));
  const auto floats = [&](int at) { return reinterpret_cast<float*>(smem + at); };

  T* s_t = reinterpret_cast<T*>(smem);
  unsigned char* s_slab = smem + L.slab;
  float* s_taps = floats(L.taps);
  float* s_gc = floats(L.gc);      // (C,)
  float* s_bias = floats(L.bias);  // (C,): b_fuse
  float* s_pool = floats(L.pool);  // (2, C): avg_t, max_t
  float* s_hid = floats(L.hid);    // (2, hidden)
  float* s_w1 = floats(L.w1);      // (C, hidden)
  float* s_w2 = floats(L.w2);      // (hidden, C)
  float* s_mean = floats(L.mean);  // two padded planes in a row
  float* s_max = s_mean + plane_size;
  float* s_gate = floats(L.gate);
  int* s_pidx = reinterpret_cast<int*>(smem + L.pidx);
  float* s_part = floats(L.part);

  if (kMode == kPlanes) stage_taps(s_taps, slam_w);
  if (kMode == kStats) {
    for (int i = tid; i < C * hidden; i += kThreads) {
      s_w1[i] = w1[i];
      s_w2[i] = w2[i];
    }
  }
  if (kMode == kStream)
    for (int c = tid; c < C; c += kThreads) s_bias[c] = fuse_b[c];

  const long plane = static_cast<long>(G.H) * W;
  const Rows r = rows_of(G, blockIdx.y);
  const int npx = r.npx;

  for (int b = blockIdx.z; b < G.B; b += gridDim.z) {
    const long off = static_cast<long>(b) * C * plane +
                     static_cast<long>(r.r0) * W;
    const long poff = static_cast<long>(b) * plane +
                      static_cast<long>(r.r0) * W;
    const T* ts = t + off;

    if (kMode == kStats) {
      // ---- the CLAM's gate from the pooled vectors, in every block
      for (int c = tid; c < C; c += kThreads) {
        s_pool[c] = avg_t[b * C + c];
        s_pool[C + c] = max_t[b * C + c];
      }
      __syncthreads();
      for (int j = warp; j < 2 * hidden; j += kWarps) {
        const float* src = s_pool + (j / hidden) * C;
        const int jj = j % hidden;
        float h = 0.f;
        for (int c = lane; c < C; c += 32) h += src[c] * s_w1[c * hidden + jj];
        h = sg::warp_sum(h);
        if (lane == 0) s_hid[j] = fmaxf(h, 0.f);
      }
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {
        float za = 0.f;
        float zm = 0.f;
        for (int j = 0; j < hidden; ++j) {
          const float wj = s_w2[j * C + c];
          za += s_hid[j] * wj;
          zm += s_hid[hidden + j] * wj;
        }
        const float gc = 1.f / (1.f + expf(-(za + zm)));
        s_gc[c] = gc;
        if (blockIdx.y == 0) gate_c[b * C + c] = gc;
      }
      __syncthreads();

      // ---- mean_c and max_c of u = t * gate_c, by slices of the channels
      const StripView<T> vt = make_view<T>(ts, nullptr, plane, 0);
      for (int i = tid; i < slices * npx; i += kThreads) {
        const int sl = i / npx;
        const int p = i - sl * npx;
        const int c0 = sl * C / slices;
        const int c1 = (sl + 1) * C / slices;
        auto k = vt.at(c0);
        float s = 0.f;
        float m = -CUDART_INF_F;
#pragma unroll 8
        for (int c = c0; c < c1; ++c) {
          // one rounded product, as the backward recomputes u, so that the
          // stored max equals an element of u bit for bit
          const float v = __fmul_rn(vt.get(k, p), s_gc[c]);
          s += v;
          m = fmaxf(m, v);
          vt.next(k);
        }
        s_part[sl * 2 * npx_max + p] = s;
        s_part[(sl * 2 + 1) * npx_max + p] = m;
      }
      __syncthreads();
      for (int p = tid; p < npx; p += kThreads) {
        float s = 0.f;
        float m = -CUDART_INF_F;
        for (int sl = 0; sl < slices; ++sl) {
          s += s_part[sl * 2 * npx_max + p];
          m = fmaxf(m, s_part[(sl * 2 + 1) * npx_max + p]);
        }
        mean_u[poff + p] = s / static_cast<float>(C);
        max_u[poff + p] = m;
      }
      __syncthreads();  // the partials are free for the next image
      continue;
    }

    if (kMode == kPlanes) {
      // ---- the 7x7 stencil and its sigmoid, the halo from the planes
      for (int i = tid; i < 2 * plane_size; i += kThreads) s_mean[i] = 0.f;
      for (int p = tid; p < npx; p += kThreads) {
        const int y = p / W;
        s_pidx[p] = (y + kPad) * wp + (p - y * W) + kPad;
      }
      __syncthreads();
      load_planes(s_mean, 2, plane_size, mean_u, max_u - mean_u,
                  static_cast<long>(b) * plane, G, r);
      __syncthreads();
      for (int p = tid; p < npx; p += kThreads) {
        const int at = s_pidx[p] - kPad * wp - kPad;
        float acc = 0.f, acc2 = 0.f;  // two chains of sums, not one
#pragma unroll
        for (int dy = 0; dy < kK; ++dy) {
          float wr[16];
          load_taps(wr, s_taps, dy);
#pragma unroll
          for (int dxx = 0; dxx < kK; ++dxx) {
            acc += wr[dxx] * s_mean[at + dy * wp + dxx];
            acc2 += wr[8 + dxx] * s_max[at + dy * wp + dxx];
          }
        }
        gate_s[poff + p] = 1.f / (1.f + expf(-(acc + acc2)));
      }
      __syncthreads();  // the planes are free for the next image
      continue;
    }

    // ---- kStream: 1x1 fuse + bias + residual on the tensor cores
    load_async(s_t, ts, plane, npx, C, G.stride);
    cp_async_commit();
    // the residual is wanted last: have it in the L2 by then
    prefetch_l2(x_res + off, plane, npx, C);
    for (int c = tid; c < C; c += kThreads) s_gc[c] = gate_c[b * C + c];
    for (int p = tid; p < npx; p += kThreads) s_gate[p] = gate_s[poff + p];
    __syncthreads();
    stage_slab<T>(s_slab, fuse_w, s_gc, C, 0);  // while the copy is on its way
    cp_async_wait<0>();
    __syncthreads();
    const StripView<T> vt = make_view<T>(ts, s_t, plane, G.stride);
    const int nmt = (npx + 15) / 16;
    const int npass = (C + kPass - 1) / kPass;
    for (int pass = 0; pass < npass; ++pass) {
      if (pass > 0) {
        __syncthreads();  // the slab before has been consumed
        stage_slab<T>(s_slab, fuse_w, s_gc, C, pass * kPass);
        __syncthreads();
      }
      if (pass * kPass + (warp & 1) * 32 >= C) continue;  // no such channels
      for (int mt = warp >> 1; mt < nmt; mt += kWarps / 2)
        fuse_tile<T>(vt, s_gate, s_slab, s_bias, x_res + off, out + off, plane,
                     C, npx, mt, pass * kPass, warp & 1);
    }
    __syncthreads();  // the copy and the slab are free for the next image
  }
}

template <typename T>
bool choose_for(int B, int C, int hidden, int H, int W, Plan* plan) {
  return choose(
      [hidden](int mode, const Geom& G, int slices) {
        return layout_of(mode, G, hidden, slices, sizeof(T)).total;
      },
      B, C, H, W, sizeof(T), 0, 4, 2, plan);
}

template <typename T>
int launch_all(const void* t, const void* x_res, const float* w1,
               const float* w2, const float* slam_w, const float* fuse_w,
               const float* fuse_b, void* out, float* gate_c, float* gate_s,
               float* mean_u, float* max_u, float* avg_t, float* max_t, int B,
               int C, int hidden, int H, int W, const Plan& plan,
               cudaStream_t stream) {
  const T* tt = static_cast<const T*>(t);
  rab_tail_pool_kernel<T><<<B * C, kPoolThreads, 0, stream>>>(tt, avg_t, max_t,
                                                              H * W);
  cudaError_t err = cudaGetLastError();
  const auto run = [&](auto kernel, int mode, int nstrips) {
    const Geom G = geom_for(B, C, H, W, sizeof(T), 0, nstrips);
    return launch(kernel, G, 0,
                  layout_of(mode, G, hidden, plan.slices, sizeof(T)).total,
                  stream, tt, static_cast<const T*>(x_res), w1, w2, slam_w,
                  fuse_w, fuse_b, static_cast<T*>(out), gate_c, gate_s, mean_u,
                  max_u, static_cast<const float*>(avg_t),
                  static_cast<const float*>(max_t), G, hidden, plan.slices);
  };
  if (err == cudaSuccess)
    err = run(rab_tail_kernel<T, kStats>, kStats, plan.stats_strips);
  if (err == cudaSuccess)
    err = run(rab_tail_kernel<T, kPlanes>, kPlanes, plan.bands);
  if (err == cudaSuccess)
    err = run(rab_tail_kernel<T, kStream>, kStream, plan.stream_strips);
  return static_cast<int>(err);
}

}  // namespace

// The launches for this shape (strip.cuh: choose): out[0..5] as
// sg_spatial_gate_bwd_plan, out[5] = 0.
extern "C" int sg_rab_tail_plan(int B, int C, int hidden, int H, int W,
                                int dtype, int* out) {
  Plan plan;
  if ((dtype != sg::kFloat32 && dtype != sg::kBFloat16) || C > 256 ||
      hidden < 1 || hidden > C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(dtype == sg::kFloat32
            ? choose_for<float>(B, C, hidden, H, W, &plan)
            : choose_for<__nv_bfloat16>(B, C, hidden, H, W, &plan)))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = plan.bands;
  out[1] = plan.stats_strips;
  out[2] = plan.stream_strips;
  out[3] = plan.slices;
  out[4] = plan.shared_bytes;
  out[5] = 0;
  return 0;
}

// t, x_res, out: (B, C, H, W) contiguous of one type.  Float32: w1
// (C, hidden), w2 (hidden, C), slam_w (1, 2, 7, 7), fuse_w (C_in, C_out),
// fuse_b (C,); outputs gate_c, avg_t, max_t (B, C) and gate_s, mean_u, max_u
// (B, H, W).  C is at most 256 and hidden at most C: the staged slab of W'
// and the MLP's weights then fit a block's shared memory.  bands,
// stats_strips, stream_strips, slices: the plan's out[0..3].
extern "C" int sg_rab_tail(const void* t, const void* x_res, const void* w1,
                           const void* w2, const void* slam_w,
                           const void* fuse_w, const void* fuse_b, void* out,
                           void* gate_c, void* gate_s, void* mean_u,
                           void* max_u, void* avg_t, void* max_t, int B, int C,
                           int hidden, int H, int W, int dtype, int bands,
                           int stats_strips, int stream_strips, int slices,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 256 || hidden < 1 || hidden > C || bands < 1 || stats_strips < 1 ||
      stream_strips < 1 || slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan{bands, stats_strips, stream_strips, slices, 0};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  if (dtype == sg::kFloat32)
    return launch_all<float>(t, x_res, f(w1), f(w2), f(slam_w), f(fuse_w),
                             f(fuse_b), out, g(gate_c), g(gate_s), g(mean_u),
                             g(max_u), g(avg_t), g(max_t), B, C, hidden, H, W,
                             plan, st);
  if (dtype == sg::kBFloat16)
    return launch_all<__nv_bfloat16>(
        t, x_res, f(w1), f(w2), f(slam_w), f(fuse_w), f(fuse_b), out,
        g(gate_c), g(gate_s), g(mean_u), g(max_u), g(avg_t), g(max_t), B, C,
        hidden, H, W, plan, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
