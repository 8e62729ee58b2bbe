// Row strips of an NCHW image: what the SLAM gate backward
// (spatial_gate_bwd.cu) and the fused RAB tail (rab_tail.cu) share.
//
// Both kernels carry a 7x7 stencil of per-pixel channel statistics between
// two passes over full-size tensors: a reduction over the channels before it
// and an elementwise pass after it.  Square tiles pay for the stencil's halo
// in both directions on the full-size tensors (a 16x16 tile reads 22x22), and
// 54 = 3 * 16 + 6 leaves 29 % of a 16x16 grid's threads without a pixel.
// Here the work goes by strips of whole rows, per channel one contiguous
// span with no ragged columns, in three launches:
//   kStats   the per-pixel channel statistics, over strips of a row or two
//            (many short blocks an SM, each with its loads in flight), to
//            float32 planes in global memory: 1 / C of a tensor, so they
//            stay in the L2;
//   kPlanes  the stencils on those planes, over bands of a few rows, the
//            band's halo read from the planes: the only place a halo is
//            paid for, and on the small planes only;
//   kStream  the full-size outputs, over small strips again, from the
//            per-pixel values the launch before left.
// The full-size tensors are read twice, the second time from the L2 (they
// were just read), and never on a halo.
//
// A design that reads them once was built first and measured: a thread-block
// cluster an image, each block's strip kept in shared memory, the planes'
// halo rows exchanged through distributed shared memory at cluster barriers,
// all stages in one launch.  Its stages end in barriers, so it needs every
// image's cluster on the card at once, and an H100 places 15 clusters of 8
// blocks that each fill an SM (7 of 16): a batch of 16 took two rounds, and
// at the batches that fit, the chain of stages on one block an SM was slower
// than these launches of many small blocks (PERF.md, section 6).
//
// Where a kernel wants a strip in shared memory (the fused tail's tensor-core
// product reads it in fragments), the copy keeps each span's alignment: a
// span starts wherever its channel plane and first row put it (a 54x54
// bfloat16 plane is 5 832 B, not a multiple of 16), so channel c lies at
// c * stride + phase(c), phase(c) = (its global address mod 16) / sizeof(T),
// the body of every span moves by aligned 16-byte cp.async whatever the
// shape or view, and only the few head and tail elements move one by one.
#pragma once

#include "sgam_mma.cuh"

namespace sg {
namespace strip {

using attn::cp_async;
using attn::cp_async_commit;
using attn::cp_async_wait;

constexpr int kK = 7;
constexpr int kPad = kK / 2;
constexpr int kTaps = 2 * kK * kK;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// What a kernel instance does.
constexpr int kStats = 0;
constexpr int kPlanes = 1;
constexpr int kStream = 2;
constexpr int kMaxShared = 232448;  // bytes a block may ask for on sm_90
constexpr int kMaxGridZ = 65535;

// One launch's geometry, the same for every block.
struct Geom {
  int B, C, H, W;
  int nstrips;  // strips an image (grid y)
  int rows;     // rows a strip writes
  int reach;    // rows beside them that its block also works on
  int rmax;     // most rows a block works on
  int stride;   // elements between two channels of a shared-memory copy
};

// Rows of the image seen by one block: the rows [r0, r1) it works on (its
// strip and `reach` rows beside it, inside the image) and the pixels
// [plo, phi) of them, counted from r0, that are the strip's own.
struct Rows {
  int r0, r1, npx, plo, phi;
};

__device__ inline Rows rows_of(const Geom& G, int strip) {
  const int y0 = strip * G.rows;
  const int y1 = min(G.H, y0 + G.rows);
  Rows r;
  r.r0 = max(0, y0 - G.reach);
  r.r1 = min(G.H, y1 + G.reach);
  r.npx = (r.r1 - r.r0) * G.W;
  r.plo = (y0 - r.r0) * G.W;
  r.phi = (y1 - r.r0) * G.W;
  return r;
}

// ---- a tensor's strip ---------------------------------------------------------

// Elements between channels of a shared-memory copy: room for the strip and
// the largest phase, a multiple of 16 bytes, and 8 mod 32, so that a
// tensor-core A fragment (8 pixels x 4 channels a load) meets no bank twice.
__host__ __device__ inline int strip_stride(int rmax, int W, int elem_size) {
  const int need = rmax * W + 16 / elem_size - 1;
  return need + ((8 - need % 32) + 32) % 32;
}

// One tensor's strip as a kernel reads it: from global memory, or from a
// shared-memory copy.  A cursor walks the channels of one pixel column:
// `row` is the channel's first element, `a` the copy's phase in bytes.
template <typename T>
struct StripView {
  static constexpr int kShift = sizeof(T) == 4 ? 2 : 1;
  const T* base;   // channel 0: the strip in global memory, or the copy
  long step;       // elements between channels there
  unsigned a0;     // the copy's phase of channel 0 in bytes (0: no copy)
  unsigned pstep;  // a plane's bytes mod 16 (0: no copy)

  struct Cursor {
    const T* row;
    unsigned a;
  };
  __device__ __forceinline__ Cursor at(int c) const {
    Cursor k;
    k.row = base + c * step;
    k.a = (a0 + c * pstep) & 15u;
    return k;
  }
  __device__ __forceinline__ void next(Cursor& k) const {
    k.row += step;
    k.a = (k.a + pstep) & 15u;
  }
  __device__ __forceinline__ T raw(const Cursor& k, int p) const {
    return k.row[(k.a >> kShift) + p];
  }
  __device__ __forceinline__ float get(const Cursor& k, int p) const {
    return to_f32(raw(k, p));
  }
};

template <typename T>
__device__ inline StripView<T> make_view(const T* global, const T* shared,
                                         long plane, int stride) {
  StripView<T> v;
  const bool copied = shared != nullptr;
  v.base = copied ? shared : global;
  v.step = copied ? stride : plane;
  v.a0 = copied
             ? static_cast<unsigned>(reinterpret_cast<uintptr_t>(global) & 15u)
             : 0u;
  v.pstep = copied ? static_cast<unsigned>((plane * sizeof(T)) & 15) : 0u;
  return v;
}

// Start the copy of n elements a channel, C channels.  The 16-byte bodies go
// a warp a channel at a time, by cp.async; the few elements before and after
// a body, which no aligned 16-byte copy reaches, go through registers, a
// batch of loads ahead of its stores so that a thread waits for device
// memory once, not once an element.  The caller commits, waits and
// synchronises.
template <typename T>
__device__ inline void load_async(T* shared, const T* global, long plane,
                                  int n, int C, int stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kEdge = 2 * (kVec - 1);  // head and tail slots a channel
  constexpr int kBatch = 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const auto phase_of = [&](int c) {
    return static_cast<int>(
        (reinterpret_cast<uintptr_t>(global + c * plane) & 15u) / sizeof(T));
  };
  for (int c = warp; c < C; c += kWarps) {
    const T* src = global + c * plane;
    const int phase = phase_of(c);
    T* dst = shared + c * stride + phase;
    const int head = min(n, (kVec - phase) % kVec);
    const int nvec = (n - head) / kVec;
    for (int v = lane; v < nvec; v += 32)
      cp_async<16>(dst + head + v * kVec, src + head + v * kVec, 16);
  }
  for (int e0 = threadIdx.x; e0 < C * kEdge; e0 += kBatch * kThreads) {
    T value[kBatch];
    int at[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      at[j] = -1;
      if (e >= C * kEdge) continue;
      const int c = e / kEdge;
      const int k = e - c * kEdge;
      const int phase = phase_of(c);
      const int head = min(n, (kVec - phase) % kVec);
      // slots 0 .. kVec - 2 are the head's, the rest the tail's
      const int i = k < kVec - 1
                        ? (k < head ? k : -1)
                        : head + (n - head) / kVec * kVec + k - (kVec - 1);
      if (i < 0 || i >= n) continue;
      value[j] = global[c * plane + i];
      at[j] = c * stride + phase + i;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (at[j] >= 0) shared[at[j]] = value[j];
  }
}

// Ask for `n` elements from `src` on, a channel, to be brought into the L2:
// for a tensor a later stage of the block reads straight from global memory.
template <typename T>
__device__ inline void prefetch_l2(const T* src, long plane, int n, int C) {
  const int lines = (n * static_cast<int>(sizeof(T)) + 127) / 128;
  for (int i = threadIdx.x; i < C * lines; i += kThreads) {
    const int c = i / lines;
    const char* p = reinterpret_cast<const char*>(src + c * plane) +
                    (i - c * lines) * 128;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
  }
}

// ---- float32 planes with a zero border ---------------------------------------
//
// A shared-memory plane covers a block's rows and kPad rows above and below,
// each row W + 2 kPad wide; the border is the SAME convolution's zero
// padding.

__device__ __forceinline__ int plane_width(int W) { return W + 2 * kPad; }

// Rows [r0 - kPad, r1 + kPad) of the image into `nplanes` shared-memory
// planes (`plane_size` floats apart), from global (B, H, W) planes `gstep`
// floats apart; rows outside the image stay as they are (zero).  `image` is
// the image's offset in a global plane.
__device__ inline void load_planes(float* planes, int nplanes, int plane_size,
                                   const float* gplanes, long gstep,
                                   long image, const Geom& G, const Rows& r) {
  const int wp = plane_width(G.W);
  const int lo = max(0, r.r0 - kPad);
  const int n = (min(G.H, r.r1 + kPad) - lo) * G.W;
#pragma unroll 4
  for (int i = threadIdx.x; i < n * nplanes; i += kThreads) {
    const int pl = i / n;
    const int j = i - pl * n;
    const int row = j / G.W;
    planes[pl * plane_size + (lo + row - r.r0 + kPad) * wp + kPad + j -
           row * G.W] = gplanes[pl * gstep + image + lo * G.W + j];
  }
}

// The stencil's taps in shared memory as [dy][16]: 7 of the mean plane, a
// gap, 7 of the max plane, a gap, so that a row of taps is four float4.
constexpr int kTapFloats = kK * 16;

__device__ inline void stage_taps(float* s_w, const float* __restrict__ w) {
  if (threadIdx.x < kTaps) {  // OIHW (1, 2, 7, 7)
    const int pl = threadIdx.x / (kK * kK);
    const int k = threadIdx.x - pl * kK * kK;
    s_w[(k / kK) * 16 + pl * 8 + k % kK] = w[threadIdx.x];
  }
}

// One row of taps: wr[dx] the mean plane's, wr[8 + dx] the max plane's.
__device__ __forceinline__ void load_taps(float (&wr)[16], const float* s_w,
                                          int dy) {
  const float4* row = reinterpret_cast<const float4*>(s_w + dy * 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = row[i];
    wr[4 * i + 0] = v.x;
    wr[4 * i + 1] = v.y;
    wr[4 * i + 2] = v.z;
    wr[4 * i + 3] = v.w;
  }
}

// ---- choosing and making a launch -------------------------------------------------

inline Geom geom_for(int B, int C, int H, int W, int elem_size, int reach,
                     int nstrips) {
  Geom G;
  G.B = B; G.C = C; G.H = H; G.W = W;
  G.reach = reach;
  G.rows = (H + nstrips - 1) / nstrips;
  G.nstrips = (H + G.rows - 1) / G.rows;
  G.rmax = min(H, G.rows + 2 * reach);
  G.stride = strip_stride(G.rmax, W, elem_size);
  return G;
}

struct Plan {
  int bands;          // strips an image of the planes launch
  int stats_strips;   // of the statistics launch
  int stream_strips;  // of the outputs' launch
  int slices;         // channel slices a pixel's reduction is cut into
  int shared_bytes;   // most shared memory a block of the three asks for
};

// The three launches' strips for one shape.  The planes launch: bands of
// rows enough to give every SM two blocks, three rows at the least (a band
// works on `reach` rows beside it).  The statistics launch: strips of as
// few rows as give every SM `stats_blocks` blocks; the outputs' launch:
// `stream_blocks` blocks (many short blocks where a block has little to set
// up, fewer and longer ones where it stages weights first).  Fewer rows
// where shared memory would not hold them (total_bytes(mode, G, slices)
// says what a block takes); false where it does not hold one row.
template <typename TotalBytes>
bool choose(TotalBytes total_bytes, int B, int C, int H, int W, int elem_size,
            int reach, int stats_blocks, int stream_blocks, Plan* plan) {
  const long rows = static_cast<long>(B) * H;
  const int sms = attn::sm_count();
  plan->slices = min(4, C);
  plan->shared_bytes = 0;
  const auto rows_for = [&](int blocks_an_sm, int least) {
    return static_cast<int>(min(
        static_cast<long>(H),
        max(static_cast<long>(least),
            (rows + blocks_an_sm * sms - 1) / (blocks_an_sm * sms))));
  };
  // the strips a launch of `mode` takes, from `r` rows down, or 0
  const auto fit = [&](int mode, int r, int mode_reach) {
    for (; r >= 1; --r) {
      const Geom G =
          geom_for(B, C, H, W, elem_size, mode_reach, (H + r - 1) / r);
      const int total = total_bytes(mode, G, plan->slices);
      if (total > kMaxShared) continue;
      plan->shared_bytes = max(plan->shared_bytes, total);
      return G.nstrips;
    }
    return 0;
  };
  plan->bands = fit(kPlanes, rows_for(2, 3), reach);
  plan->stats_strips = fit(kStats, rows_for(stats_blocks, 1), 0);
  plan->stream_strips = fit(kStream, rows_for(stream_blocks, 1), 0);
  return plan->bands > 0 && plan->stats_strips > 0 && plan->stream_strips > 0;
}

// One block a strip and image (a block walks over the images beyond the
// grid's reach), and `extra_strips` blocks more an image.  Dynamic shared
// memory above 48 KB has to be asked for, per kernel and device; asking at
// each launch costs a host call and keeps a second device right.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const Geom& G, int extra_strips,
                   int shared_bytes, cudaStream_t stream, Args... args) {
  if (shared_bytes > kMaxShared) return cudaErrorInvalidValue;
  const cudaError_t err = attn::allow_shared_bytes(kernel, shared_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(1, G.nstrips + extra_strips, min(G.B, kMaxGridZ));
  kernel<<<grid, kThreads, shared_bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace strip
}  // namespace sg
