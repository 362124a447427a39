// The adjoint of the NNGP Conv2d covariance map (the scaled box filter of
// csrc/boxfilter.cu) for Hopper (sm_90a).
//
// Replaces work that the JAX package leaves to XLA (no Pallas kernel): the
// VJP of cnn_gp_tpu/ops/boxfilter.py::box_filter_2d and of the scale and
// bias of cnn_gp_tpu/kernels.py::Conv2d.propagate that jax.grad derives
// inside cnn_gp_tpu/fit.py::_grad_chunk_jit and _probed_grad_chunk_jit.
// One launch takes up to three maps f (the xy, xx and yy fields of one
// Conv2d), each with the cotangent g_f [P_f, Wo, Ho] of its output and
// its input a_f [P_f, W, H], and computes per plane
//     t[w, h] = sum_{a, o : o s + a d - lo = w} sum_{c, q : q s + c d - lo
//               = h} g[o, q],
// the transposed shift-sum: the H pass first (u[o, h] over the taps c in
// order), then the W pass (over the taps a in order), each tap's term
// gathered by the input pixel it reads (o = (w + lo - a d) / s where that
// divides and lies in [0, Wo)), so no scatter and no atomics.  The map's
// output is its input cotangent t * scale (mode 0), t * scale * 0.5 (mode
// 1: a side map halved after a ReLU) or t itself (mode 2: the pair map
// through the ReLU prologue, whose adjoint, csrc/arccos_vjp.cu, takes t on
// with the scale), or nothing when not wanted.  With the leaf gradients
// asked for, d scale = sum_f sum <t_f, a_f> (a_f halved in mode 1; mode 2
// left to the ReLU's adjoint) and d bias = sum_f sum g_f are reduced in
// the same launch: each block's partial sums, one grid-wide barrier (a
// cooperative launch, csrc/launch.cuh), then block 0 adds the partials in
// order.  No float atomics: two runs give the same bits.  The plain
// version is cnn_gp_tpu_torch/ops/boxfilter.py::_vjp_reference; t adds
// the same terms in the same order, from +0.0 as its zero buffer does, so
// it is bit-equal to it.
//
// What bounds it: bytes.  A 128 x 128 tile of 28 x 28 maps with k = 7
// reads g (51 MB) and a (51 MB, for d scale) and writes t (51 MB), 46 us
// at 3.35 TB/s; the two passes are (k - 1) adds per pixel each.  The first
// version (a thread per pixel, each pixel's taps from a table in shared
// memory, fast_div index arithmetic, plain loads then a block barrier)
// was held back by that arithmetic instead: 0.28 (128 x 128, k = 7) to
// 0.42 (200 x 200, k = 3) of the bound on an H100, and just as long with
// its stores or its leaf sums turned off (chip_smoke.py phase 3c).  The
// design, as the forward's (csrc/boxfilter.cu):
//   - a persistent grid of kBlocksPerSM blocks per SM; a block walks a
//     contiguous share of runs of whole planes (about kRunInputs input
//     pixels a run), each run contiguous in memory;
//   - a ring of up to kMaxStages stages in dynamic shared memory: one
//     thread issues each run's g planes and a planes (the latter only
//     where d scale reads them) as one bulk asynchronous copy each
//     (cp.async.bulk, completion on an mbarrier; csrc/bulk_copy.cuh)
//     stages - 1 runs ahead of the run being computed; a tail under 16
//     bytes, or a run off a 16-byte boundary (a view), loads with scalar
//     loads in the same kernel;
//   - the geometries of the configs (kFixedGeometries: every geometry of
//     the forward's table and the paper ConvNet's 28 x 28 readout) as
//     template parameters.  A thread takes a segment of about kSegment
//     consecutive pixels of a row (the H pass) or a column (the W pass),
//     a multiple of the stride long, so each pixel's taps are constants
//     relative to the segment's start: the segment's source values are
//     loaded once into registers (zero where a tap falls outside the
//     map, which adds +0.0 and changes no bit) and every sum unrolls,
//     with no tap table and no division; where the output side is
//     shorter than the window (the readouts) the sum runs over the output
//     indices instead, each with its range check.  Every other geometry
//     takes the same kernel with run-time indices: the taps from a table
//     in shared memory (taps_of), divisions by multiply-high;
//   - the H pass writes [n, Wo, pitch] (pitch_of pads the rows so a
//     warp's stores spread over the banks), the W pass reads it, adds the
//     dot and writes each map's output over its staged input planes, and
//     the run's outputs leave in 16-byte stores;
//   - d bias from the staged g planes.  The fixed and run-time kernels
//     split the work among threads alike and take the same grid, so their
//     leaf sums too have the same bits.
// On an H100 a fixed geometry's launch takes 0.35-0.58 of the run-time
// kernel's time (chip_smoke.py, fixed_vs_runtime_vjp), and the k = 7 and
// k = 3 launches run at about 0.7 of the byte bound (phase 3c).
// A plane whose staging exceeds kMaxSmemBytes in one stage (a 160 x 160
// map, far above any config) is refused.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "fast_div.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;           // the grid: blocks per SM
constexpr int kMaxStages = 3;             // runs in flight per block
constexpr int kRunInputs = 3200;          // input pixels a run aims at
constexpr int kSegment = 8;               // pixels a thread takes, about
constexpr int kMaxSmemBytes = 100 * 1024;

enum Mode { kAsIs = 0, kHalf = 1, kRelu = 2 };

struct VMap {
  const float* g;      // [planes, Wo, Ho]
  const float* a;      // [planes, W, H]
  float* out;          // [planes, W, H] or null
  unsigned planes;
  unsigned runs;
  int mode;
};

// A pass's segments along one axis: `segs` of `len` pixels, len a
// multiple of the stride (so each segment starts on the same phase of it).
struct Segments {
  int len;
  int segs;
};

__host__ __device__ constexpr Segments segments_of(int n, int stride) {
  const int segs = (n + kSegment - 1) / kSegment;
  int len = (n + segs - 1) / segs;
  len = (len + stride - 1) / stride * stride;
  return Segments{len, (n + len - 1) / len};
}

__host__ __device__ constexpr int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

struct Args {
  VMap m0;
  VMap m1;
  VMap m2;
  int W, H, Wo, Ho, k, stride, lo, dil;
  int ppr;             // planes per run
  int stages;          // stages of the ring (1 .. kMaxStages)
  int g_floats;        // a stage's g planes (a multiple of 4), then its a
  int stage_floats;    // planes
  int hp;              // row pitch of the H pass's [ppr, Wo, hp] buffer
  Segments sh, sw;     // the H pass's segments along H, the W pass's
  FastDiv by_segs_h, by_h, by_segs_w;
  int affine;
  float scale;
  const float* scale_p;
  float* dscale;       // null: no leaf gradients
  float* dbias;
  float* partials;     // [2 * gridDim.x]
};

__device__ __forceinline__ VMap pick(const Args& A, int f) {
  return f == 0 ? A.m0 : (f == 1 ? A.m1 : A.m2);
}

// The run r of the flat run axis: its map, first plane and plane count.
struct Run {
  VMap m;
  unsigned first;
  int n;
};

__device__ __forceinline__ Run run_of(const Args& A, unsigned r) {
  int f = 0;
  if (r >= A.m0.runs) {
    r -= A.m0.runs;
    f = 1;
    if (r >= A.m1.runs) {
      r -= A.m1.runs;
      f = 2;
    }
  }
  Run run;
  run.m = pick(A, f);
  run.first = r * static_cast<unsigned>(A.ppr);
  const unsigned left = run.m.planes - run.first;
  run.n = static_cast<int>(left < static_cast<unsigned>(A.ppr) ? left
                                                               : A.ppr);
  return run;
}

// Whether the launch reads map m's input planes: for d scale.
__device__ __forceinline__ bool reads_a(const Args& A, const VMap& m) {
  return A.dscale != nullptr && m.mode != kRelu;
}

// Thread 0: start run r's copies into a stage.
__device__ __forceinline__ void issue(const Args& A, int in_size,
                                      int out_size, unsigned r,
                                      float* stage, uint64_t* bar) {
  const Run run = run_of(A, r);
  const float* g = run.m.g + static_cast<size_t>(run.first) * out_size;
  const unsigned bg = bulk_bytes(g, run.n * out_size);
  const float* a = run.m.a + static_cast<size_t>(run.first) * in_size;
  const unsigned ba = reads_a(A, run.m) ? bulk_bytes(a, run.n * in_size)
                                        : 0u;
  mbar_arrive_expect_tx(bar, bg + ba);
  if (bg != 0) bulk_load(stage, g, bg, bar);
  if (ba != 0) bulk_load(stage + A.g_floats, a, ba, bar);
}

// ---- a segment's sums along one axis ----

// A fixed geometry's segment: the LEN outputs i (pixels h0 + i of the
// pass's output side) of the transposed shift-sum along an axis whose
// source has NOUT entries (src[q * step]), each the sum over the taps j =
// 0 .. K - 1 in order of src[(h0 + i + LO - j) / STR] where that divides
// and lies in [0, NOUT), from +0.0.  h0 is a multiple of STR.
template <int K, int STR, int LO, int NOUT, int LEN>
__device__ __forceinline__ void segment_sums(const float* src, int step,
                                             int h0, float (&out)[LEN]) {
  if constexpr (NOUT < K) {
    // the readouts: over the NOUT sources in tap order (q falling), each
    // where its tap j lies in the window
    float v[NOUT];
#pragma unroll
    for (int q = 0; q < NOUT; ++q) v[q] = src[q * step];
#pragma unroll
    for (int i = 0; i < LEN; ++i) {
      float sum = 0.0f;
#pragma unroll
      for (int q = NOUT - 1; q >= 0; --q) {
        const int j = h0 + i + LO - q * STR;
        if (static_cast<unsigned>(j) < static_cast<unsigned>(K))
          sum = __fadd_rn(sum, v[q]);
      }
      out[i] = sum;
    }
  } else {
    // the sources the segment's taps reach, relative to q0 = h0 / STR,
    // zero outside [0, NOUT)
    constexpr int kR0 = floor_div(LO - K + 1, STR);
    constexpr int kR1 = floor_div(LEN - 1 + LO, STR);
    float v[kR1 - kR0 + 1];
    const int q0 = h0 / STR;
#pragma unroll
    for (int r = 0; r <= kR1 - kR0; ++r) {
      const int q = q0 + kR0 + r;
      v[r] = (q >= 0 && q < NOUT) ? src[q * step] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < LEN; ++i) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int d = i + LO - j;
        if (d % STR == 0) sum = __fadd_rn(sum, v[d / STR - kR0]);
      }
      out[i] = sum;
    }
  }
}

// The taps of one input pixel i along one axis of a run-time geometry:
// those j in 0 .. k - 1 whose numerator num = i + lo - j * dil divides by
// the stride into an output index o = num / stride in [0, n_out).  In tap
// order their o fall by a fixed step: {o of the first, count, step}.
__device__ __forceinline__ int4 taps_of(int i, int n_out, int k, int stride,
                                        int lo, int dil) {
  int4 r{0, 0, 0, 0};
  for (int j = 0; j < k; ++j) {
    const int num = i + lo - j * dil;
    if (num < 0) break;
    if (num % stride != 0 || num / stride >= n_out) continue;
    const int o = num / stride;
    if (r.y == 0) r.x = o;
    else if (r.y == 1) r.z = r.x - o;
    ++r.y;
  }
  return r;
}

// One pixel of a run-time geometry's pass: the sum, over its taps in
// order (tp), of p[o * step], from +0.0.
__device__ __forceinline__ float gather(const float* p, int4 tp, int step) {
  float sum = 0.0f;
  for (int c = 0; c < tp.y; ++c)
    sum = __fadd_rn(sum, p[(tp.x - c * tp.z) * step]);
  return sum;
}

// One input pixel's t after the W pass: its share of the dot with the
// staged input value at x, and the map's output written over x.
__device__ __forceinline__ void finish(float t, float* x, int mode,
                                       bool dot_here, bool out, int affine,
                                       float scale, float& dot) {
  if (dot_here) {
    const float a = mode == kHalf ? __fmul_rn(*x, 0.5f) : *x;
    dot = __fadd_rn(dot, __fmul_rn(t, a));
  }
  if (out) {
    float v = t;
    if (mode != kRelu) {
      if (affine) v = __fmul_rn(v, scale);
      if (mode == kHalf) v = __fmul_rn(v, 0.5f);
    }
    *x = v;
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(~0u, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total = __fadd_rn(total, red[w]);
  }
  __syncthreads();
  return total;
}

// n floats from shared memory (16-byte aligned) to dst, in 16-byte stores
// where dst is aligned.
__device__ __forceinline__ void store_run(const float* src, float* dst,
                                          int n, int t) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    const int n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int e = t; e < n4; e += kThreads) __stcs(d4 + e, s4[e]);
    head = n4 * 4;
  }
  for (int e = head + t; e < n; e += kThreads) __stcs(dst + e, src[e]);
}

template <int N, int K, int STR, int LO, int NO>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
box_vjp_kernel(const __grid_constant__ Args A, unsigned total_runs) {
  constexpr bool kFixed = N > 0;
  constexpr Segments kSeg = segments_of(kFixed ? N : 1, kFixed ? STR : 1);
  const int W = kFixed ? N : A.W, H = kFixed ? N : A.H;
  const int Wo = kFixed ? NO : A.Wo, Ho = kFixed ? NO : A.Ho;
  const Segments sh = kFixed ? kSeg : A.sh, sw = kFixed ? kSeg : A.sw;
  const int in_size = W * H, out_size = Wo * Ho, hp = A.hp;
  const int stages = A.stages;

  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  __shared__ float red[kThreads / 32];
  float* const us = smem + stages * A.stage_floats;   // [ppr, Wo, hp]
  // the run-time geometry's taps along H (th) and W (tw), 16-byte aligned
  int4* const th = reinterpret_cast<int4*>(us + ((A.ppr * Wo * hp + 3)
                                                 & ~3));
  int4* const tw = th + H;
  const int t = threadIdx.x;
  float scale = A.scale;
  if (A.affine && A.scale_p != nullptr) scale = *A.scale_p;
  const bool leaves = A.dscale != nullptr;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    fence_mbarrier_init();
    fence_proxy_async();
  }
  if constexpr (!kFixed) {
    for (int i = t; i < H + W; i += kThreads) {
      if (i < H)
        th[i] = taps_of(i, Ho, A.k, A.stride, A.lo, A.dil);
      else
        tw[i - H] = taps_of(i - H, Wo, A.k, A.stride, A.lo, A.dil);
    }
  }
  __syncthreads();
  const unsigned share = (total_runs + gridDim.x - 1) / gridDim.x;
  const unsigned r0 = blockIdx.x * share;
  const unsigned r_end = r0 + share < total_runs ? r0 + share : total_runs;
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      if (r0 + s < r_end)
        issue(A, in_size, out_size, r0 + s, smem + s * A.stage_floats,
              &bars[s]);
    }
  }
  float dot = 0.0f, bsum = 0.0f;

  for (unsigned it = 0;; ++it) {
    const unsigned r = r0 + it;
    if (r >= r_end) break;
    const int s = static_cast<int>(it % static_cast<unsigned>(stages));
    float* const gs = smem + s * A.stage_floats;   // [n, Wo, Ho]
    float* const as = gs + A.g_floats;             // [n, W, H]
    while (!mbar_try_wait(&bars[s], (it / stages) & 1u)) {
    }
    const Run run = run_of(A, r);
    const VMap& m = run.m;
    const int n = run.n;
    const bool dot_here = reads_a(A, m);
    const bool want_out = m.out != nullptr;
    const float* const gsrc = m.g + static_cast<size_t>(run.first)
                                    * out_size;
    const float* const asrc = m.a + static_cast<size_t>(run.first) * in_size;

    // 1. what the bulk copies left out (uniform over the block)
    const int ng = n * out_size, na = dot_here ? n * in_size : 0;
    const int bg = static_cast<int>(bulk_bytes(gsrc, ng) / 4);
    const int ba = dot_here ? static_cast<int>(bulk_bytes(asrc, na) / 4) : 0;
    if (bg < ng || ba < na) {
      for (int e = bg + t; e < ng; e += kThreads) gs[e] = gsrc[e];
      for (int e = ba + t; e < na; e += kThreads) as[e] = asrc[e];
      __syncthreads();
    }
    // 2. d bias
    if (leaves) {
      for (int e = t; e < ng; e += kThreads) bsum = __fadd_rn(bsum, gs[e]);
    }
    if (want_out || dot_here) {
      // 3. the H pass: u[pl, o, h] = sum over taps c of g[pl, o, q], a
      // thread a segment of a row (pl, o), segments fastest
      const int h_items = n * Wo * sh.segs;
      for (int item = t; item < h_items; item += kThreads) {
        const int row = static_cast<int>(
            divide<kFixed ? kSeg.segs : 0>(item, A.by_segs_h));
        const int h0 = (item - row * sh.segs) * sh.len;
        const float* const grow = gs + row * Ho;
        float* const urow = us + row * hp;
        if constexpr (kFixed) {
          float v[kSeg.len];
          segment_sums<K, STR, LO, NO, kSeg.len>(grow, 1, h0, v);
#pragma unroll
          for (int i = 0; i < kSeg.len; ++i) {
            if (kSeg.len * kSeg.segs == N || h0 + i < N) urow[h0 + i] = v[i];
          }
        } else {
          for (int h = h0; h < h0 + sh.len && h < H; ++h)
            urow[h] = gather(grow, th[h], 1);
        }
      }
      __syncthreads();

      // 4. the W pass, the dot, the map's output over its staged input:
      // a thread a segment of a column (pl, h), columns fastest
      const int w_items = n * sw.segs * H;
      for (int item = t; item < w_items; item += kThreads) {
        const int col = static_cast<int>(
            divide<kFixed ? N : 0>(item, A.by_h));
        const int h = item - col * H;
        const int pl = static_cast<int>(
            divide<kFixed ? kSeg.segs : 0>(col, A.by_segs_w));
        const int w0 = (col - pl * sw.segs) * sw.len;
        const float* const ucol = us + pl * Wo * hp + h;
        float* const x = as + pl * in_size + h;
        if constexpr (kFixed) {
          float v[kSeg.len];
          segment_sums<K, STR, LO, NO, kSeg.len>(ucol, hp, w0, v);
#pragma unroll
          for (int i = 0; i < kSeg.len; ++i) {
            if (kSeg.len * kSeg.segs == N || w0 + i < N)
              finish(v[i], x + (w0 + i) * N, m.mode, dot_here, want_out,
                     A.affine, scale, dot);
          }
        } else {
          for (int w = w0; w < w0 + sw.len && w < W; ++w)
            finish(gather(ucol, tw[w], hp), x + w * H, m.mode, dot_here,
                   want_out, A.affine, scale, dot);
        }
      }
      __syncthreads();

      // 5. the run's outputs
      if (want_out)
        store_run(as, m.out + static_cast<size_t>(run.first) * in_size,
                  n * in_size, t);
    }
    // every thread orders its accesses of the stage before the barrier,
    // after which one thread's bulk copy overwrites it
    fence_proxy_async();
    __syncthreads();
    if (t == 0) {
      const unsigned next = r + stages;
      if (next < r_end) issue(A, in_size, out_size, next, gs, &bars[s]);
    }
  }

  if (!leaves) return;
  const float d = block_sum(dot, red);
  const float b = block_sum(bsum, red);
  if (t == 0) {
    A.partials[2 * blockIdx.x] = d;
    A.partials[2 * blockIdx.x + 1] = b;
  }
  cooperative_groups::this_grid().sync();
  if (blockIdx.x != 0) return;
  float sd = 0.0f, sb = 0.0f;
  for (unsigned blk = t; blk < gridDim.x; blk += kThreads) {
    sd = __fadd_rn(sd, A.partials[2 * blk]);
    sb = __fadd_rn(sb, A.partials[2 * blk + 1]);
  }
  sd = block_sum(sd, red);
  sb = block_sum(sb, red);
  if (t == 0) {
    *A.dscale = sd;
    *A.dbias = sb;
  }
}

// ---- host side ----

template <int N, int K, int STR, int LO, int NO>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&box_vjp_kernel<N, K, STR, LO, NO>);
}

// The geometries with their own instantiation (map side, k, stride, lo,
// output side; dilation 1): those of csrc/boxfilter.cu's kFixedGeometries
// (the ResNet configs' 28/14/7 and 32/16/8 maps, the paper ConvNet's
// k = 7) and the paper ConvNet's 28 x 28 readout.
struct Fixed {
  int n, k, stride, lo, no;
  const void* (*kernel)();
};

constexpr Fixed kFixedGeometries[] = {
    {28, 3, 1, 1, 28, kernel_of<28, 3, 1, 1, 28>},
    {28, 1, 1, 0, 28, kernel_of<28, 1, 1, 0, 28>},
    {28, 1, 2, 0, 14, kernel_of<28, 1, 2, 0, 14>},
    {28, 3, 2, 1, 14, kernel_of<28, 3, 2, 1, 14>},
    {28, 4, 1, 1, 28, kernel_of<28, 4, 1, 1, 28>},
    {28, 7, 1, 3, 28, kernel_of<28, 7, 1, 3, 28>},
    {28, 28, 1, 0, 1, kernel_of<28, 28, 1, 0, 1>},
    {14, 3, 1, 1, 14, kernel_of<14, 3, 1, 1, 14>},
    {14, 1, 2, 0, 7, kernel_of<14, 1, 2, 0, 7>},
    {14, 3, 2, 1, 7, kernel_of<14, 3, 2, 1, 7>},
    {7, 3, 1, 1, 7, kernel_of<7, 3, 1, 1, 7>},
    {7, 7, 1, 0, 1, kernel_of<7, 7, 1, 0, 1>},
    {32, 3, 1, 1, 32, kernel_of<32, 3, 1, 1, 32>},
    {32, 1, 1, 0, 32, kernel_of<32, 1, 1, 0, 32>},
    {32, 1, 2, 0, 16, kernel_of<32, 1, 2, 0, 16>},
    {32, 3, 2, 1, 16, kernel_of<32, 3, 2, 1, 16>},
    {16, 3, 1, 1, 16, kernel_of<16, 3, 1, 1, 16>},
    {16, 1, 2, 0, 8, kernel_of<16, 1, 2, 0, 8>},
    {16, 3, 2, 1, 8, kernel_of<16, 3, 2, 1, 8>},
    {8, 3, 1, 1, 8, kernel_of<8, 3, 1, 1, 8>},
    {8, 8, 1, 0, 1, kernel_of<8, 8, 1, 0, 1>},
};

// The row pitch (H to H + 3) of the H pass's buffer at which a warp's
// stores, its lanes on consecutive (row, segment) items, touch the fewest
// lanes per shared-memory bank.
int pitch_of(int H, Segments s) {
  int best = H, best_ways = 33;
  for (int pad = 0; pad < 4; ++pad) {
    int count[32] = {};
    int ways = 0;
    for (int l = 0; l < 32; ++l) {
      const int bank = ((l / s.segs) * (H + pad) + (l % s.segs) * s.len) % 32;
      if (++count[bank] > ways) ways = count[bank];
    }
    if (ways < best_ways) {
      best_ways = ways;
      best = H + pad;
    }
  }
  return best;
}

int pad4(int n) { return (n + 3) & ~3; }

// The staging of a launch: planes per run, stages, the layout of a stage
// and the dynamic shared memory (ppr 0: a plane does not fit).
struct Plan {
  int ppr, stages, g_floats, stage_floats, hp, smem;
  Segments sh, sw;
};

Plan plan_of(int W, int H, int Wo, int Ho, int stride) {
  Plan p{};
  p.sh = segments_of(H, stride);
  p.sw = segments_of(W, stride);
  p.hp = pitch_of(H, p.sh);
  const long long in = static_cast<long long>(W) * H;
  const long long out = static_cast<long long>(Wo) * Ho;
  // a multiple of the planes that make whole 16-byte units of g and of a
  // (so every full run's bulk copies start aligned)
  auto unit = [](long long floats) { return floats % 4 == 0 ? 1
                                            : (floats % 2 == 0 ? 2 : 4); };
  const int mult = unit(out) > unit(in) ? unit(out) : unit(in);
  long long ppr = kRunInputs / in;
  ppr = ppr >= mult ? ppr - ppr % mult : (ppr < 1 ? 1 : ppr);
  auto bytes = [&](long long pp, int stages) {
    return (stages * (pad4(static_cast<int>(pp * out))
                      + pad4(static_cast<int>(pp * in)))
            + pad4(static_cast<int>(pp * Wo * p.hp))) * 4LL
           + (W + H) * 16LL;
  };
  if (4 * (in + out) > kMaxSmemBytes) return Plan{};   // not one plane
  int stages = kMaxStages;
  while (ppr > 1 && bytes(ppr, stages) > kMaxSmemBytes)
    ppr = ppr > mult ? ppr - mult : ppr - 1;
  while (stages > 1 && bytes(ppr, stages) > kMaxSmemBytes) --stages;
  if (bytes(ppr, stages) > kMaxSmemBytes) return Plan{};
  p.ppr = static_cast<int>(ppr);
  p.stages = stages;
  p.g_floats = pad4(static_cast<int>(ppr * out));
  p.stage_floats = p.g_floats + pad4(static_cast<int>(ppr * in));
  p.smem = static_cast<int>(bytes(ppr, stages));
  return p;
}

// The grid: kBlocksPerSM blocks per SM, the same for every instantiation,
// so the leaf sums split alike.
int grid_blocks(int device, int* blocks) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = kBlocksPerSM * sms;
  return 0;
}

VMap map_of(const float* g, const float* a, float* out, long long planes,
            int mode) {
  return VMap{g, a, out, static_cast<unsigned>(planes), 0u, mode};
}

int launch_vjp(const float* g0, const float* a0, float* out0, long long p0,
               int mode0, const float* g1, const float* a1, float* out1,
               long long p1, int mode1, const float* g2, const float* a2,
               float* out2, long long p2, int mode2, int W, int H, int Wo,
               int Ho, int k, int stride, int lo, int dilation, float scale,
               const float* scale_p, int affine, float* dscale, float* dbias,
               float* partials, int device, void* stream,
               bool runtime_geometry) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dscale == nullptr) != (dbias == nullptr)
      || (dscale != nullptr && partials == nullptr) || k < 1 || stride < 1
      || dilation < 1 || lo < 0 || W < 1 || H < 1 || Wo < 1 || Ho < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long planes = p0 + p1 + p2;
  const long long in_size = static_cast<long long>(W) * H;
  const long long out_size = static_cast<long long>(Wo) * Ho;
  if (planes * in_size > INT_MAX || planes * out_size > INT_MAX
      || static_cast<long long>(Wo) * (H + 3) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_of(W, H, Wo, Ho, stride);
  if (plan.ppr == 0) return static_cast<int>(cudaErrorInvalidValue);
  Args A{};
  A.m0 = map_of(g0, a0, out0, p0, mode0);
  A.m1 = map_of(g1, a1, out1, p1, mode1);
  A.m2 = map_of(g2, a2, out2, p2, mode2);
  const unsigned ppr = static_cast<unsigned>(plan.ppr);
  A.m0.runs = (A.m0.planes + ppr - 1) / ppr;
  A.m1.runs = (A.m1.planes + ppr - 1) / ppr;
  A.m2.runs = (A.m2.planes + ppr - 1) / ppr;
  unsigned total_runs = A.m0.runs + A.m1.runs + A.m2.runs;
  A.W = W;
  A.H = H;
  A.Wo = Wo;
  A.Ho = Ho;
  A.k = k;
  A.stride = stride;
  A.lo = lo;
  A.dil = dilation;
  A.ppr = plan.ppr;
  A.stages = plan.stages;
  A.g_floats = plan.g_floats;
  A.stage_floats = plan.stage_floats;
  A.hp = plan.hp;
  A.sh = plan.sh;
  A.sw = plan.sw;
  A.by_segs_h = make_fast_div(static_cast<unsigned>(plan.sh.segs));
  A.by_h = make_fast_div(static_cast<unsigned>(H));
  A.by_segs_w = make_fast_div(static_cast<unsigned>(plan.sw.segs));
  A.affine = affine;
  A.scale = scale;
  A.scale_p = scale_p;
  A.dscale = dscale;
  A.dbias = dbias;
  A.partials = partials;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // no planes: nothing to do, but for the two zero sums
  if (total_runs == 0 && dscale == nullptr) return 0;
  const void* kernel = kernel_of<0, 0, 0, 0, 0>();
  if (!runtime_geometry && dilation == 1 && W == H && Wo == Ho) {
    for (const Fixed& f : kFixedGeometries) {
      if (f.n == W && f.k == k && f.stride == stride && f.lo == lo
          && f.no == Wo) {
        kernel = f.kernel();
        break;
      }
    }
  }
  int blocks = 0, resident = 0;
  int e = grid_blocks(device, &blocks);
  if (e != 0) return e;
  e = co_resident_blocks(kernel, kThreads, plan.smem, kMaxSmemBytes, device,
                         &resident);
  if (e != 0) return e;
  if (resident < blocks) return static_cast<int>(cudaErrorInvalidConfiguration);
  unsigned grid = total_runs < static_cast<unsigned>(blocks)
                  ? total_runs : static_cast<unsigned>(blocks);
  if (grid == 0) grid = 1;
  void* args[] = {&A, &total_runs};
  if (dscale != nullptr)
    return launch_cooperative(kernel, grid, kThreads, args, plan.smem, st);
  const cudaError_t launched = cudaLaunchKernel(
      kernel, dim3(grid), dim3(kThreads), args,
      static_cast<size_t>(plan.smem), st);
  return static_cast<int>(launched != cudaSuccess ? launched
                                                  : cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of per-block partial sums (two per block of the persistent grid)
// that cnn_gp_box_filter_vjp takes to reduce its leaf gradients, for [W,
// H] planes filtered to [Wo, Ho].  Returns an error code (0 on success;
// cudaErrorInvalidValue when a plane's staging does not fit).
int cnn_gp_box_filter_vjp_partials(int W, int H, int Wo, int Ho, int device,
                                   int* floats) {
  *floats = 0;
  if (W < 1 || H < 1 || Wo < 1 || Ho < 1
      || plan_of(W, H, Wo, Ho, 1).ppr == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int err = grid_blocks(device, &blocks);
  if (err != 0) return err;
  *floats = 2 * blocks;
  return 0;
}

// Launches the adjoint over p0 + p1 + p2 planes (map f: cotangent g_f
// [p_f, Wo, Ho], input a_f [p_f, W, H], output out_f [p_f, W, H] or null,
// mode_f 0: t * scale, 1: t * scale * 0.5, 2: t; slot f unused when p_f ==
// 0) of the box filter of window k, stride, low padding lo and dilation on
// `stream`, and returns its error code (0 on success;
// cudaErrorInvalidValue for 2^31 elements or more or planes too large to
// stage; the card's refusal of a cooperative launch).  affine == 0 leaves
// out the scale (box_filter_2d); scale_p, when not null, points at the
// float32 scale on the card.  dscale and dbias: one float each for sum_f
// <t_f, a_f> over the maps of modes 0 and 1 (a_f halved in mode 1) and
// sum_f sum g_f, both null or both given with `partials` (the floats that
// cnn_gp_box_filter_vjp_partials gives); a launch with them is
// cooperative.  A geometry of kFixedGeometries takes its own
// instantiation.  Does not synchronise and allocates nothing.
int cnn_gp_box_filter_vjp(const float* g0, const float* a0, float* out0,
                          long long p0, int mode0, const float* g1,
                          const float* a1, float* out1, long long p1,
                          int mode1, const float* g2, const float* a2,
                          float* out2, long long p2, int mode2, int W, int H,
                          int Wo, int Ho, int k, int stride, int lo,
                          int dilation, float scale, const float* scale_p,
                          int affine, float* dscale, float* dbias,
                          float* partials, int device, void* stream) {
  return launch_vjp(g0, a0, out0, p0, mode0, g1, a1, out1, p1, mode1, g2,
                    a2, out2, p2, mode2, W, H, Wo, Ho, k, stride, lo,
                    dilation, scale, scale_p, affine, dscale, dbias,
                    partials, device, stream, false);
}

// cnn_gp_box_filter_vjp on the kernel with run-time indices, even where
// the geometry has its own instantiation (to compare and time the two).
int cnn_gp_box_filter_vjp_runtime_geometry(
    const float* g0, const float* a0, float* out0, long long p0, int mode0,
    const float* g1, const float* a1, float* out1, long long p1, int mode1,
    const float* g2, const float* a2, float* out2, long long p2, int mode2,
    int W, int H, int Wo, int Ho, int k, int stride, int lo, int dilation,
    float scale, const float* scale_p, int affine, float* dscale,
    float* dbias, float* partials, int device, void* stream) {
  return launch_vjp(g0, a0, out0, p0, mode0, g1, a1, out1, p1, mode1, g2,
                    a2, out2, p2, mode2, W, H, Wo, Ho, k, stride, lo,
                    dilation, scale, scale_p, affine, dscale, dbias,
                    partials, device, stream, true);
}

}  // extern "C"
