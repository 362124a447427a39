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
// the same terms in the same order, so it is bit-equal to it.
//
// The yardstick is its bytes: a 128 x 128 tile of 28 x 28 maps with
// k = 7 reads g (51 MB) and a (51 MB, for d scale) and writes t (51 MB),
// 46 us at 3.35 TB/s; the two passes are (k - 1) adds per pixel each.
// What holds it back is not its bytes but the per-tap index arithmetic
// of its passes: on an H100 (chip_smoke.py phase 3c) it ran at 0.28
// (128 x 128, k = 7) to 0.42 (200 x 200, k = 3) of that bound, and just
// as long with its stores or its leaf sums turned off.
//
// The design: a persistent grid whose blocks walk contiguous shares of
// runs of whole planes (about kRunInputs input pixels a run); a run's g
// planes are staged in shared memory, the H pass writes [n, Wo, H]
// there, and the W pass reads it and writes t coalesced, with a read in
// the same order for the dot; a thread issues kBatch global loads before
// it uses any.  Each pixel's taps along each axis (the first output index,
// the count, the step) are found once per block into a table in shared
// memory, so a pass visits the valid taps alone: with a loop over all k
// taps per pixel the launch took 1.7-1.9x as long at k = 3 and k = 7 on
// an H100 (chip_smoke.py phase 3c), and the 28 x 28 readout, whose pixel
// has one valid tap of 28, longer still.  Planes whose
// staging exceeds kMaxSmemBytes (an 80 x 80 output of a 160 x 160 map, far
// above any config) are refused.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fast_div.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRunFloats = 8192;          // staged floats a run takes
constexpr int kRunInputs = 4096;          // input pixels a run aims at
constexpr int kBatch = 4;                 // a thread's loads in flight
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

struct Args {
  VMap m0;
  VMap m1;
  VMap m2;
  int W, H, Wo, Ho, k, stride, lo, dil;
  FastDiv by_h, by_in, by_mid;
  int ppr;             // planes per run
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

// The taps of one input pixel i along one axis: those j in 0 .. k - 1
// whose numerator num = i + lo - j * dil divides by the stride into an
// output index o = num / stride in [0, n_out).  In tap order their o
// fall by a fixed step: {o of the first, count, step}.  Found once per
// pixel and block (a loop over the k taps), so a pass's sums visit the
// valid taps alone: the 28 x 28 readout's pixel has one of its 28.
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

// One pass of the transposed shift-sum at one pixel: the sum, over its
// taps in order (tp), of p[o * step], or 0.0 where it has none.
__device__ __forceinline__ float gather(const float* p, int4 tp, int step) {
  if (tp.y == 0) return 0.0f;
  float sum = p[tp.x * step];
  for (int c = 1; c < tp.y; ++c)
    sum = __fadd_rn(sum, p[(tp.x - c * tp.z) * step]);
  return sum;
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

__global__ void __launch_bounds__(kThreads)
box_vjp_kernel(const __grid_constant__ Args A, unsigned total_runs) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kThreads / 32];
  const int t = threadIdx.x;
  const int W = A.W, H = A.H, Wo = A.Wo, Ho = A.Ho, k = A.k;
  const int in_size = W * H, mid_size = Wo * H, out_size = Wo * Ho;
  float scale = A.scale;
  if (A.affine && A.scale_p != nullptr) scale = *A.scale_p;
  const bool leaves = A.dscale != nullptr;
  float* const gs = smem;                          // [ppr, Wo, Ho]
  float* const us = smem + A.ppr * out_size;       // [ppr, Wo, H]
  // each pixel's taps along H (th) and along W (tw), 16-byte aligned
  int4* const th = reinterpret_cast<int4*>(
      smem + ((A.ppr * (out_size + mid_size) + 3) & ~3));
  int4* const tw = th + H;
  for (int i = t; i < H + W; i += kThreads) {
    if (i < H)
      th[i] = taps_of(i, Ho, k, A.stride, A.lo, A.dil);
    else
      tw[i - H] = taps_of(i - H, Wo, k, A.stride, A.lo, A.dil);
  }
  __syncthreads();
  float dot = 0.0f, bsum = 0.0f;

  const unsigned share = (total_runs + gridDim.x - 1) / gridDim.x;
  const unsigned r0 = blockIdx.x * share;
  const unsigned r_end = r0 + share < total_runs ? r0 + share : total_runs;
  for (unsigned r = r0; r < r_end; ++r) {
    // the run's map, first plane and planes
    unsigned rr = r;
    int f = 0;
    if (rr >= A.m0.runs) {
      rr -= A.m0.runs;
      f = 1;
      if (rr >= A.m1.runs) {
        rr -= A.m1.runs;
        f = 2;
      }
    }
    const VMap m = pick(A, f);
    const unsigned first = rr * static_cast<unsigned>(A.ppr);
    const unsigned left = m.planes - first;
    const int n = static_cast<int>(left < static_cast<unsigned>(A.ppr)
                                   ? left : A.ppr);
    const float* const g = m.g + static_cast<size_t>(first) * out_size;
    const bool dot_here = leaves && m.mode != kRelu;
    const bool work = m.out != nullptr || dot_here;

    // 1. the cotangent planes into shared memory (and d bias), kBatch
    // loads a thread in flight
    const int n_g = n * out_size;
    for (int e0 = t; e0 < n_g; e0 += kBatch * kThreads) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        v[u] = e < n_g ? __ldcs(g + e) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= n_g) break;
        if (work) gs[e] = v[u];
        if (leaves) bsum = __fadd_rn(bsum, v[u]);
      }
    }
    if (!work) continue;           // uniform over the block: d bias alone
    __syncthreads();

    // 2. the H pass: u[pl, o, h] = sum over taps c of g[pl, o, q]
    for (int e = t; e < n * mid_size; e += kThreads) {
      const int pl = static_cast<int>(fast_div(e, A.by_mid));
      const int rem = e - pl * mid_size;
      const int o = static_cast<int>(fast_div(rem, A.by_h));
      const int h = rem - o * H;
      us[e] = gather(gs + pl * out_size + o * Ho, th[h], 1);
    }
    __syncthreads();

    // 3. the W pass, the scale, the mode; t written, a read for the dot
    // (its kBatch loads a thread issued before the sums)
    const size_t base = static_cast<size_t>(first) * in_size;
    const int n_in = n * in_size;
    for (int e0 = t; e0 < n_in; e0 += kBatch * kThreads) {
      float av[kBatch];
      if (dot_here) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          av[u] = e < n_in ? __ldcs(m.a + base + e) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= n_in) break;
        const int pl = static_cast<int>(fast_div(e, A.by_in));
        const int rem = e - pl * in_size;
        const int w = static_cast<int>(fast_div(rem, A.by_h));
        const int h = rem - w * H;
        const float sum = gather(us + pl * mid_size + h, tw[w], H);
        if (dot_here) {
          const float a = m.mode == kHalf ? __fmul_rn(av[u], 0.5f) : av[u];
          dot = __fadd_rn(dot, __fmul_rn(sum, a));
        }
        if (m.out != nullptr) {
          float v = sum;
          if (m.mode != kRelu) {
            if (A.affine) v = __fmul_rn(v, scale);
            if (m.mode == kHalf) v = __fmul_rn(v, 0.5f);
          }
          __stcs(m.out + base + e, v);
        }
      }
    }
    __syncthreads();               // the stage is read before the next run
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

// Planes per run and dynamic shared memory of a launch (ppr 0: a plane's
// staging does not fit).
struct Plan {
  int ppr;
  int smem;
};

Plan plan_of(int W, int H, int Wo, int Ho) {
  // about kRunInputs input pixels a run (so a small output, as the
  // readout's 1 x 1, still spreads its planes over the grid), within
  // kRunFloats of staging
  const int per = Wo * Ho + Wo * H;
  int ppr = kRunInputs / (W * H);
  if (ppr > kRunFloats / per) ppr = kRunFloats / per;
  if (ppr < 1) ppr = 1;
  // the planes, then each pixel's taps (an int4 a pixel of each axis)
  const long long bytes = ((static_cast<long long>(ppr) * per + 3) & ~3LL) * 4
                          + static_cast<long long>(W + H) * 16;
  if (bytes > kMaxSmemBytes) return Plan{0, 0};
  return Plan{ppr, static_cast<int>(bytes)};
}

const void* kernel_ptr() {
  return reinterpret_cast<const void*>(&box_vjp_kernel);
}

int grid_of(const Plan& plan, int device, int* blocks) {
  return co_resident_blocks(kernel_ptr(), kThreads, plan.smem, kMaxSmemBytes,
                            device, blocks);
}

VMap map_of(const float* g, const float* a, float* out, long long planes,
            int mode) {
  return VMap{g, a, out, static_cast<unsigned>(planes), 0u, mode};
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
  const Plan plan = plan_of(W, H, Wo, Ho);
  if (plan.ppr == 0) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int err = grid_of(plan, device, &blocks);
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
// cooperative.  Does not synchronise and allocates nothing.
int cnn_gp_box_filter_vjp(const float* g0, const float* a0, float* out0,
                          long long p0, int mode0, const float* g1,
                          const float* a1, float* out1, long long p1,
                          int mode1, const float* g2, const float* a2,
                          float* out2, long long p2, int mode2, int W, int H,
                          int Wo, int Ho, int k, int stride, int lo,
                          int dilation, float scale, const float* scale_p,
                          int affine, float* dscale, float* dbias,
                          float* partials, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((dscale == nullptr) != (dbias == nullptr)
      || (dscale != nullptr && partials == nullptr) || k < 1 || stride < 1
      || dilation < 1 || lo < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long planes = p0 + p1 + p2;
  const long long in_size = static_cast<long long>(W) * H;
  const long long out_size = static_cast<long long>(Wo) * Ho;
  if (planes * in_size > INT_MAX || planes * out_size > INT_MAX
      || static_cast<long long>(Wo) * H > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_of(W, H, Wo, Ho);
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
  A.by_h = make_fast_div(static_cast<unsigned>(H));
  A.by_in = make_fast_div(static_cast<unsigned>(in_size));
  A.by_mid = make_fast_div(static_cast<unsigned>(Wo * H));
  A.ppr = plan.ppr;
  A.affine = affine;
  A.scale = scale;
  A.scale_p = scale_p;
  A.dscale = dscale;
  A.dbias = dbias;
  A.partials = partials;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // no planes: nothing to do, but for the two zero sums
  if (total_runs == 0 && dscale == nullptr) return 0;
  int blocks = 0;
  const int e = grid_of(plan, device, &blocks);
  if (e != 0) return e;
  unsigned grid = total_runs < static_cast<unsigned>(blocks)
                  ? total_runs : static_cast<unsigned>(blocks);
  if (grid == 0) grid = 1;
  if (dscale != nullptr) {
    void* args[] = {&A, &total_runs};
    return launch_cooperative(kernel_ptr(), grid, kThreads, args, plan.smem,
                              st);
  }
  box_vjp_kernel<<<grid, kThreads, plan.smem, st>>>(A, total_runs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
