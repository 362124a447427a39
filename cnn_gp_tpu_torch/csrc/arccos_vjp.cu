// The adjoint of the arccos ReLU covariance map for Hopper (sm_90a).
//
// Replaces work that the JAX package leaves to XLA (no Pallas kernel): the
// VJP of cnn_gp_tpu/ops/arccos.py::_relu_xla that jax.grad derives inside
// cnn_gp_tpu/fit.py::_grad_chunk_jit and _probed_grad_chunk_jit.  Given
// the cotangent g = t * gscale of the xy' map, each pair-pixel (i, j, p)
// with cos theta, sin theta and pi - theta computed as the forward
// computes them (csrc/arccos.cuh: relu_factored's "fast" form, where the
// product under the square roots is (xx + tiny)(yy + tiny), or
// relu_reference's, where it is xx yy + tiny) contributes
//     g_xy[i, j, p]  = g (pi - theta) / (2 pi),
//     g_xx[i, p]    += g sqrt(yy / xx) sin theta / (4 pi),
//     g_yy[j, p]    += g sqrt(xx / yy) sin theta / (4 pi),
// ("fast": sqrt(yy / xx) = s_yy r_xx from the side maps' factors;
// "reference": yy sin theta / (4 pi sqrt(P)) = yy s r^2 / (4 pi)), and a
// same-example pair (mask[i, j]; its xy' is xx / 2) contributes g / 2 to
// g_xx[i, p] and nothing else.  That is the closed form of the derivative:
// the terms of d sin / d xy and d theta / d xy that autograd of the plain
// forward subtracts from each other (each infinite at |cos theta| = 1)
// cancel here exactly.  Pair mode: xy, t [b1, b2, S], xx [b1, S], yy [b2,
// S], mask [b1, b2] or none; when yy is xx (a same block) both side sums
// land in g_xx.  Diagonal mode: all [b, S], the reference form, no mask,
// elementwise.  acc_xx / acc_yy, when given, are added to the side sums
// (the box filter's adjoint's share of the halved side maps); dot, when
// given, gets sum(t * xy') added (the ReLU's output is not kept: it is
// recomputed here, with the forward's instructions, for a Conv2d's d
// scale).
//
// Deterministic: no float atomics.  Pass 1 walks work items of kR pair
// rows by kJ pair columns by kThreads pixels, one pixel a thread: each
// thread keeps its kR rows' g_xx sums in registers across the kJ columns
// and writes them as partials [column chunk, b1, S]; per column it sums
// its kR rows' g_yy terms and writes them as partials [row group, b2, S];
// its share of the dot goes into one partial per block.  The launch is
// cooperative (csrc/launch.cuh): after one grid-wide barrier, pass 2 adds
// the partials up in a fixed order.  Two runs give the same bits.
//
// What bounds it: bytes.  A 128 x 128 tile of 28 x 28 maps reads xy and
// t (2 x 51 MB) and writes g_xy (51 MB), 46 us at 3.35 TB/s; the partials
// add 2 x 6.4 MB.  Its ~51 rounded FP32 operations per element take
// about as long: the x-side factors are computed once per thread and the
// y-side ones once per column for its kR rows, so an element runs no
// rsqrt and no square root of a side-map value.  kJ = 8 columns a work
// item, not 16, gives the 128 x 128 launch enough warps (0.1452 -> 0.1091
// ms on an H100, chip_smoke.py phase 3c).

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "arccos.cuh"
#include "launch.cuh"

namespace {

using namespace cnn_gp;

constexpr int kThreads = 128;   // pixels per work item
constexpr int kR = 8;           // pair rows per work item
constexpr int kJ = 8;           // pair columns per work item
constexpr int kDiagThreads = 256;
constexpr float kQuarterInvPi = static_cast<float>(0.25 / kPiD);

enum Mode { kPairFast = 0, kPairReference = 1, kDiagonal = 2 };

struct Args {
  const float* t;        // the xy' cotangent before gscale
  const float* xy;
  const float* xx;
  const float* yy;
  const uint8_t* mask;   // [b1, b2] bytes or null
  float* g_xy;           // each null when not wanted
  float* g_xx;
  float* g_yy;
  const float* acc_xx;   // added to the side sums, or null
  const float* acc_yy;
  float* part_x;         // [jchunks, b1, S]
  float* part_y;         // [rgroups, b2, S]
  float* part_dot;       // [gridDim.x]
  float* dot;            // += sum(t * xy'), or null
  float gscale;
  const float* gscale_p; // gscale on the card, or null
  unsigned b1, b2, S;
  unsigned pblocks, rgroups, jchunks, items;
  bool one_side;         // yy is xx: both side sums land in g_xx
};

// xy', d xy'/d xy, d xy'/d xx, d xy'/d yy of one element.
struct Adj {
  float out, dxy, dxx, dyy;
};

// relu_factored's instructions, and the derivatives from its factors.
__device__ __forceinline__ Adj adj_factored(float v, RowFactor fx,
                                            RowFactor fy, int exact) {
  const float f = __fmul_rn(fx.r, fy.r);   // before xy, as the forward
  const float c = clip_unit(__fmul_rn(v, f));
  const float sin_t =
      __fsqrt_rn(max_nan(__fsub_rn(1.0f, __fmul_rn(c, c)), 0.0f));
  const float s = __fmul_rn(__fmul_rn(fx.s, fy.s), sin_t);
  const float pmt = acos_any(-c, exact);
  const float q = __fmul_rn(sin_t, kQuarterInvPi);
  Adj a;
  a.out = __fmul_rn(__fadd_rn(s, __fmul_rn(pmt, v)), kHalfInvPi);
  a.dxy = __fmul_rn(pmt, kHalfInvPi);
  a.dxx = __fmul_rn(__fmul_rn(fy.s, fx.r), q);
  a.dyy = __fmul_rn(__fmul_rn(fx.s, fy.r), q);
  return a;
}

// relu_reference's instructions, and the derivatives through P = xx yy +
// tiny: d xy'/d P = s r^2 / (4 pi).
__device__ __forceinline__ Adj adj_reference(float v, float cx, float cy,
                                             int exact) {
  const float p = __fadd_rn(__fmul_rn(cx, cy), kTiny);
  const float r = rsqrtf(p);
  const float c = clip_unit(__fmul_rn(v, r));
  const float s = __fsqrt_rn(max_nan(__fsub_rn(p, __fmul_rn(v, v)), 0.0f));
  const float pmt = __fsub_rn(kPi, acos_any(c, exact));
  const float dp = __fmul_rn(__fmul_rn(s, __fmul_rn(r, r)), kQuarterInvPi);
  Adj a;
  a.out = __fmul_rn(__fadd_rn(s, __fmul_rn(pmt, v)), kHalfInvPi);
  a.dxy = __fmul_rn(pmt, kHalfInvPi);
  a.dxx = __fmul_rn(cy, dp);
  a.dyy = __fmul_rn(cx, dp);
  return a;
}

// The sum of every thread's v, in a fixed order (warp shuffles, then the
// warps in order), in thread 0.  `red` holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(~0u, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      total = __fadd_rn(total, red[w]);
  }
  return total;
}

// One work item of pass 1: rows i0 .. i0 + kR - 1, columns j0 .. j0 + kJ
// - 1, pixel p of this thread.
template <int MODE, int EXACT>
__device__ __forceinline__ void pair_item(const Args& a, float gs,
                                          unsigned rg, unsigned jc,
                                          unsigned p, float& dot) {
  const unsigned i0 = rg * kR, j0 = jc * kJ;
  const unsigned nr = a.b1 - i0 < kR ? a.b1 - i0 : kR;
  const unsigned nj = a.b2 - j0 < kJ ? a.b2 - j0 : kJ;
  float xv[kR], acc[kR];
  RowFactor fx[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    acc[r] = 0.0f;
    xv[r] = r < static_cast<int>(nr) ? a.xx[(i0 + r) * a.S + p] : 0.0f;
    if constexpr (MODE == kPairFast) fx[r] = row_factor(xv[r]);
  }
  const bool want_y = a.g_yy != nullptr || (a.one_side && a.g_xx != nullptr);
  for (unsigned jj = 0; jj < nj; ++jj) {
    const unsigned j = j0 + jj;
    const float yv = a.yy[j * a.S + p];
    RowFactor fy{};
    if constexpr (MODE == kPairFast) fy = row_factor(yv);
    float v[kR], tv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < static_cast<int>(nr)) {
        const size_t e = (static_cast<size_t>(i0 + r) * a.b2 + j) * a.S + p;
        v[r] = __ldcs(a.xy + e);
        tv[r] = __ldcs(a.t + e);
      }
    }
    float col = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r >= static_cast<int>(nr)) continue;
      const unsigned i = i0 + r;
      const size_t e = (static_cast<size_t>(i) * a.b2 + j) * a.S + p;
      const float g = __fmul_rn(tv[r], gs);
      float out, gxy;
      if (a.mask != nullptr && a.mask[i * a.b2 + j] != 0) {
        out = __fmul_rn(xv[r], 0.5f);
        gxy = 0.0f;
        acc[r] = __fadd_rn(acc[r], __fmul_rn(g, 0.5f));
      } else {
        const Adj d = MODE == kPairFast
            ? adj_factored(v[r], fx[r], fy, EXACT)
            : adj_reference(v[r], xv[r], yv, EXACT);
        out = d.out;
        gxy = __fmul_rn(g, d.dxy);
        acc[r] = __fadd_rn(acc[r], __fmul_rn(g, d.dxx));
        col = __fadd_rn(col, __fmul_rn(g, d.dyy));
      }
      if (a.g_xy != nullptr) __stcs(a.g_xy + e, gxy);
      if (a.dot != nullptr) dot = __fadd_rn(dot, __fmul_rn(tv[r], out));
    }
    if (want_y) a.part_y[(static_cast<size_t>(rg) * a.b2 + j) * a.S + p] = col;
  }
  if (a.g_xx != nullptr) {
    for (unsigned r = 0; r < nr; ++r)
      a.part_x[(static_cast<size_t>(jc) * a.b1 + i0 + r) * a.S + p] = acc[r];
  }
}

template <int MODE, int EXACT>
__global__ void __launch_bounds__(kThreads)
relu_vjp_pair(const __grid_constant__ Args a) {
  __shared__ float red[kThreads / 32];
  const float gs = a.gscale_p != nullptr ? *a.gscale_p : a.gscale;
  float dot = 0.0f;
  // pass 1: the work items, pixel blocks fastest
  for (unsigned w = blockIdx.x; w < a.items; w += gridDim.x) {
    const unsigned pb = w % a.pblocks, rest = w / a.pblocks;
    const unsigned jc = rest % a.jchunks, rg = rest / a.jchunks;
    const unsigned p = pb * kThreads + threadIdx.x;
    if (p < a.S) pair_item<MODE, EXACT>(a, gs, rg, jc, p, dot);
  }
  if (a.dot != nullptr) {
    const float total = block_sum(dot, red);
    if (threadIdx.x == 0) a.part_dot[blockIdx.x] = total;
  }
  cooperative_groups::this_grid().sync();

  // pass 2: the side sums from the partials, in a fixed order
  const unsigned stride = gridDim.x * blockDim.x;
  const unsigned first = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned nx = a.b1 * a.S, ny = a.b2 * a.S;
  if (a.g_xx != nullptr) {
    for (unsigned e = first; e < nx; e += stride) {
      float sum = a.acc_xx != nullptr ? a.acc_xx[e] : 0.0f;
      for (unsigned c = 0; c < a.jchunks; ++c)
        sum = __fadd_rn(sum, a.part_x[static_cast<size_t>(c) * nx + e]);
      if (a.one_side) {
        for (unsigned g = 0; g < a.rgroups; ++g)
          sum = __fadd_rn(sum, a.part_y[static_cast<size_t>(g) * ny + e]);
      }
      a.g_xx[e] = sum;
    }
  }
  if (a.g_yy != nullptr) {
    for (unsigned e = first; e < ny; e += stride) {
      float sum = a.acc_yy != nullptr ? a.acc_yy[e] : 0.0f;
      for (unsigned g = 0; g < a.rgroups; ++g)
        sum = __fadd_rn(sum, a.part_y[static_cast<size_t>(g) * ny + e]);
      a.g_yy[e] = sum;
    }
  }
  if (a.dot != nullptr && blockIdx.x == 0) {
    float v = 0.0f;
    for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x)
      v = __fadd_rn(v, a.part_dot[b]);
    const float total = block_sum(v, red);
    if (threadIdx.x == 0) *a.dot = __fadd_rn(*a.dot, total);
  }
}

// The diagonal mode: every map [b * S], the reference form elementwise.
template <int EXACT>
__global__ void __launch_bounds__(kDiagThreads)
relu_vjp_diagonal(const __grid_constant__ Args a, unsigned n) {
  const float gs = a.gscale_p != nullptr ? *a.gscale_p : a.gscale;
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    const float g = __fmul_rn(a.t[e], gs);
    const float cx = a.xx[e], cy = a.yy[e];
    const Adj d = adj_reference(a.xy[e], cx, cy, EXACT);
    float gx = __fmul_rn(g, d.dxx), gy = __fmul_rn(g, d.dyy);
    if (a.acc_xx != nullptr) gx = __fadd_rn(a.acc_xx[e], gx);
    if (a.acc_yy != nullptr) gy = __fadd_rn(a.acc_yy[e], gy);
    if (a.g_xy != nullptr) a.g_xy[e] = __fmul_rn(g, d.dxy);
    if (a.g_xx != nullptr) a.g_xx[e] = gx;
    if (a.g_yy != nullptr) a.g_yy[e] = gy;
  }
}

// The pair launch's tiling: work items and the partials' floats.
struct Tiling {
  unsigned pblocks, rgroups, jchunks, items;
  long long part_x, part_y;
};

Tiling tiling(long long b1, long long b2, long long S) {
  Tiling t{};
  t.pblocks = static_cast<unsigned>((S + kThreads - 1) / kThreads);
  t.rgroups = static_cast<unsigned>((b1 + kR - 1) / kR);
  t.jchunks = static_cast<unsigned>((b2 + kJ - 1) / kJ);
  t.items = t.pblocks * t.rgroups * t.jchunks;
  t.part_x = t.jchunks * b1 * S;
  t.part_y = t.rgroups * b2 * S;
  return t;
}

template <int MODE, int EXACT>
const void* pair_kernel() {
  return reinterpret_cast<const void*>(&relu_vjp_pair<MODE, EXACT>);
}

const void* pick_pair(int mode, int exact) {
  if (mode == kPairFast)
    return exact ? pair_kernel<kPairFast, 1>() : pair_kernel<kPairFast, 0>();
  return exact ? pair_kernel<kPairReference, 1>()
               : pair_kernel<kPairReference, 0>();
}

}  // namespace

extern "C" {

// Floats of scratch that cnn_gp_relu_vjp takes for these sizes: the pair
// modes' partials of the side sums and one partial of the dot per block
// of the persistent grid; none for the diagonal mode.  Returns an error
// code (0 on success).
int cnn_gp_relu_vjp_scratch(int b1, int b2, int S, int mode, int device,
                            long long* floats) {
  *floats = 0;
  if (mode == kDiagonal) return 0;
  if (mode != kPairFast && mode != kPairReference)
    return static_cast<int>(cudaErrorInvalidValue);
  // one dot partial per block of the larger grid of the two acos versions
  int blocks = 0;
  for (int exact = 0; exact < 2; ++exact) {
    int n = 0;
    const int err = co_resident_blocks(pick_pair(mode, exact), kThreads, 0,
                                       0, device, &n);
    if (err != 0) return err;
    blocks = n > blocks ? n : blocks;
  }
  const Tiling t = tiling(b1, b2, S);
  *floats = t.part_x + t.part_y + blocks;
  return 0;
}

// Launches the adjoint on `stream` and returns its error code (0 on
// success; cudaErrorInvalidValue for 2^31 elements or more or a bad
// mode; the card's refusal of the cooperative launch).  t: the xy'
// cotangent, multiplied by gscale (or *gscale_p when not null); mode 0:
// pair "fast", 1: pair "reference", 2: diagonal (b1 is b, b2 unused, mask
// and dot null); exact: acosf instead of the polynomial.  g_xy, g_xx,
// g_yy: outputs, each null when not wanted (g_yy null when yy is xx, the
// two pointers and b1, b2 agreeing: both side sums go to g_xx).  acc_xx,
// acc_yy: added to the side sums, or null.  scratch: the floats that
// cnn_gp_relu_vjp_scratch gives.  dot: one float to which sum(t * xy')
// is added, or null.  Does not synchronise and allocates nothing.
int cnn_gp_relu_vjp(const float* t, const float* xy, const float* xx,
                    const float* yy, const uint8_t* mask, float* g_xy,
                    float* g_xx, float* g_yy, const float* acc_xx,
                    const float* acc_yy, float* scratch, float* dot,
                    float gscale, const float* gscale_p, int b1, int b2,
                    int S, int mode, int exact, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode < kPairFast || mode > kDiagonal || b1 < 0 || b2 < 0 || S < 0
      || (mode == kDiagonal && (mask != nullptr || dot != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool diag = mode == kDiagonal;
  const long long total = static_cast<long long>(b1) * (diag ? 1 : b2) * S;
  if (total == 0) return 0;
  if (total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
  a.t = t;
  a.xy = xy;
  a.xx = xx;
  a.yy = yy;
  a.mask = mask;
  a.g_xy = g_xy;
  a.g_xx = g_xx;
  a.acc_xx = acc_xx;
  a.dot = dot;
  a.gscale = gscale;
  a.gscale_p = gscale_p;
  a.S = static_cast<unsigned>(S);
  if (diag) {
    a.g_yy = g_yy;
    a.acc_yy = acc_yy;
    const void* kernel = exact
        ? reinterpret_cast<const void*>(&relu_vjp_diagonal<1>)
        : reinterpret_cast<const void*>(&relu_vjp_diagonal<0>);
    int blocks = 0;
    const int e = co_resident_blocks(kernel, kDiagThreads, 0, 0, device,
                                     &blocks);
    if (e != 0) return e;
    const unsigned n = static_cast<unsigned>(total);
    const unsigned need = (n + kDiagThreads - 1) / kDiagThreads;
    const unsigned grid = need < static_cast<unsigned>(blocks)
                          ? need : static_cast<unsigned>(blocks);
    if (exact)
      relu_vjp_diagonal<1><<<grid, kDiagThreads, 0, st>>>(a, n);
    else
      relu_vjp_diagonal<0><<<grid, kDiagThreads, 0, st>>>(a, n);
    return static_cast<int>(cudaGetLastError());
  }
  a.one_side = xx == yy && b1 == b2;
  a.g_yy = a.one_side ? nullptr : g_yy;
  a.acc_yy = a.one_side ? nullptr : acc_yy;
  if (a.one_side && acc_yy != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);   // the wrapper merges
  a.b1 = static_cast<unsigned>(b1);
  a.b2 = static_cast<unsigned>(b2);
  const Tiling tl = tiling(b1, b2, S);
  if (tl.part_x > INT_MAX || tl.part_y > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  a.pblocks = tl.pblocks;
  a.rgroups = tl.rgroups;
  a.jchunks = tl.jchunks;
  a.items = tl.items;
  a.part_x = scratch;
  a.part_y = scratch + tl.part_x;
  a.part_dot = scratch + tl.part_x + tl.part_y;
  const void* kernel = pick_pair(mode, exact);
  int blocks = 0;
  const int e = co_resident_blocks(kernel, kThreads, 0, 0, device, &blocks);
  if (e != 0) return e;
  const unsigned grid = tl.items < static_cast<unsigned>(blocks)
                        ? tl.items : static_cast<unsigned>(blocks);
  void* args[] = {&a};
  return launch_cooperative(kernel, grid, kThreads, args, 0, st);
}

}  // extern "C"
