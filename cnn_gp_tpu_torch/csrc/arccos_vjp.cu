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
// Deterministic: no float atomics.  Pass 1 walks tiles of kRows = 8 pair
// rows by kJ = 16 pair columns by 16 pixels, one warp each: a lane takes
// four consecutive pixels (16-byte loads of xy and t, 16-byte stores of
// g_xy) of kR = 2 rows and kCols = 8 columns.  It keeps its rows' g_xx
// sums in registers across its columns; at the tile's end the two column
// lanes add theirs (a warp shuffle, the lower columns first) and write
// them as partials [column chunk, b1, S].  Per column the four row lanes
// add their g_yy terms (two shuffle stages, the lower rows first) and
// write them as partials [row group, b2, S]; each lane's share of the dot
// goes into one partial per block.  The launch is cooperative
// (csrc/launch.cuh): after one grid-wide barrier, pass 2 adds the partials
// up in a fixed order.  Two runs give the same bits.
//
// What bounds it: bytes.  A 128 x 128 tile of 28 x 28 maps reads xy and
// t (2 x 51 MB) and writes g_xy (51 MB), 46 us at 3.35 TB/s; the partials
// add 2 x 9.6 MB.  Its ~51 rounded FP32 operations per element take
// about as long: the x-side factors are computed once per lane and tile
// and the y-side ones once per column for its kR rows, so an element runs
// no rsqrt and no square root of a side-map value.  The first version
// (one pixel a thread in 128-pixel work items, 8 rows by 8 columns, 4-byte
// accesses, the mask byte read per element) ran at 0.43 (128 x 128) to
// 0.50 (200 x 200) of the bound on an H100, and a probe of it there found
// a 28 x 28 map 1.24x as slow per element as a 32 x 32 one, whose 1,024
// pixels leave no lane idle, with its g_xy stores and partials costing a
// fifth of its time at 28 x 28 and almost nothing at 32 x 32.  The
// design, as the forward's (csrc/arccos.cu):
//   - the tiles walk each plane's pixel groups as one flat range, so a
//     plane's 196 (28 x 28), 49 (14 x 14) or 13 (7 x 7) groups idle no
//     lane at its tail but in its last tile;
//   - the grid takes as few blocks (up to kBlocksPerSM per SM) as run the
//     tiles in as many rounds as the most blocks would, so every warp
//     takes the same count of tiles, or one fewer;
//   - the map sizes of the configs (28/14/7 and 32/16/8) are template
//     parameters (the tile's indices by constant divisions, every address
//     by constant strides); 16-byte accesses need S % 4 == 0 and 16-byte
//     aligned maps: a 7 x 7 map, or a view at an unaligned address, takes
//     4-byte loads (VEC = 0), and every other size the same kernel with
//     run-time indices;
//   - the mask byte is read once per pair (i, j) and lane;
//   - 8 rows a row group and 16 columns a chunk: 9.6 MB of partials at
//     128 x 128, against 12.8 MB with 8 by 8;
//   - each column's loads are issued one column ahead of its arithmetic,
//     with the default cache policy.  Tried on an H100 and not kept: 8 or
//     16 pixel groups a tile (128- or 256-byte row segments a warp), a
//     ring of three columns in flight through cp.async, streaming cache
//     hints (5% slower).  With the arithmetic cut to a few operations an
//     element the launch took 6% less time, without the g_xy stores 16%
//     less: the memory system, not the issue of the arithmetic, bounds it.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "arccos.cuh"
#include "fast_div.cuh"
#include "launch.cuh"

namespace {

using namespace cnn_gp;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 4;  // the most blocks per SM the grid takes
constexpr int kVec = 4;          // consecutive pixels per lane
// a tile, one warp's work: kRows pair rows by kJ pair columns by four
// pixel groups; a lane takes kR rows (of kRowLanes lanes) and kCols
// columns (of kColLanes lanes) of one pixel group
constexpr int kR = 2;
constexpr int kRowLanes = 4;
constexpr int kRows = kR * kRowLanes;
constexpr int kCols = 8;
constexpr int kColLanes = 2;
constexpr int kJ = kCols * kColLanes;
constexpr int kGroupLanes = 32 / (kRowLanes * kColLanes);
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
  unsigned groups;       // pixel groups per plane, ceil(S / kVec)
  unsigned gtiles;       // tiles per plane, ceil(groups / kGroupLanes)
  unsigned rgroups, jchunks, tiles;
  FastDiv by_gtiles, by_jchunks;
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

// Four consecutive values at p (VEC: one 16-byte load; else the values
// in[k] marks, 0 elsewhere).
template <int VEC>
__device__ __forceinline__ void load4(const float* p, const bool (&in)[kVec],
                                      float (&v)[kVec]) {
  if constexpr (VEC) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = in[k] ? p[k] : 0.0f;
  }
}

template <int VEC>
__device__ __forceinline__ void store4(float* p, const bool (&in)[kVec],
                                       const float (&v)[kVec]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (in[k]) p[k] = v[k];
    }
  }
}

// A butterfly over the row lanes of a lane's pixel group and columns:
// the sum of their v, the lower rows first, the same bits in all.
__device__ __forceinline__ float row_lanes_sum(float v, unsigned q,
                                               unsigned mask) {
#pragma unroll
  for (int b = 1; b < kRowLanes; b <<= 1) {
    const float other = __shfl_xor_sync(mask, v, b * kGroupLanes);
    v = (q & b) ? __fadd_rn(other, v) : __fadd_rn(v, other);
  }
  return v;
}

// One tile of pass 1, one warp: this lane's pixels p .. p + 3 of rows i0,
// i0 + 1 and columns j0 .. j0 + kCols - 1.  SZ: the map size S when it
// is fixed, else 0.
template <int MODE, int EXACT, int SZ, int VEC>
__device__ __forceinline__ void pair_tile(const Args& a, float gs,
                                          unsigned tile, float& dot) {
  const unsigned S = SZ > 0 ? static_cast<unsigned>(SZ) : a.S;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned gl = lane % kGroupLanes;
  const unsigned q = (lane / kGroupLanes) % kRowLanes;
  const unsigned c = lane / (kGroupLanes * kRowLanes);
  constexpr int kGtiles = SZ > 0
      ? ((SZ + kVec - 1) / kVec + kGroupLanes - 1) / kGroupLanes : 0;
  const unsigned rest = divide<kGtiles>(tile, a.by_gtiles);
  const unsigned group = (tile - rest * a.gtiles) * kGroupLanes + gl;
  const unsigned rg = fast_div(rest, a.by_jchunks), jc = rest - rg * a.jchunks;
  // every lane of a shuffle shares its pixel group, so its validity
  const bool valid = group < a.groups;
  const unsigned live = __ballot_sync(~0u, valid);
  if (!valid) return;
  const unsigned p = group * kVec;
  const unsigned i0 = rg * kRows + q * kR, j0 = jc * kJ + c * kCols;
  const int nr = i0 >= a.b1 ? 0 : (a.b1 - i0 < kR ? a.b1 - i0 : kR);
  const int nj = j0 >= a.b2 ? 0 : (a.b2 - j0 < kCols ? a.b2 - j0 : kCols);
  bool in[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) in[k] = VEC || p + k < S;
  // the x side: each row's values (reference) or factors (fast; a masked
  // pair reads its value again)
  float xv[kR][kVec], acc[kR][kVec];
  RowFactor fx[kR][kVec];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[r][k] = 0.0f;
    if (r < nr) {
      load4<VEC>(a.xx + (i0 + r) * S + p, in, xv[r]);
      if constexpr (MODE == kPairFast) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) fx[r][k] = row_factor(xv[r][k]);
      }
    }
  }
  const bool want_y = a.g_yy != nullptr || (a.one_side && a.g_xx != nullptr);
  // the row lanes of this lane's pixel group and columns (the same nj)
  unsigned rows_mask = 0;
#pragma unroll
  for (int r = 0; r < kRowLanes; ++r)
    rows_mask |= 1u << (gl + (r + c * kRowLanes) * kGroupLanes);
  // one column's arithmetic and stores, from its loads
  auto column = [&](unsigned j, const float (&yv)[kVec],
                    const float (&v)[kR][kVec], const float (&tv)[kR][kVec],
                    const bool (&masked)[kR]) {
    RowFactor fy[kVec];
    if constexpr (MODE == kPairFast) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) fy[k] = row_factor(yv[k]);
    }
    float col[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r >= nr) continue;
      float gxy[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float g = __fmul_rn(tv[r][k], gs);
        float out;
        if (masked[r]) {
          const float x = MODE == kPairReference ? xv[r][k]
              : (in[k] ? a.xx[(i0 + r) * S + p + k] : 0.0f);
          out = __fmul_rn(x, 0.5f);
          gxy[k] = 0.0f;
          acc[r][k] = __fadd_rn(acc[r][k], __fmul_rn(g, 0.5f));
        } else {
          const Adj d = MODE == kPairFast
              ? adj_factored(v[r][k], fx[r][k], fy[k], EXACT)
              : adj_reference(v[r][k], xv[r][k], yv[k], EXACT);
          out = d.out;
          gxy[k] = __fmul_rn(g, d.dxy);
          acc[r][k] = __fadd_rn(acc[r][k], __fmul_rn(g, d.dxx));
          col[k] = __fadd_rn(col[k], __fmul_rn(g, d.dyy));
        }
        if (a.dot != nullptr && in[k])
          dot = __fadd_rn(dot, __fmul_rn(tv[r][k], out));
      }
      if (a.g_xy != nullptr)
        store4<VEC>(a.g_xy + ((i0 + r) * a.b2 + j) * S + p, in, gxy);
    }
    if (want_y) {
      // the row group's sum over its kRows rows
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        col[k] = row_lanes_sum(col[k], q, rows_mask);
      if (q == 0)
        store4<VEC>(a.part_y + (rg * a.b2 + j) * S + p, in, col);
    }
  };
  auto mask_bytes = [&](unsigned j, bool (&masked)[kR]) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
      masked[r] = r < nr && a.mask != nullptr
                  && a.mask[(i0 + r) * a.b2 + j] != 0;
  };
  // a column's loads, issued one column ahead of its arithmetic
  auto load_column = [&](unsigned j, float (&yv)[kVec],
                         float (&v)[kR][kVec], float (&tv)[kR][kVec],
                         bool (&masked)[kR]) {
    load4<VEC>(a.yy + j * S + p, in, yv);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < nr) {
        const unsigned e = ((i0 + r) * a.b2 + j) * S + p;
        load4<VEC>(a.xy + e, in, v[r]);
        load4<VEC>(a.t + e, in, tv[r]);
      }
    }
    mask_bytes(j, masked);
  };
  float yv[kVec], v[kR][kVec], tv[kR][kVec];
  bool masked[kR];
  if (nj > 0) load_column(j0, yv, v, tv, masked);
  for (int jj = 0; jj < nj; ++jj) {
    float yn[kVec], vn[kR][kVec], tn[kR][kVec];
    bool mn[kR];
    if (jj + 1 < nj) load_column(j0 + jj + 1, yn, vn, tn, mn);
    column(j0 + jj, yv, v, tv, masked);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      yv[k] = yn[k];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        v[r][k] = vn[r][k];
        tv[r][k] = tn[r][k];
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) masked[r] = mn[r];
  }
  if (a.g_xx != nullptr) {
    // the column chunk's sum over its kJ columns: a butterfly over the
    // column lanes, the lower columns first
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
#pragma unroll
        for (int b = 1; b < kColLanes; b <<= 1) {
          const float other = __shfl_xor_sync(
              live, acc[r][k], b * kGroupLanes * kRowLanes);
          acc[r][k] = (c & b) ? __fadd_rn(other, acc[r][k])
                              : __fadd_rn(acc[r][k], other);
        }
      }
      if (c == 0 && r < nr)
        store4<VEC>(a.part_x + (jc * a.b1 + i0 + r) * S + p, in, acc[r]);
    }
  }
}

template <int MODE, int EXACT, int SZ, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
relu_vjp_pair(const __grid_constant__ Args a) {
  __shared__ float red[kThreads / 32];
  const float gs = a.gscale_p != nullptr ? *a.gscale_p : a.gscale;
  float dot = 0.0f;
  // pass 1: the tiles, a warp each (the grid gives every warp the same
  // count, or one fewer)
  const unsigned warps = gridDim.x * kWarps;
  for (unsigned tile = blockIdx.x * kWarps + threadIdx.x / 32;
       tile < a.tiles; tile += warps)
    pair_tile<MODE, EXACT, SZ, VEC>(a, gs, tile, dot);
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

// The pair launch's tiling: tiles and the partials' floats.
struct Tiling {
  unsigned groups, gtiles, rgroups, jchunks, tiles;
  long long part_x, part_y;
};

Tiling tiling(long long b1, long long b2, long long S) {
  Tiling t{};
  t.groups = static_cast<unsigned>((S + kVec - 1) / kVec);
  t.gtiles = (t.groups + kGroupLanes - 1) / kGroupLanes;
  t.rgroups = static_cast<unsigned>((b1 + kRows - 1) / kRows);
  t.jchunks = static_cast<unsigned>((b2 + kJ - 1) / kJ);
  t.tiles = t.gtiles * t.rgroups * t.jchunks;
  t.part_x = t.jchunks * b1 * S;
  t.part_y = t.rgroups * b2 * S;
  return t;
}

// The most blocks of the grid: kBlocksPerSM per SM.
int grid_blocks(int device, int* blocks) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = kBlocksPerSM * sms;
  return 0;
}

template <int MODE, int EXACT, int SZ, int VEC>
const void* pair_kernel() {
  return reinterpret_cast<const void*>(&relu_vjp_pair<MODE, EXACT, SZ, VEC>);
}

// The instantiation for map size S: the configs' sizes (28/14/7 and
// 32/16/8 maps) their own, 16-byte accesses where `vec`; every other size
// the run-time one.
template <int MODE, int EXACT>
const void* pick_size(int S, bool vec) {
  if (!vec)
    return S == 49 ? pair_kernel<MODE, EXACT, 49, 0>()
                   : pair_kernel<MODE, EXACT, 0, 0>();
  switch (S) {
    case 784: return pair_kernel<MODE, EXACT, 784, 1>();
    case 196: return pair_kernel<MODE, EXACT, 196, 1>();
    case 1024: return pair_kernel<MODE, EXACT, 1024, 1>();
    case 256: return pair_kernel<MODE, EXACT, 256, 1>();
    case 64: return pair_kernel<MODE, EXACT, 64, 1>();
    default: return pair_kernel<MODE, EXACT, 0, 1>();
  }
}

const void* pick_pair(int mode, int exact, int S, bool vec) {
  if (mode == kPairFast)
    return exact ? pick_size<kPairFast, 1>(S, vec)
                 : pick_size<kPairFast, 0>(S, vec);
  return exact ? pick_size<kPairReference, 1>(S, vec)
               : pick_size<kPairReference, 0>(S, vec);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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
  // one dot partial per block of the grid
  int blocks = 0;
  const int err = grid_blocks(device, &blocks);
  if (err != 0) return err;
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
  a.groups = tl.groups;
  a.gtiles = tl.gtiles;
  a.rgroups = tl.rgroups;
  a.jchunks = tl.jchunks;
  a.tiles = tl.tiles;
  a.by_gtiles = make_fast_div(tl.gtiles);
  a.by_jchunks = make_fast_div(tl.jchunks);
  a.part_x = scratch;
  a.part_y = scratch + tl.part_x;
  a.part_dot = scratch + tl.part_x + tl.part_y;
  // 16-byte accesses: whole pixel groups in a plane, every map aligned
  const bool vec = S % kVec == 0 && aligned16(t) && aligned16(xy)
                   && aligned16(xx) && aligned16(yy) && aligned16(scratch)
                   && (g_xy == nullptr || aligned16(g_xy));
  const void* kernel = pick_pair(mode, exact, S, vec);
  int blocks = 0, resident = 0;
  int e = grid_blocks(device, &blocks);
  if (e != 0) return e;
  e = co_resident_blocks(kernel, kThreads, 0, 0, device, &resident);
  if (e != 0) return e;
  if (resident < blocks) return static_cast<int>(cudaErrorInvalidConfiguration);
  // as few blocks as take the tiles in as many rounds as the most
  // would, so every warp takes the same count of tiles, or one fewer
  const unsigned most = static_cast<unsigned>(blocks) * kWarps;
  const unsigned rounds = (tl.tiles + most - 1) / most;
  const unsigned warps = (tl.tiles + rounds - 1) / rounds;
  const unsigned grid = (warps + kWarps - 1) / kWarps;
  void* args[] = {&a};
  return launch_cooperative(kernel, grid, kThreads, args, 0, st);
}

}  // extern "C"
