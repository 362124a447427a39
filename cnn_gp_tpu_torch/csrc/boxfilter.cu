// The NNGP Conv2d covariance map, a scaled box filter, for Hopper
// (sm_90a), with the ResNet layer fused around it: the arccos ReLU of its
// input in a prologue, the residual branch's running total added in an
// epilogue.
//
// Replaces work that the JAX package leaves to XLA (no Pallas kernel):
// cnn_gp_tpu/ops/boxfilter.py::box_filter_2d (default "separable",
// _reduce_window_1d; "shifts", _shift_sum_1d), called per field by
// cnn_gp_tpu/kernels.py::Conv2d.propagate and followed there by
// "* var_weight / k^2 + var_bias"; with the prologue also
// cnn_gp_tpu/ops/arccos.py::_relu_xla, and with the epilogue the add of
// cnn_gp_tpu/kernels.py::Sum.propagate, which XLA fuses into one program
// with the convolutions.  One launch takes up to three float32 maps of
// [P, W, H] planes (the xy pair map and the xx / yy side maps of one
// Conv2d; two when yy is xx) and writes, for each plane,
//     out[p, o, q] = skip[p, o, q]
//                    + (sum_{c<k} sum_{a<k} xp[p, o*s + a*d, q*s + c*d])
//                      * scale + bias,
// where xp is the prologue's map of the plane zero-padded by (lo, hi) on
// each axis: the plane itself, half of it (the side maps after a ReLU,
// xx' = xx / 2), or the arccos ReLU of a pair map (xy' from xy and the
// pre-ReLU side maps xx [bx, W, H], yy [bz, W, H], same-example pairs
// taking xx / 2 through the mask [bx, bz]).  skip is absent without the
// epilogue; with affine == 0 the launch writes the windowed sum alone
// (box_filter_2d).
//
// Arithmetic: that of the plain chain
// (cnn_gp_tpu_torch/ops/layer.py::conv_layer_reference: relu_transform_
// reference, conv_maps_reference, then skip + out) operation for
// operation.  The prologue runs the ReLU's device math of csrc/arccos.cuh,
// the same instructions as the standalone ReLU kernel, and in the "fast"
// form reads the same factor table: the launch fills it (the factors of
// every xx and yy value, once) before its first plane; the box sum adds
// k strided slices along W (a = 0, 1, ...) into a [Wo, H] sum, then k
// slices of that along H in the same order (a tap in the padding adds
// +0.0, as F.pad's zeros do), multiplies by the scale, adds the bias and
// then the skip (IEEE addition commutes: skip + conv has the bits of the
// Sum's add); every step is rounded on its own (__fadd_rn / __fmul_rn
// keep nvcc from contracting into FMAs).  So the output is bit-equal to
// the plain chain on the card.  The scale is the float32 the plain
// version multiplies by: var_weight / k^2 rounded from the Python float,
// or read from the card when it is a learnable leaf.
//
// What bounds it: bytes, or for the ReLU prologue the issue of its
// unfused arithmetic.  A 200 x 200 tile of 28 x 28 maps with k = 3 reads
// its 125 MB xy map once, the 125 MB skip once and writes 125 MB (112 us
// at 3.35 TB/s); the box sum is ~6 operations per element and a uniform
// window, far below the ridge, so tensor cores have nothing to do here.
// The ReLU's ~38 rounded FP32 operations and two special-function
// sequences per element (the square roots of the sine and of the
// polynomial, branch-free: csrc/arccos.cuh's sqrt_unit; the side maps'
// rsqrt and sqrt come from the factor table) issue in about as long as
// the bytes take, so the prologue keeps its per-element stream to that
// arithmetic, four values at a time: the plane's pair, the form and the
// arccos are settled per plane or per launch (relu_run below).  On an
// H100 the 28 x 28 launch with the prologue took 0.287 ms with IEEE
// roots and per-element indices, 0.207 ms so (chip_smoke.py, phase 3b).
// The design:
//   - a persistent grid (as many blocks as fit on the SMs); a block walks
//     its share of runs of consecutive planes of the flat plane axis,
//     each run contiguous in memory; with the "fast" ReLU prologue it is a
//     cooperative launch: the blocks fill shares of the factor table
//     (csrc/arccos.cuh::fill_factors) while their first bulk copies are in
//     flight, and wait at one grid-wide barrier before the first plane;
//   - a ring of kStages stages in dynamic shared memory: one thread
//     issues each run's input planes and skip planes as one bulk
//     asynchronous copy each (cp.async.bulk, 1-D TMA, completion on an
//     mbarrier) kStages - 1 runs ahead, while the block computes the
//     current run; a run's tail that is not a multiple of 16 bytes, and
//     a run at an address that is not 16-byte aligned (a view), load with
//     scalar loads in the same kernel;
//   - the prologue in place on the staged planes; the "fast" ReLU of a
//     fixed geometry (relu_run) takes the run's planes as one flat range
//     in groups of four values of one plane (one 16-byte load of the
//     values and of each side's factors, one store; one value where a
//     plane is not a multiple of four), kThreads groups at a time (no
//     thread idles on 14 x 14 planes, and the warps of 28 x 28 runs share
//     evenly), with the arccos a template parameter chosen once per run;
//     each value reads its row and column factors from the table (2.5 MB
//     at 200 x 200 28 x 28, inside the 50 MB L2) at the plane's offsets,
//     which the block finds once per plane for the next run (and the
//     mask's mark) into shared memory; the "reference" form and run-time
//     geometries take the element loop, xx and yy read per value; four
//     blocks an SM (64 registers), which the prologue's latency needs;
//   - the W pass into a [Wo, H] buffer, the H pass, the scale, the bias
//     and the skip, stored coalesced;
//   - the geometries of the ResNet configs (28/14/7 and 32/16/8 maps,
//     k 1, 3, 4, 7, 8, stride 1 and 2, "same" or 0 padding) as template
//     parameters, so the index arithmetic is by constants and a
//     thread's pixel loop unrolls; every other
//     geometry takes the same kernel with run-time indices by
//     multiply-high divisions (csrc/fast_div.cuh).  On an H100 each
//     fixed geometry's launch takes 0.55-0.82 of the run-time kernel's
//     (chip_smoke.py, fixed_vs_runtime).
// A plane too large to stage kStages deep in kMaxStagedBytes (maps above
// about 80 x 80, 60 x 60 with a skip; no config uses one) takes the
// unstaged kernel: one
// thread per output element, its prologue applied to each tap it reads
// from global memory (from the same factor table, filled the same way), the
// same bits.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "arccos.cuh"
#include "bulk_copy.cuh"
#include "fast_div.cuh"
#include "launch.cuh"

namespace {

using namespace cnn_gp;

constexpr int kThreads = 256;
constexpr int kStages = 3;               // runs in flight per block
constexpr int kRunFloats = 2048;         // input floats a run aims at
constexpr int kMaxStagedBytes = 100 * 1024;
constexpr int kMinBlocksPerSM = 4;

// What the prologue does to a map's planes before the filter.
enum Prologue { kAsIs = 0, kHalf = 1, kRelu = 2 };

struct Map {
  const float* x;      // [planes, W, H]
  const float* skip;   // [planes, Wo, Ho] or null
  float* y;            // [planes, Wo, Ho]
  unsigned planes;
  unsigned runs;       // ceil(planes / ppr)
  int prologue;
};

// Up to three maps (map f unused when planes == 0) and the operands that
// every map shares.
struct Layer {
  Map m0;
  Map m1;
  Map m2;
  const float* xx;       // the ReLU prologue: pre-ReLU [bx, W, H]
  const float* yy;       // and [bz, W, H], mask [bx, bz] bytes or null
  const uint8_t* mask;
  RowFactor* table;      // the "fast" form's factor table, else null
  unsigned nx;           // xx and yy values whose factors fill it
  unsigned ny;           // (ny 0: yy is xx)
  unsigned y_off;        // yy's first entry (0 when yy is xx)
  unsigned bz;
  FastDiv by_bz;
  int form;              // ReluForm
  int exact;             // acosf instead of the polynomial
  int affine;
  float scale;
  float bias;
  const float* scale_p;  // the scale and bias on the card, or null
  const float* bias_p;
};

// The run-time geometry and the staging layout.
struct Shape {
  int W, H, Wo, Ho, k, stride, lo, dilation;
  FastDiv by_h, by_ho, by_in, by_mid, by_out;
  int ppr;            // planes per run
  int in_floats;      // staged input floats per stage (a multiple of 4)
  int stage_floats;   // input and skip floats per stage
};

__device__ __forceinline__ Map pick(const Layer& L, int f) {
  return f == 0 ? L.m0 : (f == 1 ? L.m1 : L.m2);
}

// The run r of the flat run axis: its map, first plane and plane count.
struct Run {
  Map m;
  unsigned first;
  int n;
};

__device__ __forceinline__ Run run_of(const Layer& L, unsigned r, int ppr) {
  int f = 0;
  if (r >= L.m0.runs) {
    r -= L.m0.runs;
    f = 1;
    if (r >= L.m1.runs) {
      r -= L.m1.runs;
      f = 2;
    }
  }
  Run run;
  run.m = pick(L, f);
  run.first = r * static_cast<unsigned>(ppr);
  const unsigned left = run.m.planes - run.first;
  run.n = static_cast<int>(left < static_cast<unsigned>(ppr) ? left : ppr);
  return run;
}

// Thread 0: start run r's copies into a stage.
__device__ __forceinline__ void issue(const Layer& L, const Shape& sh,
                                      int in_size, int out_size, unsigned r,
                                      float* stage, uint64_t* bar) {
  const Run run = run_of(L, r, sh.ppr);
  const float* src = run.m.x + static_cast<size_t>(run.first) * in_size;
  const unsigned bx = bulk_bytes(src, run.n * in_size);
  unsigned bs = 0;
  const float* skip = nullptr;
  if (run.m.skip != nullptr) {
    skip = run.m.skip + static_cast<size_t>(run.first) * out_size;
    bs = bulk_bytes(skip, run.n * out_size);
  }
  mbar_arrive_expect_tx(bar, bx + bs);
  if (bx != 0) bulk_load(stage, src, bx, bar);
  if (bs != 0) bulk_load(stage + sh.in_floats, skip, bs, bar);
}

// The pair of a plane of a run through the "fast" ReLU prologue, found
// once per plane: the factor-table (and xx) index of its row plane i,
// i * W * H, and of its column plane j, y_off + j * W * H, or kMaskedPlane
// where the mask marks the pair (a same example: xx / 2).
struct PlaneRow {
  unsigned x;
  unsigned y;
};
constexpr unsigned kMaskedPlane = 0xffffffffu;
// planes of a fixed geometry's run: at most kRunFloats over the smallest
// plane, 7 x 7
constexpr int kMaxRunPlanes = 48;
static_assert(kRunFloats / 49 <= kMaxRunPlanes && kMaxRunPlanes <= kThreads,
              "a run's plane rows, one a thread");

// The row of plane q of a pair map of N x N planes.
template <int N>
__device__ __forceinline__ PlaneRow plane_row(const Layer& L, unsigned q) {
  const unsigned i = fast_div(q, L.by_bz), j = q - i * L.bz;
  const bool masked = L.mask != nullptr && L.mask[q] != 0;
  return PlaneRow{i * (N * N),
                  masked ? kMaskedPlane : L.y_off + j * (N * N)};
}

// The rows of run r's planes, one a thread, if its map takes the ReLU.
template <int N>
__device__ __forceinline__ void plane_rows(const Layer& L, const Shape& sh,
                                           unsigned r, PlaneRow* rows,
                                           int t) {
  const Run run = run_of(L, r, sh.ppr);
  if (run.m.prologue == kRelu && t < run.n)
    rows[t] = plane_row<N>(L, run.first + t);
}

// The "fast" ReLU prologue of a run of n planes of a fixed N x N
// geometry, in place on the staged planes xs (the first bulk_in values
// staged, the rest read from src), with the arccos chosen at compile time
// (EXACT: acosf) and each plane's pair from rows: the run's planes as one
// flat range of n * N * N values in groups of kVec consecutive values of
// one plane (4 where a plane holds a multiple of 4, so a group's value,
// row and column factors are 16-byte loads and its store one; else 1),
// kThreads groups at a time, four values a thread in flight (so no
// thread idles where a plane has fewer pixels than the block has
// threads, and the block's warps share the work evenly): the loads, then
// the ReLUs.
template <int N, int EXACT>
__device__ __forceinline__ void relu_run(const Layer& L,
                                         const PlaneRow* rows, int n,
                                         float* xs, const float* src,
                                         int bulk_in, int t) {
  constexpr int kIn = N * N;
  constexpr int kVec = kIn % 4 == 0 ? 4 : 1;
  constexpr int kGroups = 4 / kVec;
  constexpr int kPerPlane = kIn / kVec;
  const int total = n * kPerPlane;
  for (int g0 = t; g0 < total; g0 += kGroups * kThreads) {
    float v[kGroups][kVec];
    RowFactor fx[kGroups][kVec], fy[kGroups][kVec];
    unsigned xi[kGroups];
    bool masked[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int g = g0 + u * kThreads;
      if (g < total) {
        const int pl = g / kPerPlane;
        const unsigned p = static_cast<unsigned>(g - pl * kPerPlane) * kVec;
        const PlaneRow row = rows[pl];
        const int e = g * kVec;
        masked[u] = row.y == kMaskedPlane;
        xi[u] = row.x + p;
        if constexpr (kVec == 4) {
          if (e < bulk_in) {
            const float4 q = *reinterpret_cast<const float4*>(xs + e);
            v[u][0] = q.x;
            v[u][1] = q.y;
            v[u][2] = q.z;
            v[u][3] = q.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) v[u][k] = src[e + k];
          }
          if (!masked[u]) {
            // two entries a 16-byte load: (r, s) of pixels p, p + 1
            const float4* const tx =
                reinterpret_cast<const float4*>(L.table + xi[u]);
            const float4* const ty =
                reinterpret_cast<const float4*>(L.table + row.y + p);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 a = tx[h], b = ty[h];
              fx[u][2 * h] = RowFactor{a.x, a.y};
              fx[u][2 * h + 1] = RowFactor{a.z, a.w};
              fy[u][2 * h] = RowFactor{b.x, b.y};
              fy[u][2 * h + 1] = RowFactor{b.z, b.w};
            }
          }
        } else {
          v[u][0] = e < bulk_in ? xs[e] : src[e];
          if (!masked[u]) {
            fx[u][0] = L.table[xi[u]];
            fy[u][0] = L.table[row.y + p];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int g = g0 + u * kThreads;
      if (g < total) {
        float o[kVec];
        if (masked[u]) {
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            o[k] = __fmul_rn(__ldg(L.xx + xi[u] + k), 0.5f);
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            o[k] = relu_factored(v[u][k], fx[u][k], fy[u][k], EXACT);
        }
        float* const dst = xs + g * kVec;
        if constexpr (kVec == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2],
                                                        o[3]);
        } else {
          dst[0] = o[0];
        }
      }
    }
  }
}

template <int N, int K, int STR, int LO, int NO>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
box_layer_staged(const __grid_constant__ Layer L,
                 const __grid_constant__ Shape sh, unsigned total_runs) {
  constexpr bool kFixed = N > 0;
  // a fixed geometry's pixels per thread and plane, unrolled; its ReLU
  // prologue takes relu_run
  constexpr int kSlots = kFixed ? (N * N + kThreads - 1) / kThreads : 0;
  constexpr bool kUnroll = kFixed && kSlots <= 4;
  const int W = kFixed ? N : sh.W, H = kFixed ? N : sh.H;
  const int Wo = kFixed ? NO : sh.Wo, Ho = kFixed ? NO : sh.Ho;
  const int k = kFixed ? K : sh.k, stride = kFixed ? STR : sh.stride;
  const int lo = kFixed ? LO : sh.lo, dil = kFixed ? 1 : sh.dilation;
  const int in_size = W * H, mid_size = Wo * H, out_size = Wo * Ho;

  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  // the "fast" ReLU prologue's plane rows of the current run and the next
  __shared__ PlaneRow rows[kUnroll ? 2 : 1][kUnroll ? kMaxRunPlanes : 1];
  const bool row_runs = kUnroll && L.table != nullptr;
  float* const ts = smem + kStages * sh.stage_floats;   // [ppr, Wo, H]
  const int t = threadIdx.x;

  float scale = L.scale, bias = L.bias;
  if (L.affine) {
    if (L.scale_p != nullptr) scale = *L.scale_p;
    if (L.bias_p != nullptr) bias = *L.bias_p;
  }

  // the block's runs: a contiguous share of the run axis, so that
  // consecutive runs mostly share their row plane (and its row of the
  // factor table, which stays in L1)
  const unsigned share = (total_runs + gridDim.x - 1) / gridDim.x;
  const unsigned r0 = blockIdx.x * share;
  const unsigned r_end = r0 + share < total_runs ? r0 + share : total_runs;
  if constexpr (kUnroll) {
    if (row_runs && r0 < r_end) plane_rows<N>(L, sh, r0, rows[0], t);
  }
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    fence_mbarrier_init();
    fence_proxy_async();
  }
  __syncthreads();
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      if (r0 + s < r_end)
        issue(L, sh, in_size, out_size, r0 + s, smem + s * sh.stage_floats,
              &bars[s]);
    }
  }
  // the "fast" ReLU prologue's factor table, while the copies fly (every
  // block, before any returns: a cooperative launch)
  if (L.table != nullptr) fill_factors(L.xx, L.nx, L.yy, L.ny, L.table);

  // The prologue's thread layout (other than relu_run's): a thread keeps
  // its pixels across the run's planes (lanes of planes side by side when
  // a plane has fewer pixels than the block has threads).
  const bool wide = in_size >= kThreads;
  const int lanes = wide ? 1 : kThreads / in_size;
  const int lane = wide ? 0 : static_cast<int>(
      divide<kFixed ? N * N : 0>(t, sh.by_in));
  const int p0 = t - lane * in_size;
  const int step = wide ? kThreads : in_size;

  for (unsigned it = 0;; ++it) {
    const unsigned r = r0 + it;
    if (r >= r_end) break;
    const int s = static_cast<int>(it % kStages);
    float* const xs = smem + s * sh.stage_floats;       // [n, W, H]
    float* const ss = xs + sh.in_floats;                // [n, Wo, Ho]
    while (!mbar_try_wait(&bars[s], (it / kStages) & 1u)) {
    }
    const Run run = run_of(L, r, sh.ppr);
    const int n = run.n;
    const float* const src = run.m.x + static_cast<size_t>(run.first)
                                       * in_size;
    const int bulk_in = static_cast<int>(bulk_bytes(src, n * in_size) / 4);

    // 1. the prologue, and the loads that the bulk copy left out
    bool done = false;
    if constexpr (kUnroll) {
      if (row_runs && run.m.prologue == kRelu) {
        const PlaneRow* const rw = rows[it & 1];
        if (L.exact) {
          relu_run<N, 1>(L, rw, n, xs, src, bulk_in, t);
        } else {
          relu_run<N, 0>(L, rw, n, xs, src, bulk_in, t);
        }
        done = true;
      }
    }
    if (!done && (run.m.prologue != kAsIs || bulk_in < n * in_size)) {
      for (int pl = lane; lane < lanes && pl < n; pl += lanes) {
        const unsigned q = run.first + pl;
        float* const plane = xs + pl * in_size;
        const float* const gplane = src + pl * in_size;
        unsigned i = 0, j = 0;
        bool masked = false;
        if (run.m.prologue == kRelu) {
          i = fast_div(q, L.by_bz);
          j = q - i * L.bz;
          masked = L.mask != nullptr && L.mask[q] != 0;
        }
        // a run-time geometry, or a map without the ReLU: element by
        // element
#pragma unroll
        for (int u = 0; u < (kUnroll ? kSlots : 1); ++u) {
          // a fixed geometry unrolls the slots; otherwise one loop
          for (int p = p0 + u * step; p < in_size;
               p += (kUnroll ? in_size : step)) {
            const int e = pl * in_size + p;
            float v = e < bulk_in ? plane[p] : gplane[p];
            if (run.m.prologue == kHalf) {
              v = __fmul_rn(v, 0.5f);
            } else if (run.m.prologue == kRelu) {
              const float* const xrow = L.xx + i * in_size;
              if (masked) {
                v = __fmul_rn(__ldg(xrow + p), 0.5f);
              } else if (L.form == kReluFast) {
                v = relu_factored(v, L.table[i * in_size + p],
                                  L.table[L.y_off + j * in_size + p],
                                  L.exact);
              } else {
                v = relu_reference(v, __ldg(xrow + p),
                                   __ldg(L.yy + j * in_size + p), L.exact);
              }
            }
            plane[p] = v;
          }
        }
      }
    }
    __syncthreads();
    // the next run's plane rows (their buffer's last reads were the
    // previous run's prologue), read after this run's barriers
    if constexpr (kUnroll) {
      if (row_runs && r + 1 < r_end)
        plane_rows<N>(L, sh, r + 1, rows[(it + 1) & 1], t);
    }

    // 2. the W pass: [n, W, H] -> [n, Wo, H]
    for (int e = t; e < n * mid_size; e += kThreads) {
      const int p = static_cast<int>(
          divide<kFixed ? NO * N : 0>(e, sh.by_mid));
      const int rem = e - p * mid_size;
      const int o = static_cast<int>(divide<kFixed ? N : 0>(rem, sh.by_h));
      const int h = rem - o * H;
      const float* xp = xs + p * in_size + h;
      const int w0 = o * stride - lo;
      float col = 0.0f;
#pragma unroll
      for (int a = 0; a < k; ++a) {
        const int w = w0 + a * dil;
        const float v = (w >= 0 && w < W) ? xp[w * H] : 0.0f;
        col = a == 0 ? v : __fadd_rn(col, v);
      }
      ts[e] = col;
    }
    __syncthreads();

    // 3. the H pass, the scale and bias, the skip: [n, Wo, H] -> out
    const size_t out0 = static_cast<size_t>(run.first) * out_size;
    const float* const gskip = run.m.skip == nullptr ? nullptr
                                                     : run.m.skip + out0;
    const int bulk_skip = gskip == nullptr ? 0 : static_cast<int>(
        bulk_bytes(gskip, n * out_size) / 4);
    float* const dst = run.m.y + out0;
    for (int e = t; e < n * out_size; e += kThreads) {
      const int p = static_cast<int>(
          divide<kFixed ? NO * NO : 0>(e, sh.by_out));
      const int rem = e - p * out_size;
      const int o = static_cast<int>(divide<kFixed ? NO : 0>(rem, sh.by_ho));
      const int q = rem - o * Ho;
      const float* tp = ts + p * mid_size + o * H;
      const int h0 = q * stride - lo;
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < k; ++c) {
        const int h = h0 + c * dil;
        const float v = (h >= 0 && h < H) ? tp[h] : 0.0f;  // F.pad's zeros
        sum = c == 0 ? v : __fadd_rn(sum, v);
      }
      if (L.affine) sum = __fadd_rn(__fmul_rn(sum, scale), bias);
      if (gskip != nullptr)
        sum = __fadd_rn(e < bulk_skip ? ss[e] : gskip[e], sum);
      dst[e] = sum;
    }
    // every thread orders its generic-proxy accesses of the stage (the
    // prologue's writes, the reads of steps 2 and 3) before the barrier,
    // after which one thread's bulk copy (async proxy) overwrites it
    fence_proxy_async();
    __syncthreads();

    // 4. the stage is free: start the run kStages ahead in it
    if (t == 0) {
      const unsigned next = r + kStages;
      if (next < r_end) issue(L, sh, in_size, out_size, next, xs, &bars[s]);
    }
  }
}

// The prologue's map of one input value v at pixel p of a plane of map m
// (for the ReLU: the plane of pair (i, j), masked or not).  Indices are
// 32-bit: the host refuses 2^31 elements or more.
__device__ __forceinline__ float prologue_at(const Layer& L, const Map& m,
                                             unsigned i, unsigned j,
                                             bool masked, unsigned p,
                                             unsigned in_size, float v) {
  if (m.prologue == kHalf) return __fmul_rn(v, 0.5f);
  if (m.prologue != kRelu) return v;
  const unsigned x = i * in_size + p, y = j * in_size + p;
  if (masked) return __fmul_rn(L.xx[x], 0.5f);
  return L.form == kReluFast
      ? relu_factored(v, L.table[x], L.table[L.y_off + y], L.exact)
      : relu_reference(v, L.xx[x], L.yy[y], L.exact);
}

// The unstaged kernel: one thread per output element, the prologue on
// every tap it reads.
__global__ void __launch_bounds__(kThreads)
box_layer_unstaged(const __grid_constant__ Layer L,
                   const __grid_constant__ Shape sh, unsigned total) {
  if (L.table != nullptr) fill_factors(L.xx, L.nx, L.yy, L.ny, L.table);
  float scale = L.scale, bias = L.bias;
  if (L.affine) {
    if (L.scale_p != nullptr) scale = *L.scale_p;
    if (L.bias_p != nullptr) bias = *L.bias_p;
  }
  // 32-bit index arithmetic (the host refuses 2^31 outputs or more)
  const int W = sh.W, H = sh.H, in_size = W * H;
  const unsigned per = static_cast<unsigned>(sh.Wo) * sh.Ho;
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    unsigned plane = fast_div(e, sh.by_out);
    const unsigned r = e - plane * per;
    const int o = static_cast<int>(fast_div(r, sh.by_ho));
    const int q = static_cast<int>(r) - o * sh.Ho;
    int f = 0;
    if (plane >= L.m0.planes) {
      plane -= L.m0.planes;
      f = 1;
      if (plane >= L.m1.planes) {
        plane -= L.m1.planes;
        f = 2;
      }
    }
    const Map m = pick(L, f);
    const float* xp = m.x + static_cast<size_t>(plane) * in_size;
    // the ReLU prologue's pair of this plane, once per output
    unsigned i = 0, j = 0;
    bool masked = false;
    if (m.prologue == kRelu) {
      i = fast_div(plane, L.by_bz);
      j = plane - i * L.bz;
      masked = L.mask != nullptr && L.mask[plane] != 0;
    }
    const int w0 = o * sh.stride - sh.lo, h0 = q * sh.stride - sh.lo;
    float sum = 0.0f;
    for (int c = 0; c < sh.k; ++c) {
      const int h = h0 + c * sh.dilation;
      float col = 0.0f;                      // a padded row of F.pad
      if (h >= 0 && h < H) {
        for (int a = 0; a < sh.k; ++a) {
          const int w = w0 + a * sh.dilation;
          const float v = (w >= 0 && w < W)
              ? prologue_at(L, m, i, j, masked, w * H + h, in_size,
                            xp[w * H + h])
              : 0.0f;
          col = a == 0 ? v : __fadd_rn(col, v);
        }
      }
      sum = c == 0 ? col : __fadd_rn(sum, col);
    }
    if (L.affine) sum = __fadd_rn(__fmul_rn(sum, scale), bias);
    const size_t out = static_cast<size_t>(plane) * per + r;
    if (m.skip != nullptr) sum = __fadd_rn(m.skip[out], sum);
    m.y[out] = sum;
  }
}

// ---- host side ----

template <int N, int K, int STR, int LO, int NO>
int launch_staged(const Layer& L, const Shape& sh, unsigned total_runs,
                  int smem, int device, cudaStream_t st) {
  const void* kernel =
      reinterpret_cast<const void*>(&box_layer_staged<N, K, STR, LO, NO>);
  int blocks = 0;
  const int err = co_resident_blocks(kernel, kThreads, smem, kMaxStagedBytes,
                                     device, &blocks);
  if (err != 0) return err;
  const unsigned grid = total_runs < static_cast<unsigned>(blocks)
                        ? total_runs : static_cast<unsigned>(blocks);
  if (L.table != nullptr) {
    void* args[] = {const_cast<Layer*>(&L), const_cast<Shape*>(&sh),
                    &total_runs};
    return launch_cooperative(kernel, grid, kThreads, args, smem, st);
  }
  box_layer_staged<N, K, STR, LO, NO><<<grid, kThreads, smem, st>>>(
      L, sh, total_runs);
  return static_cast<int>(cudaGetLastError());
}

using Launcher = int (*)(const Layer&, const Shape&, unsigned, int, int,
                         cudaStream_t);

// The geometries of the ResNet configs (map side, k, stride, lo, output
// side; dilation 1): mnist_as_tf at 28/14/7, cifar10 at 32/16/8, the
// residual config's even kernel, the paper ConvNet's k = 7.
struct Fixed {
  int n, k, stride, lo, no;
  Launcher launch;
};

constexpr Fixed kFixedGeometries[] = {
    {28, 3, 1, 1, 28, launch_staged<28, 3, 1, 1, 28>},
    {28, 1, 1, 0, 28, launch_staged<28, 1, 1, 0, 28>},
    {28, 1, 2, 0, 14, launch_staged<28, 1, 2, 0, 14>},
    {28, 3, 2, 1, 14, launch_staged<28, 3, 2, 1, 14>},
    {28, 4, 1, 1, 28, launch_staged<28, 4, 1, 1, 28>},
    {28, 7, 1, 3, 28, launch_staged<28, 7, 1, 3, 28>},
    {14, 3, 1, 1, 14, launch_staged<14, 3, 1, 1, 14>},
    {14, 1, 2, 0, 7, launch_staged<14, 1, 2, 0, 7>},
    {14, 3, 2, 1, 7, launch_staged<14, 3, 2, 1, 7>},
    {7, 3, 1, 1, 7, launch_staged<7, 3, 1, 1, 7>},
    {7, 7, 1, 0, 1, launch_staged<7, 7, 1, 0, 1>},
    {32, 3, 1, 1, 32, launch_staged<32, 3, 1, 1, 32>},
    {32, 1, 1, 0, 32, launch_staged<32, 1, 1, 0, 32>},
    {32, 1, 2, 0, 16, launch_staged<32, 1, 2, 0, 16>},
    {32, 3, 2, 1, 16, launch_staged<32, 3, 2, 1, 16>},
    {16, 3, 1, 1, 16, launch_staged<16, 3, 1, 1, 16>},
    {16, 1, 2, 0, 8, launch_staged<16, 1, 2, 0, 8>},
    {16, 3, 2, 1, 8, launch_staged<16, 3, 2, 1, 8>},
    {8, 3, 1, 1, 8, launch_staged<8, 3, 1, 1, 8>},
    {8, 8, 1, 0, 1, launch_staged<8, 8, 1, 0, 1>},
};

int pad4(int n) { return (n + 3) & ~3; }

// The staging of a launch: planes per run and the staged kernel's dynamic
// shared memory (ppr 0: the planes are too large, the unstaged kernel).
struct Plan {
  int ppr;
  int smem;
  int in_floats;
  int stage_floats;
};

Plan plan_of(int in_n, int mid_n, int out_n, bool skip) {
  // about kRunFloats input floats a run, a multiple of the planes that
  // make whole 16-byte units of input and of skip (so every run's bulk
  // copies start aligned), staged kStages deep
  auto unit = [](int floats) { return floats % 4 == 0 ? 1
                                      : (floats % 2 == 0 ? 2 : 4); };
  const int mult = skip && unit(out_n) > unit(in_n) ? unit(out_n)
                                                    : unit(in_n);
  int ppr = kRunFloats / in_n;
  ppr = ppr >= mult ? ppr - ppr % mult : (ppr < 1 ? 1 : ppr);
  // a stage: the input planes and the skip planes
  auto stage_of = [&](int p) {
    return pad4(p * in_n) + (skip ? pad4(p * out_n) : 0);
  };
  auto smem_of = [&](int p) {
    return (kStages * stage_of(p) + static_cast<long long>(p) * mid_n)
           * static_cast<long long>(sizeof(float));
  };
  while (ppr > 1 && smem_of(ppr) > kMaxStagedBytes)
    ppr = ppr > mult ? ppr - mult : ppr - 1;
  if (smem_of(ppr) > kMaxStagedBytes) return Plan{0, 0, 0, 0};
  return Plan{ppr, static_cast<int>(smem_of(ppr)), pad4(ppr * in_n),
              stage_of(ppr)};
}

int launch(Layer L, int W, int H, int Wo, int Ho, int k, int stride, int lo,
           int dilation, bool runtime_geometry, int device,
           cudaStream_t st) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long planes = static_cast<long long>(L.m0.planes) + L.m1.planes
                           + L.m2.planes;
  const long long in_size = static_cast<long long>(W) * H;
  const long long out_size = static_cast<long long>(Wo) * Ho;
  if (planes * out_size == 0) return 0;
  if (planes * out_size > INT_MAX || planes * in_size > INT_MAX
      || static_cast<long long>(Wo) * H > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool skip = L.m0.skip || L.m1.skip || L.m2.skip;
  const Plan plan = plan_of(static_cast<int>(in_size), Wo * H,
                            static_cast<int>(out_size), skip);
  const Shape sh{W, H, Wo, Ho, k, stride, lo, dilation,
                 make_fast_div(H), make_fast_div(Ho),
                 make_fast_div(static_cast<unsigned>(in_size)),
                 make_fast_div(static_cast<unsigned>(Wo * H)),
                 make_fast_div(static_cast<unsigned>(out_size)), plan.ppr,
                 plan.in_floats, plan.stage_floats};
  if (plan.ppr > 0) {
    const unsigned ppr = static_cast<unsigned>(plan.ppr);
    L.m0.runs = (L.m0.planes + ppr - 1) / ppr;
    L.m1.runs = (L.m1.planes + ppr - 1) / ppr;
    L.m2.runs = (L.m2.planes + ppr - 1) / ppr;
    const unsigned total_runs = L.m0.runs + L.m1.runs + L.m2.runs;
    if (!runtime_geometry && dilation == 1 && W == H && Wo == Ho) {
      for (const Fixed& g : kFixedGeometries) {
        if (g.n == W && g.k == k && g.stride == stride && g.lo == lo
            && g.no == Wo)
          return g.launch(L, sh, total_runs, plan.smem, device, st);
      }
    }
    return launch_staged<0, 0, 0, 0, 0>(L, sh, total_runs, plan.smem,
                                        device, st);
  }
  unsigned total = static_cast<unsigned>(planes * out_size);
  unsigned blocks = (total + kThreads - 1) / kThreads;
  if (L.table != nullptr) {
    // a grid that is resident at once walks the outputs
    const void* kernel = reinterpret_cast<const void*>(&box_layer_unstaged);
    int resident = 0;
    const int e = co_resident_blocks(kernel, kThreads, 0, 0, device,
                                     &resident);
    if (e != 0) return e;
    if (blocks > static_cast<unsigned>(resident))
      blocks = static_cast<unsigned>(resident);
    void* args[] = {&L, const_cast<Shape*>(&sh), &total};
    return launch_cooperative(kernel, blocks, kThreads, args, 0, st);
  }
  box_layer_unstaged<<<blocks, kThreads, 0, st>>>(L, sh, total);
  return static_cast<int>(cudaGetLastError());
}

Map map_of(const float* x, const float* skip, float* y, long long planes,
           int prologue) {
  return Map{x, skip, y, static_cast<unsigned>(planes), 0u, prologue};
}

}  // namespace

extern "C" {

// Launches the box filter over p0 + p1 + p2 planes of [W, H] (x_f -> y_f,
// slot f unused when p_f == 0) on `stream` and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue for 2^31 elements or more).  Map f
// takes prologue pro_f (0: as is; 1: halved; 2: the arccos ReLU of a [bx,
// bz, W, H] pair map, from the pre-ReLU xx [bx, W, H], yy [bz, W, H] and
// the mask [bx, bz] bytes or null, in relu form `form` (0 "fast", 1
// "reference"), acosf when `exact`), then the box filter, then with
// `affine` the scale and the bias, then, when s_f is not null, the skip
// s_f [p_f, Wo, Ho] added.  scale_p / bias_p, when not null, point at the
// float32 scale / bias on the card and take the place of scale / bias.
// table: the "fast" ReLU prologue's factor table (float32 (r, s) pairs of
// every xx and yy value, laid out as csrc/arccos.cuh::factor_y_offset
// says; yy is xx when the two pointers and bx, bz agree), which the launch
// fills and reads; null for any other launch.  A launch with it is
// cooperative, and the card's refusal of one is returned, not worked
// round.  `runtime_geometry` takes the kernel with run-time indices even
// where a fixed geometry's instantiation exists (to time one against the
// other).  Does not synchronise and allocates nothing.
int cnn_gp_conv_layer(const float* x0, const float* s0, float* y0,
                      long long p0, int pro0, const float* x1,
                      const float* s1, float* y1, long long p1, int pro1,
                      const float* x2, const float* s2, float* y2,
                      long long p2, int pro2, const float* xx,
                      const float* yy, const uint8_t* mask, int bz, int form,
                      int exact, int W, int H, int Wo, int Ho, int k,
                      int stride, int lo, int dilation, int affine,
                      float scale, float bias, const float* scale_p,
                      const float* bias_p, float* table,
                      int runtime_geometry, int device, void* stream) {
  const bool relu = pro0 == kRelu || pro1 == kRelu || pro2 == kRelu;
  if (relu && (xx == nullptr || yy == nullptr || bz < 1
               || (form != kReluFast && form != kReluReference)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((relu && form == kReluFast) != (table != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Layer L{};
  L.m0 = map_of(x0, s0, y0, p0, pro0);
  L.m1 = map_of(x1, s1, y1, p1, pro1);
  L.m2 = map_of(x2, s2, y2, p2, pro2);
  L.xx = xx;
  L.yy = yy;
  L.mask = mask;
  if (table != nullptr) {
    // the pair map's planes are bx * bz; the side maps' values bx * W * H
    // and bz * W * H
    const long long pair = pro0 == kRelu ? p0 : (pro1 == kRelu ? p1 : p2);
    const long long s = static_cast<long long>(W) * H, bx = pair / bz;
    const bool same = xx == yy && bx == bz;
    if (bx * s + bz * s + 3 > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    L.table = reinterpret_cast<RowFactor*>(table);
    L.nx = static_cast<unsigned>(bx * s);
    L.ny = same ? 0u : static_cast<unsigned>(bz * s);
    L.y_off = same ? 0u : factor_y_offset(L.nx);
  }
  L.bz = static_cast<unsigned>(bz < 1 ? 1 : bz);
  L.by_bz = make_fast_div(L.bz);
  L.form = form;
  L.exact = exact;
  L.affine = affine;
  L.scale = scale;
  L.bias = bias;
  L.scale_p = scale_p;
  L.bias_p = bias_p;
  return launch(L, W, H, Wo, Ho, k, stride, lo, dilation,
                runtime_geometry != 0, device,
                static_cast<cudaStream_t>(stream));
}

// The staging of a launch over [W, H] planes to [Wo, Ho], with a skip or
// not: planes per run and the staged kernel's dynamic shared memory in
// bytes (0 and 0 for the unstaged kernel).
void cnn_gp_box_filter_plan(int W, int H, int Wo, int Ho, int skip,
                            int* ppr, int* smem) {
  const Plan plan = plan_of(W * H, Wo * H, Wo * Ho, skip != 0);
  *ppr = plan.ppr;
  *smem = plan.smem;
}

const char* cnn_gp_box_filter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
