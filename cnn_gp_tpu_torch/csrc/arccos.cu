// The arccos ReLU covariance map for Hopper (sm_90a).
//
// Replaces work that the JAX package leaves to XLA (no Pallas kernel):
// cnn_gp_tpu/ops/arccos.py::_relu_xla, with _xy_update_factored (the
// "fast" relu_impl), _xy_update ("reference", and the diagonal mode) and
// acos_f32 (the "poly" acos_impl; "exact" is acosf), which XLA fuses into
// one elementwise loop.  Each pair-pixel (i, j, p) gets
//     xy'[i, j, p] = (sin t + (pi - t) * xy) / (2 pi),
//     cos t = clip(xy * (r_xx[i, p] * r_yy[j, p]), -1, 1)   ("fast"), or
//     cos t = clip(xy * rsqrt(xx[i, p] * yy[j, p] + tiny), -1, 1),
// and xx[i, p] / 2 where mask[i, j] marks a same-example pair.  Pair mode:
// xy [b1, b2, S], xx [b1, S], yy [b2, S], mask [b1, b2] or none.
// Diagonal mode: xy, xx, yy all [b, S], the reference form elementwise,
// no mask.  (xx' = xx / 2 and yy' stay torch multiplies on the small side
// maps.)  A ReLU whose one reader is a Conv2d does not come here: it runs
// in the box filter's prologue (csrc/boxfilter.cu), on the same device
// math and the same factor table.
//
// Arithmetic: that of the plain version
// (cnn_gp_tpu_torch/ops/arccos.py::relu_xy_reference) operation for
// operation, in csrc/arccos.cuh (shared with the box filter's prologue).
// In the "fast" form the factors r = rsqrt(v + tiny) and s = sqrt(v +
// tiny) of every xx and yy value are computed once per launch into a
// factor table (ops/arccos.py::relu_factors is their plain version), and
// each element reads its two entries: no element runs an rsqrt or a
// square root of a side-map value.  The factor (r_xx[i] * r_yy[j]) is
// formed before it multiplies xy, and every element runs the same
// instruction sequence, so a diagonal tile stays exactly symmetric.  Its
// gate (chip_smoke.py, phase 3b) holds it to 1e-6 of max|xy'| of the
// plain version; on an H100 it is bit-equal to it in every case the phase
// runs (both forms, both acos versions, masked, diagonal, a same block,
// views off a 16-byte boundary).
//
// What bounds it: bytes.  A 200 x 200 tile of 28 x 28 maps reads its
// 125 MB xy map once and writes 125 MB (75 us at 3.35 TB/s); its ~38
// FP32 operations per element (1.2e9) take 18 us at 67 TFLOP/s, and the
// element's two remaining special-function sequences (the sine's and the
// polynomial's square roots) ~15 us at 16 per clock per SM.  The design:
//   - the "fast" form is one cooperative launch (every block resident):
//     the blocks fill shares of the factor table, wait at one grid-wide
//     barrier, then compute;
//   - the grid runs over tiles of kRows pair rows i by kChunk consecutive
//     elements of a row (xy[i] is one contiguous [b2, S] run), each block
//     over a contiguous share of them, so a thread's pixel p and column j
//     cost one multiply-high division per tile, not per element;
//   - a thread takes four consecutive elements of each of kRows rows: its
//     xy loads (16 bytes each), y-side factors and x-side factors are all
//     issued before its arithmetic, the y-side ones read once for the
//     kRows rows, and its stores are 16 bytes wide; the mask byte is read
//     once per row and four elements; two rows, since more rows hold more
//     registers, fewer blocks fit on an SM and the launch is slower;
//   - 16-byte loads need S % 4 == 0 (the 28, 14, 32, 16 and 8 sides) and
//     16-byte aligned maps; a 7 x 7 map, or a view at an unaligned address,
//     takes the same kernel with 4-byte loads (VEC = 0).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "arccos.cuh"
#include "fast_div.cuh"
#include "launch.cuh"

namespace {

using namespace cnn_gp;

constexpr int kThreads = 256;
constexpr int kRows = 2;                     // pair rows per thread and tile
constexpr int kVec = 4;                      // elements per thread and row
constexpr unsigned kChunk = kThreads * kVec; // row elements per tile

enum Mode { kPairFast = 0, kPairReference = 1, kDiagonal = 2 };

struct Args {
  const float* xy;
  const float* xx;
  const float* yy;
  const uint8_t* mask;   // [b1, b2] bytes or null
  float* out;
  RowFactor* table;      // the "fast" form's factor table, else null
  unsigned b2;
  unsigned S;
  unsigned rows;         // b1 (pair modes) or 1 (diagonal: one row of b*S)
  unsigned n;            // elements per row: b2 * S, or b * S
  unsigned chunks;       // ceil(n / kChunk)
  unsigned tiles;        // ceil(rows / kRows) * chunks
  unsigned nx;           // xx and yy values whose factors fill the table
  unsigned ny;           // (ny 0: yy is xx)
  unsigned y_off;        // yy's first table entry (0 when yy is xx)
  FastDiv by_s;
};

// Four consecutive values at `p`, in one 16-byte load when VEC.
template <int VEC>
__device__ __forceinline__ void load4(const float* p, const bool (&in)[kVec],
                                      float (&v)[kVec]) {
  if constexpr (VEC) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = in[k] ? __ldcs(p + k) : 0.0f;
  }
}

// One tile's work of one thread: elements e .. e + 3 of pair rows i0 ..
// i0 + kRows - 1.
template <int MODE, int VEC, int EXACT>
__device__ __forceinline__ void run_tile(const Args& a, unsigned i0,
                                         unsigned e) {
  // the elements' pixels and columns: with VEC the four lie in one plane
  unsigned p[kVec], j[kVec];
  bool in[kVec];
  {
    unsigned jj = 0, pp = e;
    if constexpr (MODE != kDiagonal) {
      jj = fast_div(e, a.by_s);
      pp = e - jj * a.S;
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if constexpr (VEC) {
        p[k] = pp + k;
        j[k] = jj;
        in[k] = true;
      } else {
        in[k] = e + k < a.n;
        p[k] = pp;
        j[k] = jj;
        if (MODE != kDiagonal && ++pp == a.S) {
          pp = 0;
          ++jj;
        }
      }
    }
  }
  // every load before any arithmetic: xy, then the y side (shared by the
  // rows), then each row's x side and mask byte
  float v[kRows][kVec];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (i0 + r < a.rows)
      load4<VEC>(a.xy + static_cast<size_t>(i0 + r) * a.n + e, in, v[r]);
  }
  RowFactor fy[kVec], fx[kRows][kVec];
  float cy[kVec], cx[kRows][kVec];
  if constexpr (MODE == kPairFast) {
    const RowFactor* const ty = a.table + a.y_off + e;
#pragma unroll
    for (int k = 0; k < kVec; ++k) fy[k] = in[k] ? ty[k] : RowFactor{};
  } else {
    load4<VEC>(a.yy + e, in, cy);
  }
  bool masked[kRows][kVec];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const unsigned i = i0 + r;
    if (i >= a.rows) continue;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      masked[r][k] = MODE != kDiagonal && a.mask != nullptr && in[k]
                     && a.mask[i * a.b2 + j[k]] != 0;
    if constexpr (MODE == kPairFast) {
      const RowFactor* const tx = a.table + i * a.S;
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        fx[r][k] = in[k] ? tx[p[k]] : RowFactor{};
    } else if constexpr (MODE == kPairReference) {
      if constexpr (VEC) {
        load4<VEC>(a.xx + i * a.S + p[0], in, cx[r]);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          cx[r][k] = in[k] ? a.xx[i * a.S + p[k]] : 0.0f;
      }
    } else {
      load4<VEC>(a.xx + e, in, cx[r]);
    }
  }
  // the arithmetic and the stores
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const unsigned i = i0 + r;
    if (i >= a.rows) continue;
    float o[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (masked[r][k]) {
        o[k] = __fmul_rn(a.xx[i * a.S + p[k]], 0.5f);
      } else if constexpr (MODE == kPairFast) {
        o[k] = relu_factored(v[r][k], fx[r][k], fy[k], EXACT);
      } else {
        o[k] = relu_reference(v[r][k], cx[r][k], cy[k], EXACT);
      }
    }
    float* const dst = a.out + static_cast<size_t>(i) * a.n + e;
    if constexpr (VEC) {
      __stcs(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2],
                                                         o[3]));
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (in[k]) __stcs(dst + k, o[k]);
      }
    }
  }
}

template <int MODE, int VEC, int EXACT>
__global__ void __launch_bounds__(kThreads)
relu_kernel(const __grid_constant__ Args a) {
  if constexpr (MODE == kPairFast) {
    fill_factors(a.xx, a.nx, a.yy, a.ny, a.table);
  }
  // the block's tiles: a contiguous share, a row group's chunks in order
  const unsigned share = (a.tiles + gridDim.x - 1) / gridDim.x;
  const unsigned first = blockIdx.x * share;
  const unsigned last = first + share < a.tiles ? first + share : a.tiles;
  if (first >= last) return;
  unsigned g = first / a.chunks, c = first - g * a.chunks;
  for (unsigned t = first; t < last; ++t) {
    const unsigned e = c * kChunk + threadIdx.x * kVec;
    if (e < a.n) run_tile<MODE, VEC, EXACT>(a, g * kRows, e);
    if (++c == a.chunks) {
      c = 0;
      ++g;
    }
  }
}

template <int MODE, int VEC, int EXACT>
int launch(const Args& a, int device, cudaStream_t st) {
  const void* kernel =
      reinterpret_cast<const void*>(&relu_kernel<MODE, VEC, EXACT>);
  int blocks = 0;
  const int err = co_resident_blocks(kernel, kThreads, 0, 0, device, &blocks);
  if (err != 0) return err;
  if constexpr (MODE == kPairFast) {
    // every resident block shares the table's fill
    void* args[] = {const_cast<Args*>(&a)};
    return launch_cooperative(kernel, static_cast<unsigned>(blocks),
                              kThreads, args, 0, st);
  } else {
    const unsigned grid = a.tiles < static_cast<unsigned>(blocks)
                          ? a.tiles : static_cast<unsigned>(blocks);
    relu_kernel<MODE, VEC, EXACT><<<grid, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int MODE, int VEC>
int launch_acos(const Args& a, int exact, int device, cudaStream_t st) {
  return exact ? launch<MODE, VEC, 1>(a, device, st)
               : launch<MODE, VEC, 0>(a, device, st);
}

template <int MODE>
int launch_vec(const Args& a, bool vec, int exact, int device,
               cudaStream_t st) {
  return vec ? launch_acos<MODE, 1>(a, exact, device, st)
             : launch_acos<MODE, 0>(a, exact, device, st);
}

}  // namespace

extern "C" {

// Launches the ReLU map on `stream` and returns its error code (0 on
// success; cudaErrorInvalidValue for 2^31 elements or more, or a "fast"
// launch without a table; the card's refusal of a cooperative launch).
// mode 0: pair "fast"; 1: pair "reference"; 2: diagonal (b1 is b, b2
// unused, mask null).  exact: acosf instead of the polynomial.
// mask: [b1, b2] bytes (torch.bool) or null.  table: mode 0's factor
// table, float32 (r, s) pairs laid out as factor_y_offset says
// (csrc/arccos.cuh; yy is xx when the two pointers and b1, b2 agree),
// null otherwise.  Does not synchronise and allocates nothing.
int cnn_gp_relu(const float* xy, const float* xx, const float* yy,
                const uint8_t* mask, float* out, int b1, int b2, int S,
                int mode, int exact, float* table, int device,
                void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode < kPairFast || mode > kDiagonal || (mode == kDiagonal && mask)
      || (mode == kPairFast) != (table != nullptr) || b1 < 0 || b2 < 0
      || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool diag = mode == kDiagonal;
  const long long total = static_cast<long long>(b1) * (diag ? 1 : b2) * S;
  if (total == 0) return 0;
  const bool same = !diag && xx == yy && b1 == b2;
  const long long entries = static_cast<long long>(b1) * S
                            + (same ? 0 : static_cast<long long>(b2) * S + 3);
  if (total > INT_MAX || entries > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.xy = xy;
  a.xx = xx;
  a.yy = yy;
  a.mask = mask;
  a.out = out;
  a.table = reinterpret_cast<RowFactor*>(table);
  a.b2 = static_cast<unsigned>(diag ? 1 : b2);
  a.S = static_cast<unsigned>(S);
  a.rows = static_cast<unsigned>(diag ? 1 : b1);
  a.n = static_cast<unsigned>(diag ? total : static_cast<long long>(b2) * S);
  a.chunks = (a.n + kChunk - 1) / kChunk;
  a.tiles = (a.rows + kRows - 1) / kRows * a.chunks;
  a.nx = static_cast<unsigned>(b1) * a.S;
  a.ny = same ? 0u : static_cast<unsigned>(b2) * a.S;
  a.y_off = same ? 0u : factor_y_offset(a.nx);
  a.by_s = make_fast_div(a.S);
  // 16-byte loads and stores: whole 4-element groups in one plane (S % 4,
  // or the diagonal's flat length), and every map they touch aligned
  const bool vec = (diag ? total % 4 == 0 : S % 4 == 0) && aligned16(xy)
                   && aligned16(out)
                   && (mode == kPairFast || (aligned16(xx) && aligned16(yy)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPairFast:
      return launch_vec<kPairFast>(a, vec, exact, device, st);
    case kPairReference:
      return launch_vec<kPairReference>(a, vec, exact, device, st);
    default:
      return launch_vec<kDiagonal>(a, vec, exact, device, st);
  }
}

const char* cnn_gp_relu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
