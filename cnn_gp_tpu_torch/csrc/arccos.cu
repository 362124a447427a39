// The arccos ReLU covariance map for Hopper (sm_90a).
//
// Replaces work that the JAX package leaves to XLA (no Pallas kernel):
// cnn_gp_tpu/ops/arccos.py::_relu_xla, with _xy_update_factored (the
// "fast" relu_impl), _xy_update ("reference", and the diagonal mode) and
// acos_f32 (the "poly" acos_impl; "exact" is acosf), which XLA fuses into
// one elementwise loop.  One thread per pair-pixel e = (i, j, p) computes
//     xy'[i, j, p] = (sin t + (pi - t) * xy) / (2 pi),
//     cos t = clip(xy * (r_xx[i, p] * r_yy[j, p]), -1, 1)   ("fast"), or
//     cos t = clip(xy * rsqrt(xx[i, p] * yy[j, p] + tiny), -1, 1),
// and writes xx[i, p] / 2 where mask[i, j] marks a same-example pair.
// Pair mode: xy [b1, b2, S], xx [b1, S], yy [b2, S], mask [b1, b2] or
// none.  Diagonal mode: xy, xx, yy all [b, S], the reference form
// elementwise, no mask.  (xx' = xx / 2 and yy' stay torch multiplies on
// the small side maps.)  A ReLU whose every consumer is a Conv2d does not
// come here: it runs in the box filter's prologue (csrc/boxfilter.cu),
// on the same device math.
//
// Arithmetic: that of the plain version
// (cnn_gp_tpu_torch/ops/arccos.py::relu_xy_reference) operation for
// operation, in csrc/arccos.cuh (shared with the box filter's prologue).
// The row and column factors
// (rsqrt and sqrt of xx + tiny and yy + tiny) are recomputed per element
// (no pre-step launch): four special-function calls against a read of
// 4 bytes.  The factor (r_xx[i] * r_yy[j]) is formed before it multiplies
// xy, and every element runs the same instruction sequence, so a diagonal
// tile stays exactly symmetric.  The kernel is held to 1e-6 of max|xy'|
// against the plain version on the card, not to bit equality.
//
// What bounds it: bytes.  A 200 x 200 tile of 28 x 28 maps reads its
// 125 MB xy map once and writes 125 MB (75 us at 3.35 TB/s); its ~45
// FP32 operations per element (1.4e9) take 21 us at 67 TFLOP/s, and its
// five to six special-function calls per element about 45 us at 16 per
// clock per SM.  The design: one thread per element, neighbouring threads
// on neighbouring pixels, so the xy loads and xy' stores coalesce and the
// xx / yy rows (a b x S map each) stay in L1 / L2; the same-example test
// reads one byte per pair, cached.  The element's (i, j, p) comes from
// two multiply-high divisions (csrc/fast_div.cuh), not two 20-instruction
// integer divisions.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "arccos.cuh"
#include "fast_div.cuh"

namespace {

using namespace cnn_gp;

constexpr int kThreads = 256;

enum Mode { kPairFast = 0, kPairReference = 1, kDiagonal = 2 };

__global__ void __launch_bounds__(kThreads)
relu_kernel(const float* __restrict__ xy, const float* __restrict__ xx,
            const float* __restrict__ yy, const uint8_t* __restrict__ mask,
            float* __restrict__ out, unsigned total, unsigned b2, unsigned S,
            FastDiv by_b2, FastDiv by_s, int mode, int exact) {
  // 32-bit index arithmetic (the host refuses 2^31 elements or more)
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const unsigned ij = fast_div(e, by_s), p = e - ij * S;
    unsigned i = ij, j = ij;
    if (mode != kDiagonal) {
      i = fast_div(ij, by_b2);
      j = ij - i * b2;
    }
    const float cx = xx[static_cast<size_t>(i) * S + p];
    if (mask != nullptr && mask[ij]) {
      out[e] = __fmul_rn(cx, 0.5f);
      continue;
    }
    const float cy = yy[static_cast<size_t>(j) * S + p], v = xy[e];
    out[e] = mode == kPairFast ? relu_fast(v, cx, cy, exact)
                               : relu_reference(v, cx, cy, exact);
  }
}

}  // namespace

extern "C" {

// Launches the ReLU map on `stream` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for 2^31 elements or more).  mode 0:
// pair "fast"; 1: pair "reference"; 2: diagonal (b1 is b, b2 unused, mask
// null).  exact: acosf instead of the polynomial.
// mask: [b1, b2] bytes (torch.bool) or null.  Does not synchronise and
// allocates nothing.
int cnn_gp_relu(const float* xy, const float* xx, const float* yy,
                const uint8_t* mask, float* out, int b1, int b2, int S,
                int mode, int exact, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode < kPairFast || mode > kDiagonal || (mode == kDiagonal && mask))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(b1)
                          * (mode == kDiagonal ? 1 : b2) * S;
  if (total == 0) return 0;
  if (total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  relu_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xy, xx, yy, mask, out, static_cast<unsigned>(total),
      static_cast<unsigned>(b2), static_cast<unsigned>(S),
      make_fast_div(static_cast<unsigned>(b2)),
      make_fast_div(static_cast<unsigned>(S)), mode, exact);
  return static_cast<int>(cudaGetLastError());
}

const char* cnn_gp_relu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
