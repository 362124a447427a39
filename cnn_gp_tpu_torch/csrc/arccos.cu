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
// the small side maps.)
//
// Arithmetic: that of the plain version
// (cnn_gp_tpu_torch/ops/arccos.py::relu_xy_reference) operation for
// operation, each step rounded on its own (__fmul_rn / __fadd_rn /
// __fsqrt_rn: no FMA contraction), rsqrtf and acosf as torch's CUDA
// rsqrt and acos call them, and the constants rounded from the doubles the
// plain version's Python floats hold.  The row and column factors
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

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "fast_div.cuh"

namespace {

constexpr int kThreads = 256;
// The plain version's Python floats, rounded to float32 as torch rounds a
// scalar operand (from the double, not from the decimal).
constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kHalfPi = static_cast<float>(kPiD / 2.0);
constexpr float kHalfInvPi = static_cast<float>(0.5 / kPiD);
constexpr float kTiny = FLT_MIN;            // F32_TINY
constexpr float kP0 = static_cast<float>(4.2163199048e-2);
constexpr float kP1 = static_cast<float>(2.4181311049e-2);
constexpr float kP2 = static_cast<float>(4.5470025998e-2);
constexpr float kP3 = static_cast<float>(7.4953002686e-2);
constexpr float kP4 = static_cast<float>(1.6666752422e-1);

enum Mode { kPairFast = 0, kPairReference = 1, kDiagonal = 2 };

// NaN-propagating max and min, like torch.clamp (fmaxf / fminf would turn
// a NaN into the bound).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float clip_unit(float v) {
  return min_nan(max_nan(v, -1.0f), 1.0f);
}

// float32 arccos from sqrt and multiply-adds (the Cephes asinf
// polynomial), cnn_gp_tpu_torch/ops/arccos.py::acos_f32 step by step.
__device__ __forceinline__ float acos_poly(float x) {
  const float a = fabsf(x);
  const bool big = a > 0.5f;
  const float z_big = __fmul_rn(0.5f, __fsub_rn(1.0f, a));
  const float z = big ? z_big : __fmul_rn(a, a);
  const float t = big ? __fsqrt_rn(z_big) : a;
  float p = __fadd_rn(__fmul_rn(kP0, z), kP1);
  p = __fadd_rn(__fmul_rn(p, z), kP2);
  p = __fadd_rn(__fmul_rn(p, z), kP3);
  p = __fadd_rn(__fmul_rn(p, z), kP4);
  const float asin_core = __fadd_rn(t, __fmul_rn(__fmul_rn(t, z), p));
  const float acos_abs = big ? __fmul_rn(2.0f, asin_core)
                             : __fsub_rn(kHalfPi, asin_core);
  return x < 0.0f ? __fsub_rn(kPi, acos_abs) : acos_abs;
}

__device__ __forceinline__ float acos_any(float x, int exact) {
  return exact ? acosf(x) : acos_poly(x);
}

// _xy_update_factored: the hoisted row and column factors, recomputed here.
__device__ __forceinline__ float relu_fast(float v, float cx, float cy,
                                           int exact) {
  const float ax = __fadd_rn(cx, kTiny), ay = __fadd_rn(cy, kTiny);
  const float f = __fmul_rn(rsqrtf(ax), rsqrtf(ay));   // before xy
  const float c = clip_unit(__fmul_rn(v, f));
  const float s = __fmul_rn(
      __fmul_rn(__fsqrt_rn(ax), __fsqrt_rn(ay)),
      __fsqrt_rn(max_nan(__fsub_rn(1.0f, __fmul_rn(c, c)), 0.0f)));
  const float pi_minus_t = acos_any(-c, exact);
  return __fmul_rn(__fadd_rn(s, __fmul_rn(pi_minus_t, v)), kHalfInvPi);
}

// _xy_update: the reference's order of operations.
__device__ __forceinline__ float relu_reference(float v, float cx, float cy,
                                                int exact) {
  const float xx_yy = __fadd_rn(__fmul_rn(cx, cy), kTiny);
  const float c = clip_unit(__fmul_rn(v, rsqrtf(xx_yy)));
  const float s = __fsqrt_rn(max_nan(__fsub_rn(xx_yy, __fmul_rn(v, v)),
                                     0.0f));
  const float t = acos_any(c, exact);
  return __fmul_rn(__fadd_rn(s, __fmul_rn(__fsub_rn(kPi, t), v)),
                   kHalfInvPi);
}

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
