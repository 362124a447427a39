// The NNGP Conv2d covariance map, a scaled box filter, for Hopper (sm_90a).
//
// Replaces work that the JAX package leaves to XLA (no Pallas kernel):
// cnn_gp_tpu/ops/boxfilter.py::box_filter_2d (default "separable",
// _reduce_window_1d; "shifts", _shift_sum_1d), called per field by
// cnn_gp_tpu/kernels.py::Conv2d.propagate and followed there by
// "* var_weight / k^2 + var_bias".  One launch takes up to three float32
// maps of [P, W, H] planes (the xy pair map and the xx / yy side maps of
// one Conv2d; two when yy is xx, a block of one set after its first ReLU,
// whose yy' is then xx') and writes, for each plane,
//     out[p, o, q] = (sum_{c<k} sum_{a<k} xp[p, o*s + a*d, q*s + c*d])
//                    * scale + bias,
// where xp is the plane zero-padded by (lo, hi) on each axis; with
// affine == 0 it writes the windowed sum alone (box_filter_2d).
//
// Arithmetic: that of the plain version
// (cnn_gp_tpu_torch/ops/boxfilter.py::conv_maps_reference) operation for
// operation.  The plain version adds k strided slices along W (slice
// a = 0, then a = 1, ...) into a [Wo, H] sum, then k strided slices of
// that along H in the same order, then multiplies by the scale, then adds
// the bias.  The kernel forms the same [Wo, H] sums in the same order (a
// tap in the padding adds +0.0, as F.pad's zeros do), adds them along H
// in order, and rounds every step on its own (__fadd_rn / __fmul_rn keep
// nvcc from contracting into FMAs).  So the output is bit-equal to the
// plain version on the card.  The scale is the float32 the plain version
// multiplies by: var_weight / k^2 rounded from the Python float, or read
// from the card when it is a learnable leaf.
//
// What bounds it: bytes.  A 200 x 200 tile of 28 x 28 maps with k = 3
// reads its 125 MB xy map once and writes 125 MB (75 us at 3.35 TB/s);
// its separable sums take 2(k - 1) + 2 operations per output element
// (1.9e8, 3 us of FP32).  The design: a block stages a run of whole
// planes (up to 8,192 floats of input and [Wo, H] sums, 32 KB of shared
// memory; the planes of a map are contiguous, so the loads and the
// stores of a block are one contiguous, coalesced range each), forms the
// [Wo, H] sums of the W pass in shared memory, then the H pass writes the
// outputs; one thread per element in each pass, neighbouring threads on
// the contiguous axis, its indices from multiply-high divisions
// (csrc/fast_div.cuh).  A plane too large for 48 KB of staging (maps
// above about 78 x 78, which no config uses) takes the unstaged kernel:
// one thread per output element, recomputing the W sums of its k columns
// from global memory, the same bits.  (The fused ResNet layer, the ReLU
// in the prologue and the Sum add in the epilogue, is later work.)

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "fast_div.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int kStageFloats = 8192;     // staged input + W sums per block
constexpr int kMaxPlanesPerBlock = 64;
constexpr int kMaxStaticSmem = 48 * 1024;

// Up to three maps: x0 -> y0 holds p0 planes, x1 -> y1 p1, x2 -> y2 p2.
struct Maps {
  const float* x0;
  const float* x1;
  const float* x2;
  float* y0;
  float* y1;
  float* y2;
  unsigned p0;
  unsigned p1;
  unsigned p2;
};

__device__ __forceinline__ void affine_operands(int affine, float* scale,
                                                float* bias,
                                                const float* scale_p,
                                                const float* bias_p) {
  if (affine) {
    if (scale_p != nullptr) *scale = *scale_p;
    if (bias_p != nullptr) *bias = *bias_p;
  }
}

// The staged kernel: block b takes ppb planes of one map (blocks0 blocks
// for map 0, then blocks1 for map 1, then map 2).
__global__ void __launch_bounds__(kThreads)
box_filter_staged(Maps m, unsigned blocks0, unsigned blocks1, int ppb,
                  int W, int H, int Wo, int Ho, FastDiv by_mid, FastDiv by_h,
                  FastDiv by_out, FastDiv by_ho, int k, int stride, int lo,
                  int dilation, int affine, float scale, float bias,
                  const float* __restrict__ scale_p,
                  const float* __restrict__ bias_p) {
  extern __shared__ float smem[];
  affine_operands(affine, &scale, &bias, scale_p, bias_p);
  unsigned blk = blockIdx.x;
  const float* x;
  float* y;
  unsigned planes;
  if (blk < blocks0) {
    x = m.x0;
    y = m.y0;
    planes = m.p0;
  } else if (blk - blocks0 < blocks1) {
    blk -= blocks0;
    x = m.x1;
    y = m.y1;
    planes = m.p1;
  } else {
    blk -= blocks0 + blocks1;
    x = m.x2;
    y = m.y2;
    planes = m.p2;
  }
  const unsigned first = blk * ppb;
  const int n = static_cast<int>(planes - first < static_cast<unsigned>(ppb)
                                 ? planes - first : ppb);
  const int in_size = W * H, mid_size = Wo * H, out_size = Wo * Ho;
  float* xs = smem;                         // [n, W, H]
  float* ts = smem + ppb * in_size;         // [n, Wo, H]: the W sums
  const float* src = x + static_cast<size_t>(first) * in_size;
  for (int e = threadIdx.x; e < n * in_size; e += blockDim.x) xs[e] = src[e];
  __syncthreads();
  for (int e = threadIdx.x; e < n * mid_size; e += blockDim.x) {
    const int p = fast_div(e, by_mid), r = e - p * mid_size;
    const int o = fast_div(r, by_h), h = r - o * H;
    const float* xp = xs + p * in_size + h;
    const int w0 = o * stride - lo;
    float col = 0.0f;
    for (int a = 0; a < k; ++a) {
      const int w = w0 + a * dilation;
      const float v = (w >= 0 && w < W) ? xp[w * H] : 0.0f;
      col = a == 0 ? v : __fadd_rn(col, v);
    }
    ts[e] = col;
  }
  __syncthreads();
  float* dst = y + static_cast<size_t>(first) * out_size;
  for (int e = threadIdx.x; e < n * out_size; e += blockDim.x) {
    const int p = fast_div(e, by_out), r = e - p * out_size;
    const int o = fast_div(r, by_ho), q = r - o * Ho;
    const float* tp = ts + p * mid_size + o * H;
    const int h0 = q * stride - lo;
    float sum = 0.0f;
    for (int c = 0; c < k; ++c) {
      const int h = h0 + c * dilation;
      const float v = (h >= 0 && h < H) ? tp[h] : 0.0f;  // F.pad's zeros
      sum = c == 0 ? v : __fadd_rn(sum, v);
    }
    if (affine) sum = __fadd_rn(__fmul_rn(sum, scale), bias);
    dst[e] = sum;
  }
}

// The unstaged kernel: one thread per output element.
__global__ void __launch_bounds__(kThreads)
box_filter_kernel(Maps m, unsigned total, int W, int H, int Wo, int Ho,
                  FastDiv by_out, FastDiv by_ho,
                  int k, int stride, int lo, int dilation, int affine,
                  float scale, float bias, const float* __restrict__ scale_p,
                  const float* __restrict__ bias_p) {
  affine_operands(affine, &scale, &bias, scale_p, bias_p);
  // 32-bit index arithmetic (the host refuses 2^31 outputs or more)
  const unsigned per = static_cast<unsigned>(Wo) * Ho;
  const size_t plane_in = static_cast<size_t>(W) * H;
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    unsigned plane = fast_div(e, by_out);
    const unsigned r = e - plane * per;
    const int o = static_cast<int>(fast_div(r, by_ho));
    const int q = static_cast<int>(r) - o * Ho;
    const float* x;
    float* y;
    if (plane < m.p0) {
      x = m.x0;
      y = m.y0;
    } else if (plane - m.p0 < m.p1) {
      plane -= m.p0;
      x = m.x1;
      y = m.y1;
    } else {
      plane -= m.p0 + m.p1;
      x = m.x2;
      y = m.y2;
    }
    const float* xp = x + plane * plane_in;
    const int w0 = o * stride - lo, h0 = q * stride - lo;
    float sum = 0.0f;
    for (int c = 0; c < k; ++c) {
      const int h = h0 + c * dilation;
      float col = 0.0f;                      // a padded row of F.pad
      if (h >= 0 && h < H) {
        for (int a = 0; a < k; ++a) {
          const int w = w0 + a * dilation;
          const float v = (w >= 0 && w < W) ? xp[w * H + h] : 0.0f;
          col = a == 0 ? v : __fadd_rn(col, v);
        }
      }
      sum = c == 0 ? col : __fadd_rn(sum, col);
    }
    if (affine) sum = __fadd_rn(__fmul_rn(sum, scale), bias);
    y[static_cast<size_t>(plane) * per + r] = sum;
  }
}

}  // namespace

extern "C" {

// Launches the box filter over p0 + p1 + p2 planes of [W, H] (x_f -> y_f,
// slot f unused when p_f == 0) on `stream` and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue for 2^31 elements or more).
// scale_p / bias_p, when not null, point at the float32
// scale / bias on the card and take the place of scale / bias.  Does not
// synchronise and allocates nothing.
int cnn_gp_box_filter(const float* x0, float* y0, long long p0,
                      const float* x1, float* y1, long long p1,
                      const float* x2, float* y2, long long p2, int W, int H,
                      int Wo, int Ho, int k, int stride, int lo, int dilation,
                      int affine, float scale, float bias,
                      const float* scale_p, const float* bias_p, int device,
                      void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (p0 + p1 + p2) * Wo * Ho;
  if (total == 0) return 0;
  if (total > INT_MAX || (p0 + p1 + p2) * W * H > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Maps m{x0, x1, x2, y0, y1, y2, static_cast<unsigned>(p0),
               static_cast<unsigned>(p1), static_cast<unsigned>(p2)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_plane = W * H + Wo * H;
  if (per_plane * static_cast<int>(sizeof(float)) <= kMaxStaticSmem) {
    const int fit = kStageFloats / per_plane;   // 0 for a plane > 32 KB
    const int ppb = fit < 1 ? 1
                    : (fit > kMaxPlanesPerBlock ? kMaxPlanesPerBlock : fit);
    const unsigned b0 = static_cast<unsigned>((p0 + ppb - 1) / ppb);
    const unsigned b1 = static_cast<unsigned>((p1 + ppb - 1) / ppb);
    const unsigned b2 = static_cast<unsigned>((p2 + ppb - 1) / ppb);
    box_filter_staged<<<b0 + b1 + b2, kThreads,
                        ppb * per_plane * sizeof(float), st>>>(
        m, b0, b1, ppb, W, H, Wo, Ho, make_fast_div(Wo * H),
        make_fast_div(H), make_fast_div(Wo * Ho), make_fast_div(Ho), k,
        stride, lo, dilation, affine, scale, bias, scale_p, bias_p);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  box_filter_kernel<<<blocks, kThreads, 0, st>>>(
      m, static_cast<unsigned>(total), W, H, Wo, Ho, make_fast_div(Wo * Ho),
      make_fast_div(Ho), k, stride, lo, dilation, affine, scale, bias,
      scale_p, bias_p);
  return static_cast<int>(cudaGetLastError());
}

const char* cnn_gp_box_filter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
