// Per-image pre-pass of the ConvNet-GP megakernel for Hopper (sm_90a).
//
// Replaces the xx / yy recursion of the Pallas TPU kernel
// cnn_gp_tpu/ops/megakernel.py::_kernel (its lines "xx = xc * xc ...",
// "xx = _box2d(xx, k) * scale + vb", "xx = xx * 0.5"), which the TPU
// kernel recomputed for every grid step because a step held the whole
// row block.  Those maps depend on one image only, so this kernel
// computes them once per image, for the pair kernel in csrc/megakernel.cu
// to read: for image n,
//     h_0 = (sum_c x_c * x_c) * (1/C),
//     d_l = box_k(h_{l-1}) * (vw_l / k^2) + vb_l,   h_l = d_l * 0.5,
// written as out[l, n] = d_l, the pre-ReLU map of layer l.
//
// The arithmetic is that of the plain version
// (cnn_gp_tpu_torch/ops/megakernel.py::diag_maps_reference) operation for
// operation: channels in order, "* (1/C)", the box sum along H and then
// along W with the taps added in ascending order, then "* scale" and
// "+ bias", each rounded on its own (__fmul_rn / __fadd_rn keep nvcc from
// contracting them into FMAs).  So its maps are bit-identical to the
// plain version's and to the xx of the per-pair recursion.
//
// What bounds it: bytes.  At the paper tile (128 images, 28x28, L=7) it
// reads 0.4 MB and writes 2.8 MB (about 1 us at 3.35 TB/s) and does ~17
// flop per pixel and layer (1.2e7 in all, well under 1 us of FP32).  What
// it waits on is latency: each layer is two dependent passes of k
// chained adds behind a barrier.  So one block per image keeps the
// image's map and a scratch copy in shared memory with one thread per
// pixel (up to 1,024) and the tap loops unrolled, so that their loads
// go out together; the L layers run with two barriers each.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 227 * 1024;        // per block, on sm_90

// x: [b, C, S, S]; layers: [L, 2] of (vw / k^2, vb); out: [L, b, S, S].
__global__ void __launch_bounds__(kMaxThreads)
diag_maps_kernel(const float* __restrict__ x,
                 const float* __restrict__ layers, float* __restrict__ out,
                 int b, int C, int S, int k, int L, float inv_c) {
  extern __shared__ float smem[];
  const int SS = S * S, half = k / 2;
  float* m = smem;
  float* t = smem + SS;
  const int n = blockIdx.x;
  const float* xn = x + static_cast<long long>(n) * C * SS;
  for (int p = threadIdx.x; p < SS; p += blockDim.x) {
    float s = __fmul_rn(xn[p], xn[p]);
    for (int c = 1; c < C; ++c) {
      const float a = xn[c * SS + p];
      s = __fadd_rn(s, __fmul_rn(a, a));
    }
    m[p] = __fmul_rn(s, inv_c);
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const float scale = layers[2 * l], bias = layers[2 * l + 1];
    for (int p = threadIdx.x; p < SS; p += blockDim.x) {   // along H
      const int h = p / S, w = p - (p / S) * S;
      const int lo = max(0, h - half), hi = min(S - 1, h + half);
      float s = 0.0f;
#pragma unroll 8
      for (int q = lo; q <= hi; ++q) s = __fadd_rn(s, m[q * S + w]);
      t[p] = s;
    }
    __syncthreads();
    float* o = out + (static_cast<long long>(l) * b + n) * SS;
    for (int p = threadIdx.x; p < SS; p += blockDim.x) {   // along W
      const int h = p / S, w = p - (p / S) * S;
      const int lo = max(0, w - half), hi = min(S - 1, w + half);
      float s = 0.0f;
#pragma unroll 8
      for (int q = lo; q <= hi; ++q) s = __fadd_rn(s, t[h * S + q]);
      const float d = __fadd_rn(__fmul_rn(s, scale), bias);
      o[p] = d;
      m[p] = __fmul_rn(d, 0.5f);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches the pre-pass for b images on `stream` and returns
// cudaGetLastError() (0 on success).  Does not synchronise and allocates
// nothing.
int cnn_gp_diag_maps(const float* x, const float* layers, float* out, int b,
                     int C, int S, int k, int L, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(S) * S * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(diag_maps_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // "* (1/C)" with 1/C rounded as torch rounds the Python float 1.0 / C
  const float inv_c = static_cast<float>(1.0 / C);
  const int pixels = S * S;
  const int threads = pixels < kMaxThreads ? (pixels + 31) / 32 * 32
                                           : kMaxThreads;
  diag_maps_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, layers, out, b, C, S, k, L, inv_c);
  return static_cast<int>(cudaGetLastError());
}

const char* cnn_gp_diag_maps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
