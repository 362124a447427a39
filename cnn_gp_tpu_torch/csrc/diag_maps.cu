// Per-image pre-pass of the ConvNet-GP megakernel for Hopper (sm_90a).
//
// Replaces the xx / yy recursion of the Pallas TPU kernel
// cnn_gp_tpu/ops/megakernel.py::_kernel (its lines "xx = xc * xc ...",
// "xx = _box2d(xx, k) * scale + vb", "xx = xx * 0.5"), which the TPU
// kernel recomputed for every grid step because a step held the whole
// row block.  Those maps depend on one image only, so this kernel
// computes them once per image set, for the pair kernel in
// csrc/megakernel.cu to read as slices: for image n,
//     h_0 = (sum_c x_c * x_c) * (1/C),
//     d_l = box_k(h_{l-1}) * (vw_l / k^2) + vb_l,   h_l = d_l * 0.5,
// written as out[l, n] = d_l, the pre-ReLU map of layer l.  A Gram-level
// call launches it once per image set (thousands of images); a single
// tile (ops/megakernel.py::gram_tile) once per side.
//
// The arithmetic is that of the plain version
// (cnn_gp_tpu_torch/ops/megakernel.py::diag_maps_reference) operation for
// operation: channels in order, "* (1/C)", the box sum along H and then
// along W over the zero-padded map with the taps added in ascending
// order from the first, then "* scale" and "+ bias", each rounded on its
// own (__fmul_rn / __fadd_rn keep nvcc from contracting them into FMAs).
// So its maps are bit-identical to the plain version's and to the xx of
// the per-pair recursion.
//
// What bounds it: bytes.  A whole-set launch of 16,384 28x28 images with
// L = 7 reads 51 MB and writes 360 MB (0.123 ms at 3.35 TB/s) and does
// ~17 FP32 operations per pixel and layer (0.02 ms).  The 128 images of
// one tile side move 3.2 MB (1 us), so there the launch's latency is
// what counts.
//
// The design.  For the map sizes the pair kernel specialises (28x28 k=7,
// 8x8 k=3, 32x32 k=7) S and k are template parameters: a block holds G
// images (G chosen by the host so that the grid fills the SMs at any N,
// up to images_per_block(S)), each as a map m with k/2 zero rows above
// and below and a scratch t with 4 zero columns each side, both in
// shared memory.
// A layer is two passes and two barriers for all G images: in the H pass
// a thread reads a segment of a column plus its k-1 neighbours into
// registers and sums each of the segment's outputs over its window; in
// the W pass a thread reads three 16-byte words of a row of t (its four
// outputs' windows) and writes its four maps as one 16-byte store, both
// to the output and, halved, to m.  The padding zeros are added as +0.0,
// as the plain version's padded slices add them, so no bit moves.  Tap
// indices are compile-time constants, so the loads of a window go out
// together.  Every other geometry runs the run-time kernel below: one
// block per image, one thread per pixel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFixedThreads = 256;
constexpr int kMaxSmem = 227 * 1024;        // per block, on sm_90

// Most images one block of the fixed kernel holds.
__host__ __device__ constexpr int images_per_block(int s) {
  return s <= 8 ? 32 : 8;
}

// Rows of a column one thread of the H pass sums: S / 4 at 28 and 32.
__host__ __device__ constexpr int column_segment(int s) {
  return s <= 8 ? s : s / 4;
}

__device__ __forceinline__ float4 sq4(float4 a) {
  return make_float4(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y),
                     __fmul_rn(a.z, a.z), __fmul_rn(a.w, a.w));
}

// x: [N, C, S, S]; layers: [L, 2] of (vw / k^2, vb); out: [L, N, S, S],
// 16-byte aligned.  Block b holds images b * G .. b * G + G - 1.
// vec: x is 16-byte aligned (else its loads are 4 bytes wide).
template <int S, int K>
__global__ void __launch_bounds__(kFixedThreads)
diag_maps_fixed(const float* __restrict__ x,
                const float* __restrict__ layers, float* __restrict__ out,
                int N, int C, int L, int G, float inv_c, bool vec) {
  constexpr int kHalf = K / 2;
  constexpr int SS = S * S;
  constexpr int kQuads = S / 4;              // 16-byte words per row
  constexpr int kM = (S + 2 * kHalf) * S;    // m: padded rows
  constexpr int kPitch = S + 8;              // t: 4 zero columns each side
  constexpr int kImage = kM + S * kPitch;
  constexpr int kSeg = column_segment(S);
  constexpr int kHItems = S * (S / kSeg);    // per image: column segments
  constexpr int kWItems = S * kQuads;        // per image: row quads
  constexpr int kWin = kSeg + K - 1;
  static_assert(S % 4 == 0 && S % kSeg == 0, "S must be a multiple of 4");
  static_assert(kHalf <= 4, "the W window is three 16-byte words");
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * G;
  const int g_n = min(G, N - n0);

  // the padding: m's kHalf rows above and below, t's columns 0-3 and
  // S+4..S+7 (never written afterwards)
  constexpr int kMPad = kHalf * S / 4;       // 16-byte words per side
  for (int q = threadIdx.x; q < g_n * (2 * kMPad + 2 * S);
       q += kFixedThreads) {
    const int g = q / (2 * kMPad + 2 * S), r = q - g * (2 * kMPad + 2 * S);
    float* m = smem + g * kImage;
    float* dst;
    if (r < 2 * kMPad) {
      dst = m + (r < kMPad ? 4 * r : (S + kHalf) * S + 4 * (r - kMPad));
    } else {
      const int row = (r - 2 * kMPad) >> 1;
      dst = m + kM + row * kPitch + ((r & 1) ? S + 4 : 0);
    }
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // h_0 into m's rows kHalf .. kHalf + S - 1
  if (vec) {
    for (int q = threadIdx.x; q < g_n * (SS / 4); q += kFixedThreads) {
      const int g = q / (SS / 4), p = 4 * (q - g * (SS / 4));
      const float4* xn = reinterpret_cast<const float4*>(
          x + static_cast<long long>(n0 + g) * C * SS + p);
      float4 s = sq4(__ldg(xn));
      for (int c = 1; c < C; ++c) {
        const float4 a = sq4(__ldg(xn + c * (SS / 4)));
        s = make_float4(__fadd_rn(s.x, a.x), __fadd_rn(s.y, a.y),
                        __fadd_rn(s.z, a.z), __fadd_rn(s.w, a.w));
      }
      s = make_float4(__fmul_rn(s.x, inv_c), __fmul_rn(s.y, inv_c),
                      __fmul_rn(s.z, inv_c), __fmul_rn(s.w, inv_c));
      *reinterpret_cast<float4*>(smem + g * kImage + kHalf * S + p) = s;
    }
  } else {
    for (int q = threadIdx.x; q < g_n * SS; q += kFixedThreads) {
      const int g = q / SS, p = q - g * SS;
      const float* xn = x + static_cast<long long>(n0 + g) * C * SS + p;
      float s = __fmul_rn(xn[0], xn[0]);
      for (int c = 1; c < C; ++c) {
        const float a = xn[c * SS];
        s = __fadd_rn(s, __fmul_rn(a, a));
      }
      smem[g * kImage + kHalf * S + p] = __fmul_rn(s, inv_c);
    }
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const float scale = layers[2 * l], bias = layers[2 * l + 1];
    // H pass: output rows r0 .. r0 + kSeg - 1 of column w, from padded
    // rows r0 .. r0 + kSeg + K - 2 of m
    for (int q = threadIdx.x; q < g_n * kHItems; q += kFixedThreads) {
      const int g = q / kHItems, r = q - g * kHItems;
      const int seg = r / S, w = r - seg * S;
      const float* mc = smem + g * kImage + seg * kSeg * S + w;
      float v[kWin];
#pragma unroll
      for (int j = 0; j < kWin; ++j) v[j] = mc[j * S];
      float* tc = smem + g * kImage + kM + seg * kSeg * kPitch + 4 + w;
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        float s = v[i];
#pragma unroll
        for (int a = 1; a < K; ++a) s = __fadd_rn(s, v[i + a]);
        tc[i * kPitch] = s;
      }
    }
    __syncthreads();
    // W pass: outputs c0 .. c0 + 3 of row h, from t's padded columns
    // c0 .. c0 + 11 (real columns c0 - 4 .. c0 + 7)
    float* o = out + (static_cast<long long>(l) * N + n0) * SS;
    for (int q = threadIdx.x; q < g_n * kWItems; q += kFixedThreads) {
      const int g = q / kWItems, r = q - g * kWItems;
      const int h = r / kQuads, c0 = 4 * (r - h * kQuads);
      const float4* tr = reinterpret_cast<const float4*>(
          smem + g * kImage + kM + h * kPitch + c0);
      const float4 a = tr[0], b = tr[1], c = tr[2];
      const float v[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                           b.z, b.w, c.x, c.y, c.z, c.w};
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = v[j + 4 - kHalf];
#pragma unroll
        for (int t = 1; t < K; ++t) s = __fadd_rn(s, v[j + 4 - kHalf + t]);
        d[j] = __fadd_rn(__fmul_rn(s, scale), bias);
      }
      const int p = h * S + c0;
      *reinterpret_cast<float4*>(o + g * SS + p) =
          make_float4(d[0], d[1], d[2], d[3]);
      if (l + 1 < L)
        *reinterpret_cast<float4*>(smem + g * kImage + kHalf * S + p) =
            make_float4(__fmul_rn(d[0], 0.5f), __fmul_rn(d[1], 0.5f),
                        __fmul_rn(d[2], 0.5f), __fmul_rn(d[3], 0.5f));
    }
    __syncthreads();
  }
}

// Any S and k: one block per image, the image's map and a scratch copy in
// shared memory with one thread per pixel (up to 1,024).
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int S, int K>
int launch_fixed(const float* x, const float* layers, float* out, int N,
                 int C, int L, float inv_c, int device, cudaStream_t stream) {
  constexpr int kImage = (S + 2 * (K / 2)) * S + S * (S + 8);
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // images per block: enough blocks for two per SM, at most
  // images_per_block(S)
  int g = N / (2 * sms);
  g = g < 1 ? 1 : (g > images_per_block(S) ? images_per_block(S) : g);
  const size_t smem = static_cast<size_t>(g) * kImage * sizeof(float);
  err = set_smem(diag_maps_fixed<S, K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((N + g - 1) / g);
  diag_maps_fixed<S, K><<<blocks, kFixedThreads, smem, stream>>>(
      x, layers, out, N, C, L, g, inv_c, aligned16(x));
  return static_cast<int>(cudaGetLastError());
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
  // "* (1/C)" with 1/C rounded as torch rounds the Python float 1.0 / C
  const float inv_c = static_cast<float>(1.0 / C);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(out)) {
    if (S == 28 && k == 7)
      return launch_fixed<28, 7>(x, layers, out, b, C, L, inv_c, device, st);
    if (S == 8 && k == 3)
      return launch_fixed<8, 3>(x, layers, out, b, C, L, inv_c, device, st);
    if (S == 32 && k == 7)
      return launch_fixed<32, 7>(x, layers, out, b, C, L, inv_c, device, st);
  }
  const size_t smem = 2 * static_cast<size_t>(S) * S * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  err = set_smem(diag_maps_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pixels = S * S;
  const int threads = pixels < kMaxThreads ? (pixels + 31) / 32 * 32
                                           : kMaxThreads;
  diag_maps_kernel<<<b, threads, smem, st>>>(x, layers, out, b, C, S, k, L,
                                             inv_c);
  return static_cast<int>(cudaGetLastError());
}

const char* cnn_gp_diag_maps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
