// Host side of the layer kernels' launches (csrc/arccos.cu,
// csrc/boxfilter.cu): the grid of a persistent kernel, which is also the
// largest grid a cooperative launch (one whose blocks wait at a grid-wide
// barrier, fill_factors in csrc/arccos.cuh) takes, and that launch.

#pragma once

#include <cuda_runtime.h>

// The most blocks of `kernel` at `threads` threads and `smem` bytes of
// dynamic shared memory that can be resident on `device` at once, cached
// per kernel, block shape and device.  A kernel that may take more than
// 48 KB of dynamic shared memory passes its largest size as `max_smem`,
// which is set as its attribute first (0: none).
inline int co_resident_blocks(const void* kernel, int threads, int smem,
                              int max_smem, int device, int* blocks) {
  struct Entry {
    const void* kernel;
    int threads;
    int smem;
    int device;
    int blocks;
  };
  static Entry cache[128];
  static int used = 0;
  for (int e = 0; e < used; ++e) {
    const Entry& c = cache[e];
    if (c.kernel == kernel && c.threads == threads && c.smem == smem
        && c.device == device) {
      *blocks = c.blocks;
      return 0;
    }
  }
  cudaError_t err = cudaSuccess;
  if (max_smem > 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = per_sm * sms;
  if (used < 128)
    cache[used++] = Entry{kernel, threads, smem, device, *blocks};
  return 0;
}

// A cooperative launch of `kernel` (its arguments' addresses in `args`),
// every block resident at once, or the card's refusal as an error code:
// never a plain launch in its place, whose grid-wide barrier could wait
// for a block that is not running.
inline int launch_cooperative(const void* kernel, unsigned grid, int threads,
                              void** args, int smem, cudaStream_t st) {
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(threads), args, static_cast<size_t>(smem), st);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
