// Pieces shared by the package's per-sample SPD kernels (spd_estep.cu,
// spd_estep_tile.cuh, spd_chol.cu, spd_panel.cuh): the device limits, the
// tile limits and the type-generic math helpers.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace ppca {

// The devices a process may drive, for the once-per-device lookups.
constexpr int kMaxDevices = 64;

// spd_estep and spd_chol serve k up to these limits with the tile design
// (spd_estep_tile.cuh: padded sizes of 8 to 128; spd_chol is its variant
// kChol) and larger k with the panel design (spd_panel.cuh); the entry
// points spd_estep_tile_max_k and spd_chol_tile_max_k report them to the
// wrapper.
template <typename T>
constexpr int estep_tile_max_k() { return sizeof(T) == 4 ? 128 : 64; }
template <typename T>
constexpr int chol_tile_max_k() { return 128; }

// Makes `device` current for the launch that follows, switching only when
// another device is current.
inline cudaError_t ensure_device(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float nan_like(float) { return CUDART_NAN_F; }
__device__ __forceinline__ double nan_like(double) { return CUDART_NAN; }

}  // namespace ppca
