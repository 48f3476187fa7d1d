// Pieces shared by the package's per-sample SPD kernels (spd_estep.cu,
// spd_estep_tile.cuh, spd_chol.cu, spd_chol_tile.cuh): the
// one-block-per-sample thread-block shape, the device limits, the tile
// limit and the type-generic math helpers.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace ppca {

// One thread block per sample, 256 threads as a 32 x 8 tile: x runs along a
// matrix row (contiguous in shared memory), y over rows.
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kWarps = kThreads / 32;

// Shared memory one block may use on Hopper (227 KB), and the devices a
// process may drive, for the once-per-device kernel attributes.
constexpr int kSmemLimitBytes = 232448;
constexpr int kMaxDevices = 64;

// spd_estep and spd_chol serve k up to these limits with the register-tile
// designs (spd_estep_tile.cuh, spd_chol_tile.cuh: tiles of 8 to 128) and
// larger k with one block per sample (spd_estep.cu, spd_chol.cu); the entry
// points spd_estep_tile_max_k and spd_chol_tile_max_k report them to the
// wrapper.  The float64 E-step stays on the block design above k=64: its
// KP=128 tile spills (ptxas for sm_90a: 255 registers and 216 bytes of
// spill stores in fullt, infer and full).
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

// Raises the dynamic shared-memory allowance of the kernel Kern to the whole
// 227 KB, once per kernel and device rather than on every launch.  `device`
// has passed ensure_device.
template <auto Kern>
cudaError_t allow_smem(int device) {
  static bool allowed[kMaxDevices] = {};
  if (allowed[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimitBytes);
  if (err == cudaSuccess) allowed[device] = true;
  return err;
}

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float nan_like(float) { return CUDART_NAN_F; }
__device__ __forceinline__ double nan_like(double) { return CUDART_NAN; }

}  // namespace ppca
