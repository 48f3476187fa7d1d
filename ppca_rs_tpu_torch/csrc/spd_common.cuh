// Pieces shared by the package's per-sample SPD kernels (spd_estep.cu,
// spd_chol.cu): the thread-block shape and the type-generic math helpers.
#pragma once

#include <cuda_runtime.h>

namespace ppca {

// One thread block per sample, 256 threads as a 32 x 8 tile: x runs along a
// matrix row (contiguous in shared memory), y over rows.
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

}  // namespace ppca
