// Batched lower Cholesky factor on Hopper (sm_90a): the C entry points.
//
// Replaces the Pallas TPU kernel `ppca_rs_tpu/ops/kernels.py:spd_chol` (the
// "chol" variant of `_make_kernel`), the backend of
// `InferredMasked.posterior_sampler`.  For every sample n it factors the SPD
// matrix M[n] (k x k) as L L^T and writes L whole: its lower triangle and
// explicit zeros above the diagonal.  Only the lower triangle of M is read,
// as torch.linalg.cholesky reads it.
//
// Layout is batch-major: M and L (B, k, k), contiguous.
//
// What bounds it on this card: per sample ~k^3/3 FLOPs (k^3/6 FMAs) against
// ~6 k^2 bytes of device traffic in float32 (M's lower triangle in, L out
// whole) -- at k=64 about 87 KFLOP per 25 KB, below the card's
// compute-to-bandwidth balance up to k ~ 250 -- and the factorization is a
// chain of dependent column steps, whose latency the designs work on.
//
// Two designs, chosen by k in the entry points below:
// * k <= chol_tile_max_k<T>() (128): the tile design of the E-step,
//   spd_estep_tile.cuh (built in spd_estep_tile_f32.cu and
//   spd_estep_tile_f64.cu), as its sixth variant, kChol = 5: up to k=16 a
//   sample in a segment of a warp's registers, swept column by column with
//   shuffles; above, one CTA a sample with M's lower triangle in shared
//   memory (staged by cp.async), 16-column pivot blocks factored in one
//   warp's registers and the panel L21 = U L11^{-T} and the trailing
//   update on the tensor cores (3xTF32 in float, FP64 MMA in double), each
//   block of rows of L written out as soon as it is final.
// * any larger k: the panel design of spd_panel.cuh (want 5), a right-looking
//   blocked Cholesky worked in L itself: one CTA a sample, one warp factors
//   each NB x NB pivot block in registers, the panel below it, staged once
//   in shared memory, is solved against it and the trailing triangle
//   updated from it on the tensor cores; the only limit on k is device
//   memory.
// Each header states its design in full.  A sample whose M is not positive
// definite gets a factor that is NaN on and below the diagonal, alone.
// The C entry points return cudaGetLastError() and allocate nothing; they
// launch on the stream they are given.

#include <cuda_runtime.h>

#include "spd_common.cuh"

extern "C" {
// spd_estep_tile_f32.cu, spd_estep_tile_f64.cu: the tile design (want 5 is spd_chol).
int ppca_spd_estep_tile_f32(int want, const void* sigma, long long sigma_stride, const void* G,
                            const void* b, const void* rnorm, const void* d_obs, void* s,
                            void* m, void* llk, void* sq, long long B, int k, int layout,
                            void* stream);
int ppca_spd_estep_tile_f64(int want, const void* sigma, long long sigma_stride, const void* G,
                            const void* b, const void* rnorm, const void* d_obs, void* s,
                            void* m, void* llk, void* sq, long long B, int k, int layout,
                            void* stream);
// spd_panel_f32.cu, spd_panel_f64.cu: the panel design.
int ppca_spd_panel_f32(int want, int device, const void* sigma, long long sigma_stride,
                       const void* G, const void* b, const void* rnorm, const void* d_obs,
                       void* s, void* m, void* llk, void* sq, void* work, long long B, int k,
                       void* stream);
int ppca_spd_panel_f64(int want, int device, const void* sigma, long long sigma_stride,
                       const void* G, const void* b, const void* rnorm, const void* d_obs,
                       void* s, void* m, void* llk, void* sq, void* work, long long B, int k,
                       void* stream);
}

namespace {

using namespace ppca;

constexpr int kChol = 5;  // the tile's and the panel design's want for spd_chol

template <typename T>
int dispatch(int device, const void* M, void* L, long long B, int k, void* stream) {
  cudaError_t err = ensure_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (k < 1 || B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool f32 = sizeof(T) == 4;
  if (k <= chol_tile_max_k<T>()) {
    return f32 ? ppca_spd_estep_tile_f32(kChol, nullptr, 0, M, nullptr, nullptr, nullptr, nullptr,
                                         L, nullptr, nullptr, B, k, 0, stream)
               : ppca_spd_estep_tile_f64(kChol, nullptr, 0, M, nullptr, nullptr, nullptr, nullptr,
                                         L, nullptr, nullptr, B, k, 0, stream);
  }
  return f32 ? ppca_spd_panel_f32(kChol, device, nullptr, 0, M, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, nullptr, L, B, k, stream)
             : ppca_spd_panel_f64(kChol, device, nullptr, 0, M, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, nullptr, L, B, k, stream);
}

}  // namespace

extern "C" {

// L (B,k,k) = lower Cholesky factor of each M (B,k,k).  Returns a
// cudaError_t (0 on success); spd_estep_error_string names it.
int spd_chol_f32(int device, const void* M, void* L, long long B, int k, void* stream) {
  return dispatch<float>(device, M, L, B, k, stream);
}

int spd_chol_f64(int device, const void* M, void* L, long long B, int k, void* stream) {
  return dispatch<double>(device, M, L, B, k, stream);
}

// Largest k that the tile design serves for elements of `itemsize` bytes
// (4 or 8); larger k take the panel design.
int spd_chol_tile_max_k(int itemsize) {
  return itemsize == 4 ? chol_tile_max_k<float>() : itemsize == 8 ? chol_tile_max_k<double>() : 0;
}

}  // extern "C"
