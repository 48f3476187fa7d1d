// Batched SPD E-step for masked PPCA on Hopper (sm_90a): the C entry points.
//
// Replaces the Pallas TPU kernel `ppca_rs_tpu/ops/kernels.py:_make_kernel`
// as launched by `spd_estep` for want in {fullt, states, llk, infer, full}.
// For every sample n it factors M = sigma^2 I + G[n] (k x k, SPD) and
// returns, by variant:
//
//   llk    : llk = -1/2 [(rnorm - |L^{-1} b|^2)/sigma^2 + log det M
//                        + log(sigma^2) (d_obs - k) + d_obs log 2 pi]
//   states : s = M^{-1} b, llk
//   infer  : s, Sigma = sigma^2 M^{-1}, llk, sq = sigma^2 (k - sigma^2 tr M^{-1})
//   fullt  : s, SM = s s^T + sigma^2 M^{-1}, llk, sq
//   full   : the same as fullt
//
// fullt writes SM on and below the diagonal only, as the TPU kernel's
// "fullt" did (its upper wedge was garbage): every element above the diagonal
// of the SM tensor is left as it was, and its consumers (the M-steps of
// masked_linalg and mix_fused) rebuild S from the lower triangle.  full (the
// pattern tables, with b = 0, rnorm = 0, so SM = Sigma and llk is the
// pattern's mask term) and infer write their matrix whole.
//
// Layout is batch-major: G (B,k,k), b and s (B,k), SM (B,k,k), rnorm, d_obs,
// llk, sq (B,), all contiguous; sigma is one device scalar (stride 0) or one
// per sample (stride 1), on the device, so the caller never synchronises to
// read it.  With `layout` 1 (slabs; k a multiple of 8 above 16 and within
// the tile's limit) G is (B, 32 m (m+1)) for m = k/8, its rows in blocks of
// 8, row r of block j = r/8 holding its first 8 (j+1) entries (the lower
// triangle and the upper part of the diagonal block; spd_estep_tile.cuh),
// and fullt's SM comes back in the same layout, written whole, zeros above
// the diagonal: the port of the TPU kernel's wedge-slab input
// (`ppca_rs_tpu/ops/kernels.py:g_slabs`), whose callers build only the
// Gram's wedge.  The panel design takes square G only and refuses slabs.
//
// What bounds it on this card: one fullt launch must read G's lower
// triangle and write SM's, all that its consumer reads (~4 k(k+1) bytes per
// sample in float32: 141 MB at B=8192, k=64, 42 us at 3.35 TB/s), and do
// ~k^3 floating-point operations (34 us at 67 TFLOP/s in float32), so
// device memory sets the floor at small k and the operations above
// k ~ 120.
//
// Two designs, chosen by k in the entry points below:
// * k <= estep_tile_max_k<T>() (128 in float, 64 in double): the tile
//   design, spd_estep_tile.cuh (built in spd_estep_tile_f32.cu and
//   spd_estep_tile_f64.cu): up to k=16 a sample in one segment of a warp's
//   registers, swept with shuffles; above, one CTA a sample with its k x k
//   matrix in shared memory, 16-column pivot blocks inverted in one warp's
//   registers and the panel and trailing products on the tensor cores
//   (3xTF32 in float, FP64 MMA in double), G staged by cp.async.
// * any larger k: the panel design, spd_panel.cuh (built in
//   spd_panel_f32.cu and spd_panel_f64.cu): one CTA a sample, the working
//   matrix in device memory, NB columns a step (a warp factors the pivot
//   block, the step's panel is staged once in shared memory, and the panel
//   and trailing products run on the tensor cores: 3xTF32 in float, FP64
//   MMA in double).  llk and states take a (B, k+1, k) scratch for it,
//   `work`.
// Each header states its design in full.
//
// In both, a singular or indefinite sample (e.g. an empty dimension at
// lambda = 0 in the M-step row solve) yields non-finite values for that
// sample only: nothing reduces across samples.  The C entry points return
// cudaGetLastError() and allocate nothing; they launch on the stream they
// are given.

#include <cuda_runtime.h>

#include "spd_common.cuh"

extern "C" {
// spd_estep_tile_f32.cu, spd_estep_tile_f64.cu: the tile design.
int ppca_spd_estep_tile_occupancy_f32(int k, int chol, int* ctas_per_sm, int* warps, int* samples);
int ppca_spd_estep_tile_occupancy_f64(int k, int chol, int* ctas_per_sm, int* warps, int* samples);
int ppca_spd_estep_tile_f32(int want, const void* sigma, long long sigma_stride, const void* G,
                            const void* b, const void* rnorm, const void* d_obs, void* s,
                            void* m, void* llk, void* sq, long long B, int k, int layout,
                            void* stream);
int ppca_spd_estep_tile_f64(int want, const void* sigma, long long sigma_stride, const void* G,
                            const void* b, const void* rnorm, const void* d_obs, void* s,
                            void* m, void* llk, void* sq, long long B, int k, int layout,
                            void* stream);
// spd_panel_f32.cu, spd_panel_f64.cu: the panel design (want 5 is spd_chol).
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

template <typename T>
int dispatch(int want, int device, const void* sigma, long long sigma_stride, const void* G,
             const void* b, const void* rnorm, const void* d_obs, void* s, void* m, void* llk,
             void* sq, void* work, long long B, int k, int layout, void* stream) {
  const cudaError_t err = ensure_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (k < 1 || want < 0 || want > 4 || B > 0x7fffffffLL ||
      (sigma_stride != 0 && sigma_stride != 1) || (layout != 0 && layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool f32 = sizeof(T) == 4;
  if (k <= estep_tile_max_k<T>()) {
    return f32 ? ppca_spd_estep_tile_f32(want, sigma, sigma_stride, G, b, rnorm, d_obs, s, m,
                                         llk, sq, B, k, layout, stream)
               : ppca_spd_estep_tile_f64(want, sigma, sigma_stride, G, b, rnorm, d_obs, s, m,
                                         llk, sq, B, k, layout, stream);
  }
  // the panel design: square G only
  if (layout != 0) return static_cast<int>(cudaErrorNotSupported);
  return f32 ? ppca_spd_panel_f32(want, device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m,
                                  llk, sq, work, B, k, stream)
             : ppca_spd_panel_f64(want, device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m,
                                  llk, sq, work, B, k, stream);
}

}  // namespace

extern "C" {

// want: 0 fullt, 1 states, 2 llk, 3 infer, 4 full.  Unused outputs may be
// null; `work` is the panel design's (B, k+1, k) scratch for llk and states
// above the tile limit, and null otherwise.  sigma_stride: 0 for one sigma
// for the batch, 1 for one per sample.  layout: 0 square G, 1 slabs (the
// tile's blocked body alone: k a multiple of 8, 16 < k <= the tile limit;
// elsewhere cudaErrorInvalidValue, and the panel design's k
// cudaErrorNotSupported).  Returns a cudaError_t (0 on success).
int spd_estep_f32(int want, int device, const void* sigma, long long sigma_stride,
                  const void* G, const void* b, const void* rnorm, const void* d_obs,
                  void* s, void* m, void* llk, void* sq, void* work, long long B, int k,
                  int layout, void* stream) {
  return dispatch<float>(want, device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq,
                         work, B, k, layout, stream);
}

int spd_estep_f64(int want, int device, const void* sigma, long long sigma_stride,
                  const void* G, const void* b, const void* rnorm, const void* d_obs,
                  void* s, void* m, void* llk, void* sq, void* work, long long B, int k,
                  int layout, void* stream) {
  return dispatch<double>(want, device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq,
                          work, B, k, layout, stream);
}

// Largest k that the tile design serves for elements of
// `itemsize` bytes (4 or 8); larger k take the panel design.
int spd_estep_tile_max_k(int itemsize) {
  return itemsize == 4 ? estep_tile_max_k<float>() : itemsize == 8 ? estep_tile_max_k<double>() : 0;
}

// The tile design's residency at state size k (1 <= k <= the tile limit) for
// elements of `itemsize` bytes on `device`, for the E-step (chol 0; its
// fullt instantiation) or for spd_chol (chol 1): CTAs a multiprocessor
// holds, warps a CTA and samples a CTA works on at once.
int spd_estep_tile_occupancy(int itemsize, int device, int k, int chol, int* ctas_per_sm,
                             int* warps, int* samples) {
  const cudaError_t err = ensure_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (itemsize == 4) return ppca_spd_estep_tile_occupancy_f32(k, chol, ctas_per_sm, warps, samples);
  if (itemsize == 8) return ppca_spd_estep_tile_occupancy_f64(k, chol, ctas_per_sm, warps, samples);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* spd_estep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
