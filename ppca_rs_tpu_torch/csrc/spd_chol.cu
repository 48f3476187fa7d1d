// Batched lower Cholesky factor on Hopper (sm_90a).
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
// whole) -- at k=64 about 87 KFLOP per 25 KB, far
// below the card's compute-to-bandwidth balance -- but the factorization is
// a chain of k dependent column steps, so the kernel is bound by the
// latency of that chain, as spd_estep.cu is.
//
// Two designs, chosen by k in the entry points below:
// * k <= chol_tile_max_k<T>() (128): the register-tile design,
//   spd_chol_tile.cuh (built in spd_chol_tile_f32.cu and
//   spd_chol_tile_f64.cu), on the lane grid of the E-step's tile: the
//   matrix in registers, one warp-level sync (a named barrier for a
//   sample of whole warps) per column, several samples a block below 128
//   lanes a sample.  Its header states the design in full.
// * larger k, up to the shared-memory ceiling: this file's
//   body, kept simple and exact:
//   - one thread block per sample, the 32 x 8 tile of spd_common.cuh; the
//     working matrix lives in shared memory, so reading M and writing L are
//     the only device-memory traffic;
//   - A = M^T is factored in place by the right-looking, unscaled-column
//     step of spd_estep.cu on the upper triangle (step j subtracts
//     A[j][i] A[j][l] / d_j from rows i > j): ONE __syncthreads per column;
//   - A's rows have an odd stride (ld = k | 1), so the transposed load of M
//     and the transposed store of L touch 32 distinct banks per warp;
//   - a sample whose M is not positive definite meets a pivot <= 0, whose
//     reciprocal square root is NaN or infinite, so its factor is non-finite;
//     one block per sample leaves its neighbours untouched, and nothing is
//     padded.
//
// The block design's shared memory is (k * ld + k) elements; the wrapper
// refuses k above what fits in the 227 KB a block may use.  The C entry
// points return cudaGetLastError() and allocate nothing; they launch on
// the stream they are given.

#include <cuda_runtime.h>

#include "spd_common.cuh"

extern "C" {
// spd_chol_tile_f32.cu, spd_chol_tile_f64.cu: the register-tile design.
int ppca_spd_chol_tile_f32(const void* M, void* L, long long B, int k, void* stream);
int ppca_spd_chol_tile_f64(const void* M, void* L, long long B, int k, void* stream);
}

namespace {

using namespace ppca;

template <typename T>
__global__ void __launch_bounds__(kThreads)
spd_chol_kernel(const T* __restrict__ M, T* __restrict__ L, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = k | 1;
  T* A = reinterpret_cast<T*>(smem_raw);  // A = M^T, factored in place (upper)
  T* piv = A + k * ld;                     // 1 / sqrt(pivot)

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const size_t n = blockIdx.x;
  const int kk = k * k;

  // A[c][r] = M[r][c]: the lower triangle of M fills the upper one of A.
  const T* Mn = M + n * static_cast<size_t>(kk);
  for (int i = tid; i < kk; i += kThreads) {
    const int r = i / k;
    A[(i - r * k) * ld + r] = Mn[i];
  }
  __syncthreads();

  // Column j: pivot d = A[j][j]; U[j][l] = A[j][l] / sqrt(d).  Reads row j,
  // writes rows > j only, so one barrier per column suffices.
  for (int j = 0; j < k; ++j) {
    const T inv_d = T(1) / A[j * ld + j];
    for (int i = j + 1 + ty; i < k; i += kThreadsY) {
      const T u = A[j * ld + i] * inv_d;
      for (int l = i + tx; l < k; l += kThreadsX) A[i * ld + l] -= u * A[j * ld + l];
    }
    __syncthreads();
  }
  for (int j = tid; j < k; j += kThreads) piv[j] = rsqrt_t(A[j * ld + j]);
  __syncthreads();

  // L[i][j] = U[j][i] = A[j][i] / sqrt(d_j) on and below the diagonal, 0
  // above it: every element of L is written.
  T* Ln = L + n * static_cast<size_t>(kk);
  for (int e = tid; e < kk; e += kThreads) {
    const int i = e / k;
    const int j = e - i * k;
    Ln[e] = j <= i ? A[j * ld + i] * piv[j] : T(0);
  }
}

template <typename T>
int dispatch(int device, const void* M, void* L, long long B, int k, void* stream) {
  cudaError_t err = ensure_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (k < 1 || B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= chol_tile_max_k<T>()) {
    return sizeof(T) == 4 ? ppca_spd_chol_tile_f32(M, L, B, k, stream)
                          : ppca_spd_chol_tile_f64(M, L, B, k, stream);
  }
  const size_t smem = (static_cast<size_t>(k) * (k | 1) + k) * sizeof(T);
  if (smem > static_cast<size_t>(kSmemLimitBytes)) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem<&spd_chol_kernel<T>>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  spd_chol_kernel<T><<<static_cast<unsigned>(B), dim3(kThreadsX, kThreadsY), smem,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(M),
                                                            static_cast<T*>(L), k);
  return static_cast<int>(cudaGetLastError());
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

// Largest k that the register-tile design serves for elements of
// `itemsize` bytes (4 or 8); larger k take one block per sample.
int spd_chol_tile_max_k(int itemsize) {
  return itemsize == 4 ? chol_tile_max_k<float>() : itemsize == 8 ? chol_tile_max_k<double>() : 0;
}

}  // extern "C"
