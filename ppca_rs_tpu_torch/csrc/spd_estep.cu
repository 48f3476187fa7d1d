// Batched SPD E-step for masked PPCA on Hopper (sm_90a).
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
// SM and Sigma are written as the full symmetric matrix (a superset of the
// TPU "fullt" contract, whose upper wedge was garbage).  On the TPU, full
// and fullt differ only in that fullt skips the upper wedge of SM; written
// whole, the two are one body, kept under two codes so that each caller's
// launches are counted apart (full: the pattern tables, with b = 0, rnorm = 0,
// so SM = Sigma and llk is the pattern's mask term).
//
// Layout is batch-major: G (B,k,k), b and s (B,k), SM (B,k,k), rnorm, d_obs,
// llk, sq (B,), all contiguous; sigma is one device scalar (stride 0) or one
// per sample (stride 1), on the device, so the caller never synchronises to
// read it.
//
// What bounds it on this card: one fullt launch must read G's lower
// triangle and write SM's, all that its consumer reads (~4 k(k+1) bytes per
// sample in float32: 141 MB at B=8192, k=64, 42 us at 3.35 TB/s; both
// designs write SM whole), and do ~k^3 floating-point operations (34 us at
// 67 TFLOP/s in float32), so device memory sets the floor.  What held the
// first design (one 256-thread block per sample, M and W = L^{-1} in shared
// memory) at ~47x that floor was the column
// chain: one __syncthreads per column with little work between two
// barriers, and two or three shared-memory accesses per FMA.
//
// Two designs, chosen by k in the entry points below:
// * k <= estep_tile_max_k<T>() (128 in float, 64 in double): the
//   register-tile design, spd_estep_tile.cuh (built in
//   spd_estep_tile_f32.cu and spd_estep_tile_f64.cu).  A sample belongs to
//   4 to 128 lanes, several samples to a block below 128 lanes; the k x k
//   matrix is held in registers and inverted in place by k symmetric
//   sweeps (Gauss-Jordan: factor, inverse and L^T L in one pass over one
//   buffer); each pivot
//   column is broadcast through shared memory with one warp-level sync (a
//   named barrier for a sample of whole warps) per step; G, SM and Sigma
//   move in 16-byte accesses.  Its header states the design in full.
// * larger k, up to the shared-memory ceiling: the first design, this
//   file's body.  One block per sample, 256 threads as a 32 x 8 tile, M and
//   W in shared memory; a right-looking Cholesky on the upper triangle with
//   the columns left unscaled (step j subtracts A[j][i] A[j][l] / d_j), the
//   forward substitution of b and the rows of W riding in the same step,
//   which reads only row j and writes only rows > j: one __syncthreads per
//   column.  Shared memory is (n_buf k^2 + 3k + 32) elements, n_buf = 2 for
//   fullt/full/infer and 1 for states/llk; the wrapper refuses k above what
//   fits in the 227 KB a block may use.
//
// In both, a singular or indefinite sample (e.g. an empty dimension at
// lambda = 0 in the M-step row solve) yields non-finite values for that
// sample only: nothing reduces across samples.  The C entry points return
// cudaGetLastError() and allocate nothing; they launch on the stream they
// are given.

#include <cuda_runtime.h>

#include "spd_common.cuh"

extern "C" {
// spd_estep_tile_f32.cu, spd_estep_tile_f64.cu: the register-tile design.
int ppca_spd_estep_tile_f32(int want, const void* sigma, long long sigma_stride, const void* G,
                            const void* b, const void* rnorm, const void* d_obs, void* s,
                            void* m, void* llk, void* sq, long long B, int k, void* stream);
int ppca_spd_estep_tile_f64(int want, const void* sigma, long long sigma_stride, const void* G,
                            const void* b, const void* rnorm, const void* d_obs, void* s,
                            void* m, void* llk, void* sq, long long B, int k, void* stream);
}

namespace {

using namespace ppca;

constexpr int kFullT = 0;
constexpr int kStates = 1;
constexpr int kLlk = 2;
constexpr int kInfer = 3;
constexpr int kFull = 4;

constexpr int kReduceSlots = 32;

constexpr double kLn2Pi = 1.8378770664093453;

// Sum of one value per thread over the block; every thread gets the total.
template <typename T>
__device__ T block_sum(T v, T* red, int tid) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  const T total = red[kWarps];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

__host__ __device__ constexpr bool wants_second_moment(int want) { return want == kFullT || want == kFull; }
__host__ __device__ constexpr bool wants_inverse(int want) {
  return wants_second_moment(want) || want == kInfer;
}

template <typename T, int WANT>
__global__ void __launch_bounds__(kThreads)
spd_estep_kernel(const T* __restrict__ sigma, long long sigma_stride, const T* __restrict__ G,
                 const T* __restrict__ b, const T* __restrict__ rnorm,
                 const T* __restrict__ d_obs, T* __restrict__ s_out,
                 T* __restrict__ m_out, T* __restrict__ llk_out,
                 T* __restrict__ sq_out, int k) {
  constexpr bool kInverse = wants_inverse(WANT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);  // M, factored in place (upper)
  T* W = A + k * k;                        // rows of L^{-1} (fullt/infer)
  T* v = kInverse ? W + k * k : A + k * k; // b -> L^{-1} b
  T* piv = v + k;                          // 1 / sqrt(pivot)
  T* s = piv + k;                          // posterior state
  T* red = s + k;                          // reduction slots

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const size_t n = blockIdx.x;
  const int kk = k * k;
  const T sig = sigma[n * sigma_stride];
  const T s2 = sig * sig;

  const T* Gn = G + n * static_cast<size_t>(kk);
  for (int i = tid; i < kk; i += kThreads) {
    const int r = i / k;
    const bool diag = (i - r * k) == r;
    A[i] = Gn[i] + (diag ? s2 : T(0));
    if (kInverse) W[i] = diag ? T(1) : T(0);
  }
  for (int i = tid; i < k; i += kThreads) v[i] = b[n * k + i];
  __syncthreads();

  // Column j: pivot d = A[j][j]; U[j][l] = A[j][l] / sqrt(d).  Reads row j,
  // writes rows > j only, so one barrier per column suffices.
  for (int j = 0; j < k; ++j) {
    const T inv_d = T(1) / A[j * k + j];
    for (int i = j + 1 + ty; i < k; i += kThreadsY) {
      const T u = A[j * k + i] * inv_d;
      for (int l = i + tx; l < k; l += kThreadsX) A[i * k + l] -= u * A[j * k + l];
      if (kInverse) {
        for (int c = tx; c <= j; c += kThreadsX) W[i * k + c] -= u * W[j * k + c];
      }
      if (tx == 0) v[i] -= u * v[j];
    }
    __syncthreads();
  }

  // y = L^{-1} b, log det M and |y|^2.
  T logdet = T(0);
  T quad = T(0);
  for (int j = tid; j < k; j += kThreads) {
    const T d = A[j * k + j];
    const T r = rsqrt_t(d);
    piv[j] = r;
    const T y = v[j] * r;
    v[j] = y;
    logdet += log_t(d);
    quad += y * y;
  }
  logdet = block_sum(logdet, red, tid);
  quad = block_sum(quad, red, tid);  // its barriers also publish piv and v

  if (tid == 0) {
    const T dob = d_obs[n];
    llk_out[n] = T(-0.5) * ((rnorm[n] - quad) / s2 + logdet +
                            log_t(s2) * (dob - T(k)) + T(kLn2Pi) * dob);
  }
  if (WANT == kLlk) return;

  if (kInverse) {
    // W = L^{-1}: scale row j by 1/sqrt(d_j) (entries above the diagonal
    // stayed 0), then s = W^T y.
    for (int i = tid; i < kk; i += kThreads) W[i] *= piv[i / k];
    __syncthreads();
    for (int c = tid; c < k; c += kThreads) {
      T acc = T(0);
      for (int j = c; j < k; ++j) acc += W[j * k + c] * v[j];
      s[c] = acc;
    }
  } else {
    // Back substitution U s = y, right-looking from the last row up:
    // U[i][j] = A[i][j] piv[i] for i < j.
    for (int j = k - 1; j > 0; --j) {
      const T sj = v[j] * piv[j];
      for (int i = tid; i < j; i += kThreads) v[i] -= A[i * k + j] * piv[i] * sj;
      __syncthreads();
    }
    for (int j = tid; j < k; j += kThreads) s[j] = v[j] * piv[j];
  }
  __syncthreads();
  for (int i = tid; i < k; i += kThreads) s_out[n * k + i] = s[i];
  if (WANT == kStates) return;

  // M^{-1} = W^T W: Minv[a][c] = sum_{j >= max(a, c)} W[j][a] W[j][c].
  T* Mn = m_out + n * static_cast<size_t>(kk);
  T tr = T(0);
  for (int a = ty; a < k; a += kThreadsY) {
    for (int c = tx; c < k; c += kThreadsX) {
      T acc = T(0);
      for (int j = a > c ? a : c; j < k; ++j) acc += W[j * k + a] * W[j * k + c];
      if (a == c) tr += acc;
      Mn[a * k + c] = wants_second_moment(WANT) ? s[a] * s[c] + s2 * acc : s2 * acc;
    }
  }
  tr = block_sum(tr, red, tid);
  if (tid == 0) sq_out[n] = s2 * (T(k) - s2 * tr);
}

template <int WANT>
constexpr int n_buffers() { return wants_inverse(WANT) ? 2 : 1; }

template <typename T, int WANT>
int launch(int device, const void* sigma, long long sigma_stride, const void* G,
           const void* b, const void* rnorm, const void* d_obs, void* s, void* m,
           void* llk, void* sq, long long B, int k, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(n_buffers<WANT>()) * k * k + 3 * k + kReduceSlots) * sizeof(T);
  if (smem > static_cast<size_t>(kSmemLimitBytes)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<&spd_estep_kernel<T, WANT>>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  spd_estep_kernel<T, WANT><<<static_cast<unsigned>(B), dim3(kThreadsX, kThreadsY), smem, stream>>>(
      static_cast<const T*>(sigma), sigma_stride, static_cast<const T*>(G),
      static_cast<const T*>(b), static_cast<const T*>(rnorm),
      static_cast<const T*>(d_obs), static_cast<T*>(s), static_cast<T*>(m),
      static_cast<T*>(llk), static_cast<T*>(sq), k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int want, int device, const void* sigma, long long sigma_stride, const void* G,
             const void* b, const void* rnorm, const void* d_obs, void* s,
             void* m, void* llk, void* sq, long long B, int k, void* stream) {
  const cudaError_t err = ensure_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (k < 1 || B > 0x7fffffffLL || (sigma_stride != 0 && sigma_stride != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k <= estep_tile_max_k<T>()) {
    return sizeof(T) == 4 ? ppca_spd_estep_tile_f32(want, sigma, sigma_stride, G, b, rnorm, d_obs,
                                                    s, m, llk, sq, B, k, stream)
                          : ppca_spd_estep_tile_f64(want, sigma, sigma_stride, G, b, rnorm, d_obs,
                                                    s, m, llk, sq, B, k, stream);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (want) {
    case kFullT: return launch<T, kFullT>(device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, st);
    case kStates: return launch<T, kStates>(device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, st);
    case kLlk: return launch<T, kLlk>(device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, st);
    case kInfer: return launch<T, kInfer>(device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, st);
    case kFull: return launch<T, kFull>(device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// want: 0 fullt, 1 states, 2 llk, 3 infer, 4 full.  Unused outputs may be null.
// sigma_stride: 0 for one sigma for the batch, 1 for one per sample.
// Returns a cudaError_t (0 on success).
int spd_estep_f32(int want, int device, const void* sigma, long long sigma_stride,
                  const void* G, const void* b, const void* rnorm, const void* d_obs,
                  void* s, void* m, void* llk, void* sq, long long B, int k, void* stream) {
  return dispatch<float>(want, device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq,
                         B, k, stream);
}

int spd_estep_f64(int want, int device, const void* sigma, long long sigma_stride,
                  const void* G, const void* b, const void* rnorm, const void* d_obs,
                  void* s, void* m, void* llk, void* sq, long long B, int k, void* stream) {
  return dispatch<double>(want, device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq,
                          B, k, stream);
}

// Largest k that the register-tile design serves for elements of
// `itemsize` bytes (4 or 8); larger k take one block per sample.
int spd_estep_tile_max_k(int itemsize) {
  return itemsize == 4 ? estep_tile_max_k<float>() : itemsize == 8 ? estep_tile_max_k<double>() : 0;
}

const char* spd_estep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
