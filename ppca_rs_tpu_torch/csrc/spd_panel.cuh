// Panel design of the batched SPD E-step and Cholesky factor (sm_90a), for
// every k above the register tiles' limits (estep_tile_max_k<T>(),
// chol_tile_max_k<T>()), with no upper limit but device memory.
//
// Replaces, with the entry points of spd_estep.cu and spd_chol.cu, the
// Pallas TPU kernel `ppca_rs_tpu/ops/kernels.py:_make_kernel` as launched by
// `spd_estep` (fullt, states, llk, infer, full) and by `spd_chol` (chol) at
// large k, and with it the JAX package's Schur-complement recursion
// `ppca_rs_tpu/ops/block_spd.py`, which exists because that kernel has a
// VMEM ceiling.  Outputs, layout and contract are the ones spd_estep.cu and
// spd_chol.cu state.
//
// What bounds it on this card: a sample does ~k^3/6 FMAs for the factor
// (chol, llk, states) and ~k^3/2 for the inverse (fullt, full, infer), and
// moves ~2 k^2 bytes in float32 for llk/states (G's lower triangle in) and
// ~6 k^2 for the others (SM, Sigma or L written whole); at the published
// peaks (3.35 TB/s, 67 TFLOP/s) the two meet near k ~ 120 for the E-step
// variants and k ~ 360 for chol, so in float32 operations bound every
// E-step variant the design serves, and bytes bound chol below k ~ 360.
// What the design does about it: the k^3 work is a register-blocked SIMT
// product over staged operand tiles, and the serial chain is one step per
// NB columns instead of one per column.
//
// The design:
// * One CTA of 256 threads serves one sample at a time; a persistent grid
//   of kCtasPerSm CTAs a multiprocessor walks the batch: 2, the occupancy
//   that the launch bounds fix (128 registers a thread).  Cutting the
//   grid so that the samples in flight keep their lower triangles in the
//   L2 cache (one CTA a multiprocessor at k >= 384 in float32) made every
//   variant 1.3-1.5x slower on an H100 at k=256-512: the steps' latency
//   (warp 0 alone factors the pivot block, barriers) needs the second CTA
//   more than the working matrix needs the L2.
// * The working matrix lives in device memory, row-major with leading
//   dimension k, lower triangle only: in the variant's own k x k output
//   where there is one (SM for fullt/full, Sigma for infer, L for chol),
//   else in a (B, k+1, k) scratch the wrapper allocates (llk, states; its
//   last row holds the right-hand side).  The kernel allocates nothing.
// * Panel steps of NB columns (32 in float, 16 in double), the last one
//   ragged.  Step J, pivot block S = A[J][J]:
//   (a) one warp factors S = L11 L11^T in registers (lane r holds row r:
//       the column step of spd_chol_tile.cuh with shuffles) and inverts
//       L11 into shared memory (lane c holds column c); log det S adds to
//       log det M; the right-hand side's block x_J becomes z = L11^{-1} x_J
//       (|z|^2 adds to b^T M^{-1} b); for the inverse variants the whole
//       CTA then forms P = S^{-1} = L11^{-T} L11^{-1};
//   (b) the active rows of the panel, 64 at a time staged through shared
//       memory (4 threads a row), become V_i = U_i L11^{-T}, written back
//       in place, and x_i -= V_i . z;
//   (c) the active lower triangle takes A[i][l] -= V_i . V_l as a
//       register-blocked SIMT product: 64 x 64 output tiles, 4 x 4 outputs a
//       thread, both operand blocks staged through shared memory (27 KB in
//       all, several CTAs a multiprocessor) and read with 16-byte loads;
//   (d) the inverse variants then write A[i][J] = V_i L11^{-1} = U_i P and
//       A[J][J] = -P.
//   The factor variants (chol, llk, states) keep the rows below block J
//   active: that is the right-looking blocked Cholesky, and block column J
//   keeps L.  The inverse variants keep every row but block J's active:
//   that is the blocked symmetric Gauss-Jordan sweep (the register tile's
//   algorithm, NB columns at a time), which leaves -M^{-1} in the lower
//   triangle and s = M^{-1} b in the right-hand side, in k^3/2 FMAs, the
//   cost of potrf + trtri + lauum.  Rows above block J are stored as
//   columns (A[i][J] = A[J][i] for i < J), and are staged transposed.
// * Per step: one block barrier after (a), three per 64 panel rows in (b)
//   and (d), two per 64 x 64 output tile in (c).
// * Outputs: states back-substitutes L^T s = y by blocks; fullt/full/infer
//   write SM = s s^T + sigma^2 M^{-1} (or Sigma) whole, each 32 x 32 tile
//   of the lower triangle and its transpose through shared memory so that
//   both stores are coalesced; chol writes zeros above the diagonal.
// * A pivot <= 0 or NaN (M not positive definite) sets a flag, and every
//   output element of that sample is written NaN (chol: on and below the
//   diagonal).  Nothing reduces across samples.
// * Offsets are size_t; k and the batch have no limit but memory.

#pragma once

#include <cuda_runtime.h>

#include "spd_common.cuh"

namespace ppca {
namespace panel {

constexpr int kFullT = 0;
constexpr int kStates = 1;
constexpr int kLlk = 2;
constexpr int kInfer = 3;
constexpr int kFull = 4;
constexpr int kChol = 5;  // spd_chol: M in, L out

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 2;  // the launch bounds' minimum, and the grid's CTAs a multiprocessor
constexpr double kLn2Pi = 1.8378770664093453;

template <typename T>
struct Shape {
  static constexpr int NB = sizeof(T) == 4 ? 32 : 16;  // panel width
  static constexpr int MT = 64;                       // output tile of (c)
  static constexpr int V = 16 / sizeof(T);            // elements of a 16-byte load
  static constexpr int LDP = NB + V;                  // staged row stride, 16-byte aligned
  static constexpr int OT = 32;                       // output tile of the final write
};

template <typename T>
struct alignas(16) Smem {
  T a[Shape<T>::MT][Shape<T>::LDP];  // row operand of (c); scratch elsewhere
  T b[Shape<T>::MT][Shape<T>::LDP];  // column operand of (c)
  T l[Shape<T>::NB][Shape<T>::NB + 1];     // L11
  T linv[Shape<T>::NB][Shape<T>::NB + 1];  // L11^{-1}
  T dinv[Shape<T>::NB];                     // 1 / L11[c][c]
  T z[Shape<T>::NB];
  T red[kWarps + 1];
  int bad;
};

__host__ __device__ constexpr bool is_inverse(int want) {
  return want == kFullT || want == kFull || want == kInfer;
}

// Sum over the block; every thread gets the total.
template <typename T>
__device__ T block_sum(T v, Smem<T>& s) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) s.red[warp] = v;
  __syncthreads();
  T total = T(0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s.red[w];
  __syncthreads();  // red is reused
  return total;
}

// The active rows of step J, in compressed order: the factor variants take
// the rows below block J, the inverse variants every row but block J's.
struct Active {
  int J0, nb, m, k;
  bool inverse;
  __device__ int real(int ci) const { return inverse ? (ci < J0 ? ci : ci + nb) : J0 + nb + ci; }
  // element t of row i's panel entry U_i = A[i][J0 + t], stored at
  // (i, J0 + t) below block J and at (J0 + t, i) above it
  __device__ size_t at(int i, int t) const {
    return i < J0 ? static_cast<size_t>(J0 + t) * k + i : static_cast<size_t>(i) * k + J0 + t;
  }
};

// (a): warp 0 factors the pivot block, inverts L11 into s.linv and turns
// x_J into z = L11^{-1} x_J (s.z); x_J becomes L11^{-T} z = P x_J (inverse
// variants) or z (factor variants).  P itself is formed by the whole CTA
// (pivot_inverse).
template <typename T, int WANT>
__device__ void pivot_block(T* W, T* x, const Active& act, Smem<T>& s, T& logdet, T& quad) {
  constexpr int NB = Shape<T>::NB;
  constexpr bool kInverse = is_inverse(WANT);
  const int r = threadIdx.x & 31;
  const int k = act.k, J0 = act.J0, nb = act.nb;
  const bool row_in = r < nb;

  // row r of S (lower), padding rows of the identity
  T a[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c)
    a[c] = row_in ? (c <= r ? W[static_cast<size_t>(J0 + r) * k + J0 + c] : T(0))
                  : (c == r ? T(1) : T(0));
  bool ok = true;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const T d = __shfl_sync(0xffffffffu, a[c], c);
    ok = ok && d > T(0);
    logdet += c < nb ? log_t(d) : T(0);
    const T rs = rsqrt_t(d);
    if (r == c) s.dinv[c] = rs;
    const T u = r >= c ? a[c] * rs : T(0);
    a[c] = u;
#pragma unroll
    for (int l = c + 1; l < NB; ++l) a[l] = fma(-u, __shfl_sync(0xffffffffu, u, l), a[l]);
  }
  if (!ok && r == 0) s.bad = 1;
  if (r < NB) {
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const T v = c <= r ? a[c] : T(0);
      s.l[r][c] = v;
      if (!kInverse && row_in && c <= r) W[static_cast<size_t>(J0 + r) * k + J0 + c] = v;
    }
  }
  __syncwarp();

  // lane cl: column cl of L11^{-1}, by right-looking forward substitution
  // on e_cl
  const int cl = r < NB ? r : NB - 1;
  T xc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) xc[i] = i == cl ? T(1) : T(0);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    xc[i] *= s.dinv[i];
#pragma unroll
    for (int l = i + 1; l < NB; ++l) xc[l] = fma(-s.l[l][i], xc[i], xc[l]);
  }
  if (r < NB) {
#pragma unroll
    for (int i = 0; i < NB; ++i) s.linv[i][r] = xc[i];
  }
  __syncwarp();

  // z = L11^{-1} x_J (lane r: z_r); chol has no right-hand side
  if (WANT == kChol) return;
  const T xj = row_in ? x[J0 + r] : T(0);
  T z = T(0);
#pragma unroll
  for (int c = 0; c < NB; ++c) z = fma(s.linv[cl][c], __shfl_sync(0xffffffffu, xj, c), z);
  if (r >= NB) z = T(0);
  T zz = z * z;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) zz += __shfl_xor_sync(0xffffffffu, zz, off);
  quad += zz;
  if (r < NB) s.z[r] = z;
  if (kInverse) {
    // x_J = L11^{-T} z: lane cl holds column cl of L11^{-1}
    T px = T(0);
#pragma unroll
    for (int i = 0; i < NB; ++i) px = fma(xc[i], __shfl_sync(0xffffffffu, z, i), px);
    if (row_in) x[J0 + r] = px;
  } else if (row_in) {
    x[J0 + r] = z;
  }
}

// The inverse variants' A[J][J] = -P, P = L11^{-T} L11^{-1}, by the whole
// CTA (after the barrier that publishes s.linv), lower triangle.
template <typename T>
__device__ void pivot_inverse(T* W, const Active& act, const Smem<T>& s) {
  constexpr int NB = Shape<T>::NB;
  for (int e = threadIdx.x; e < NB * NB; e += kThreads) {
    const int q = e / NB, r = e % NB;
    if (q >= act.nb || r > q) continue;
    T acc = T(0);
    for (int i = q; i < NB; ++i) acc = fma(s.linv[i][q], s.linv[i][r], acc);
    W[static_cast<size_t>(act.J0 + q) * act.k + act.J0 + r] = -acc;
  }
}

// Stage the panel entries of compressed rows cb .. cb + MT - 1 into dst
// (zeros past the last row and past nb): rows stored as rows are read
// along t, rows stored as columns along i, so that neighbouring threads
// read neighbouring addresses either way.  Every thread issues all its
// loads before its first store: a store through a generic pointer could
// alias a later load, which would then wait for it.
template <typename T>
__device__ void stage(T (*dst)[Shape<T>::LDP], const T* W, const Active& act, int cb) {
  constexpr int NB = Shape<T>::NB, MT = Shape<T>::MT, EPT = MT * NB / kThreads;
  T v[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = threadIdx.x + q * kThreads, il = e / NB, t = e % NB, ci = cb + il;
    const bool load = ci < act.m && t < act.nb && act.real(ci) >= act.J0;
    v[q] = load ? W[act.at(act.real(ci), t)] : T(0);
  }
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = threadIdx.x + q * kThreads, il = e / NB, t = e % NB, ci = cb + il;
    if (ci >= act.m || act.real(ci) >= act.J0) dst[il][t] = v[q];
  }
  if (act.inverse && cb < act.J0) {
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int e = threadIdx.x + q * kThreads, t = e / MT, il = e % MT, ci = cb + il;
      v[q] = ci < act.m && ci < act.J0 && t < act.nb ? W[act.at(ci, t)] : T(0);
    }
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int e = threadIdx.x + q * kThreads, t = e / MT, il = e % MT, ci = cb + il;
      if (ci < act.m && ci < act.J0) dst[il][t] = v[q];
    }
  }
}

// Write the staged rows back: the inverse of stage.
template <typename T>
__device__ void unstage(T* W, const T (*src)[Shape<T>::LDP], const Active& act, int cb) {
  constexpr int NB = Shape<T>::NB, MT = Shape<T>::MT, EPT = MT * NB / kThreads;
  T v[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = threadIdx.x + q * kThreads;
    v[q] = src[e / NB][e % NB];
  }
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = threadIdx.x + q * kThreads, il = e / NB, t = e % NB, ci = cb + il;
    if (ci < act.m && t < act.nb && act.real(ci) >= act.J0) W[act.at(act.real(ci), t)] = v[q];
  }
  if (act.inverse && cb < act.J0) {
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int e = threadIdx.x + q * kThreads;
      v[q] = src[e % MT][e / MT];
    }
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int e = threadIdx.x + q * kThreads, t = e / MT, il = e % MT, ci = cb + il;
      if (ci < act.m && ci < act.J0 && t < act.nb) W[act.at(ci, t)] = v[q];
    }
  }
}

// (b) and (d), MT active rows at a time through shared memory, 4 threads a
// row: (b) V_i = U_i L11^{-T} and x_i -= V_i . z, (d) U_i P = V_i L11^{-1};
// in place.  L11^{-1} is lower triangular with explicit zeros, so both
// products run over the whole panel width.
template <typename T, bool kSecond>
__device__ void panel_rows(T* W, T* x, const Active& act, Smem<T>& s) {
  constexpr int NB = Shape<T>::NB, MT = Shape<T>::MT;
  constexpr int TPR = kThreads / MT;  // threads a row
  constexpr int CPT = NB / TPR;       // columns a thread
  const int row = threadIdx.x / TPR, c0 = (threadIdx.x % TPR) * CPT;
  for (int cb = 0; cb < act.m; cb += MT) {
    stage(s.a, W, act, cb);
    __syncthreads();
    T out[CPT] = {};
#pragma unroll 4
    for (int t = 0; t < NB; ++t) {
      const T u = s.a[row][t];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        out[j] = fma(u, kSecond ? s.linv[t][c0 + j] : s.linv[c0 + j][t], out[j]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CPT; ++j) s.a[row][c0 + j] = out[j];
    __syncthreads();
    if (!kSecond && x != nullptr && threadIdx.x < MT && cb + threadIdx.x < act.m) {
      T dot = T(0);
#pragma unroll 8
      for (int c = 0; c < NB; ++c) dot = fma(s.a[threadIdx.x][c], s.z[c], dot);
      x[act.real(cb + threadIdx.x)] -= dot;
    }
    unstage(W, s.a, act, cb);
    __syncthreads();
  }
}

__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load16(const double* p, double (&o)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  o[0] = v.x; o[1] = v.y;
}

// (c): A[i][l] -= V_i . V_l over the active lower triangle.
template <typename T>
__device__ void trailing_update(T* W, const Active& act, Smem<T>& s) {
  constexpr int NB = Shape<T>::NB, MT = Shape<T>::MT, V = Shape<T>::V;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int tiles = (act.m + MT - 1) / MT;
  for (int R = 0; R < tiles; ++R) {
    for (int C = 0; C <= R; ++C) {
      stage(s.a, W, act, R * MT);
      stage(s.b, W, act, C * MT);
      __syncthreads();
      T acc[4][4] = {};
#pragma unroll
      for (int t = 0; t < NB; t += V) {
        T ra[4][V], rc[4][V];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          load16(&s.a[ty + 16 * q][t], ra[q]);
          load16(&s.b[tx + 16 * q][t], rc[q]);
        }
#pragma unroll
        for (int e = 0; e < V; ++e)
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] = fma(ra[p][e], rc[q][e], acc[p][q]);
      }
      // read all 16 old values, then write (see stage)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int ci = R * MT + ty + 16 * p;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cl = C * MT + tx + 16 * q;
          if (ci < act.m && cl <= ci)
            acc[p][q] = W[static_cast<size_t>(act.real(ci)) * act.k + act.real(cl)] - acc[p][q];
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int ci = R * MT + ty + 16 * p;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cl = C * MT + tx + 16 * q;
          if (ci < act.m && cl <= ci)
            W[static_cast<size_t>(act.real(ci)) * act.k + act.real(cl)] = acc[p][q];
        }
      }
      __syncthreads();
    }
  }
}

// states: back substitution L^T s = y by blocks, from the last; y in x.
template <typename T>
__device__ void back_substitute(const T* W, const T* x, T* s_out, int k, Smem<T>& s) {
  constexpr int NB = Shape<T>::NB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = ((k - 1) / NB) * NB;
  for (int J0 = last; J0 >= 0; J0 -= NB) {
    const int nb = min(NB, k - J0);
    // t_c = sum over rows i below block J of L[i][J0 + c] s_i
    T part = T(0);
    if (lane < nb) {
      for (int i = J0 + nb + warp; i < k; i += kWarps)
        part = fma(W[static_cast<size_t>(i) * k + J0 + lane], s_out[i], part);
    }
    if (lane < NB) s.a[warp][lane] = part;
    __syncthreads();
    if (warp == 0) {
      const int c = lane;
      T r = T(0);
      T col[NB];  // lane c: column c of L11
      if (c < nb) {
        r = x[J0 + c];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) r -= s.a[w][c];
      }
#pragma unroll
      for (int i = 0; i < NB; ++i)
        col[i] = (c < nb && i < nb) ? (i >= c ? W[static_cast<size_t>(J0 + i) * k + J0 + c] : T(0))
                                    : (i == c ? T(1) : T(0));
      T sv = T(0);
#pragma unroll
      for (int i = NB - 1; i >= 0; --i) {
        const T si = __shfl_sync(0xffffffffu, r / col[i], i);
        if (c == i) sv = si;
        if (c < i) r = fma(-col[i], si, r);
      }
      if (c < nb) s_out[J0 + c] = sv;
    }
    __syncthreads();
  }
}

template <typename T, int WANT>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
spd_panel_kernel(const T* __restrict__ sigma, long long sigma_stride, const T* __restrict__ G,
                 const T* __restrict__ b, const T* __restrict__ rnorm,
                 const T* __restrict__ d_obs, T* __restrict__ s_out, T* __restrict__ m_out,
                 T* __restrict__ llk_out, T* __restrict__ sq_out, T* __restrict__ work,
                 long long B, int k) {
  constexpr int NB = Shape<T>::NB, OT = Shape<T>::OT;
  constexpr bool kInverse = is_inverse(WANT);
  constexpr bool kSecond = WANT == kFullT || WANT == kFull;
  __shared__ Smem<T> s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t kk = static_cast<size_t>(k) * k;
  // llk and states keep the right-hand side in the scratch's last row
  const size_t wstride = kInverse || WANT == kChol ? kk : kk + k;

  for (long long n = blockIdx.x; n < B; n += gridDim.x) {
    T* W = (kInverse ? m_out : work) + n * wstride;
    T* x = WANT == kChol ? nullptr : kInverse ? s_out + n * k : W + kk;
    const T* Gn = G + n * kk;
    T s2 = T(0);
    if (WANT != kChol) {
      const T sig = sigma[n * sigma_stride];
      s2 = sig * sig;
    }
    // M = G + sigma^2 I, lower triangle, a 32 x 32 tile at a time (loads
    // before stores, see stage)
    const int tiles = (k + OT - 1) / OT;
    for (int R = 0; R < tiles; ++R) {
      for (int C = 0; C <= R; ++C) {
        T g[OT * OT / kThreads];
#pragma unroll
        for (int q = 0; q < OT * OT / kThreads; ++q) {
          const int e = tid + q * kThreads, i = R * OT + e / OT, c = C * OT + e % OT;
          g[q] = i < k && c <= i ? Gn[static_cast<size_t>(i) * k + c] : T(0);
        }
#pragma unroll
        for (int q = 0; q < OT * OT / kThreads; ++q) {
          const int e = tid + q * kThreads, i = R * OT + e / OT, c = C * OT + e % OT;
          if (i < k && c <= i) W[static_cast<size_t>(i) * k + c] = g[q] + (c == i ? s2 : T(0));
        }
      }
    }
    if (x != nullptr)
      for (int i = tid; i < k; i += kThreads) x[i] = b[n * k + i];
    if (tid == 0) s.bad = 0;
    __syncthreads();

    T logdet = T(0), quad = T(0);  // warp 0's
    for (int J0 = 0; J0 < k; J0 += NB) {
      Active act;
      act.J0 = J0;
      act.nb = min(NB, k - J0);
      act.k = k;
      act.inverse = kInverse;
      act.m = kInverse ? k - act.nb : k - J0 - act.nb;
      if (warp == 0) pivot_block<T, WANT>(W, x, act, s, logdet, quad);
      __syncthreads();
      if (kInverse) pivot_inverse(W, act, s);
      if (act.m == 0) {
        __syncthreads();
        continue;
      }
      // each of these ends in a block barrier
      panel_rows<T, false>(W, x, act, s);
      trailing_update(W, act, s);
      if (kInverse) panel_rows<T, true>(W, nullptr, act, s);
    }
    const bool bad = s.bad != 0;
    const T poison = bad ? nan_like(T(0)) : T(0);

    if (WANT == kChol) {
      for (int i = warp; i < k; i += kWarps)
        for (int c = lane; c < k; c += 32)
          if (c > i) W[static_cast<size_t>(i) * k + c] = T(0);
          else if (bad) W[static_cast<size_t>(i) * k + c] = poison;
      __syncthreads();
      continue;
    }

    T tr = T(0);
    if (kInverse) {
      for (int i = tid; i < k; i += kThreads) tr -= W[static_cast<size_t>(i) * k + i];
      tr = block_sum(tr, s);
    }
    if (tid == 0) {
      const T dob = d_obs[n];
      llk_out[n] = T(-0.5) * ((rnorm[n] - quad) / s2 + logdet + log_t(s2) * (dob - T(k)) +
                              T(kLn2Pi) * dob) + poison;
      if (kInverse) sq_out[n] = s2 * (T(k) - s2 * tr) + poison;
    }
    if (WANT == kLlk) {
      __syncthreads();
      continue;
    }
    if (WANT == kStates) back_substitute(W, x, s_out + n * k, k, s);

    if (kInverse) {
      // SM = s s^T - sigma^2 A (or Sigma = -sigma^2 A), a 32 x 32 tile of the
      // lower triangle and its transpose at a time
      T (*tile)[OT + 1] = reinterpret_cast<T (*)[OT + 1]>(&s.a[0][0]);
      const T* sv = s_out + n * k;
      for (int R = 0; R < tiles; ++R) {
        for (int C = 0; C <= R; ++C) {
          T v[OT * OT / kThreads];
#pragma unroll
          for (int q = 0; q < OT * OT / kThreads; ++q) {
            const int e = tid + q * kThreads, i = R * OT + e / OT, c = C * OT + e % OT;
            v[q] = i < k && c <= i
                       ? (kSecond ? sv[i] * sv[c] : T(0)) - s2 * W[static_cast<size_t>(i) * k + c]
                       : T(0);
          }
#pragma unroll
          for (int q = 0; q < OT * OT / kThreads; ++q) {
            const int e = tid + q * kThreads, rl = e / OT, cl = e % OT;
            const int i = R * OT + rl, c = C * OT + cl;
            if (i < k && c <= i) {
              W[static_cast<size_t>(i) * k + c] = v[q] + poison;
              tile[cl][rl] = v[q] + poison;
            }
          }
          __syncthreads();
          for (int e = tid; e < OT * OT; e += kThreads) {
            const int rl = e / OT, cl = e % OT;  // row C*OT + rl, column R*OT + cl
            const int i = C * OT + rl, c = R * OT + cl;
            if (i < k && c < k && c > i) W[static_cast<size_t>(i) * k + c] = tile[rl][cl];
          }
          __syncthreads();
        }
      }
    }
    if (bad)
      for (int i = tid; i < k; i += kThreads) s_out[n * k + i] = poison;
    __syncthreads();
  }
}

// Multiprocessors of `device`, read once.
inline cudaError_t multiprocessors(int device, int& sms) {
  static int cached[kMaxDevices] = {};
  if (cached[device] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  sms = cached[device];
  return cudaSuccess;
}

template <typename T, int WANT>
cudaError_t launch_panel(int device, const void* sigma, long long sigma_stride, const void* G,
                         const void* b, const void* rnorm, const void* d_obs, void* s, void* m,
                         void* llk, void* sq, void* work, long long B, int k,
                         cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = multiprocessors(device, sms);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(kCtasPerSm) * sms;
  const unsigned grid = static_cast<unsigned>(B < slots ? B : slots);
  spd_panel_kernel<T, WANT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(sigma), sigma_stride, static_cast<const T*>(G),
      static_cast<const T*>(b), static_cast<const T*>(rnorm), static_cast<const T*>(d_obs),
      static_cast<T*>(s), static_cast<T*>(m), static_cast<T*>(llk), static_cast<T*>(sq),
      static_cast<T*>(work), B, k);
  return cudaGetLastError();
}

// The panel design for `want` (0-4 the spd_estep variants, 5 chol: G = M,
// work = L) at any k >= 1.  Arguments as spd_estep.cu's entry points take
// them, plus `work`: the (B, k+1, k) scratch for llk and states, L for chol.
template <typename T>
cudaError_t spd_panel(int want, int device, const void* sigma, long long sigma_stride,
                      const void* G, const void* b, const void* rnorm, const void* d_obs,
                      void* s, void* m, void* llk, void* sq, void* work, long long B, int k,
                      cudaStream_t stream) {
#define PPCA_PANEL_CASE(W)                                                                   \
  case W:                                                                                    \
    return launch_panel<T, W>(device, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, \
                              work, B, k, stream);
  switch (want) {
    PPCA_PANEL_CASE(kFullT)
    PPCA_PANEL_CASE(kStates)
    PPCA_PANEL_CASE(kLlk)
    PPCA_PANEL_CASE(kInfer)
    PPCA_PANEL_CASE(kFull)
    PPCA_PANEL_CASE(kChol)
    default:
      return cudaErrorInvalidValue;
  }
#undef PPCA_PANEL_CASE
}

}  // namespace panel
}  // namespace ppca
