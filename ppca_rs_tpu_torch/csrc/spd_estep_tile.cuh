// Register-tile design of the batched SPD E-step (sm_90a), for
// k <= estep_tile_max_k<T>().
//
// Replaces, with spd_estep.cu's entry points, the Pallas TPU kernel
// `ppca_rs_tpu/ops/kernels.py:_make_kernel` as launched by `spd_estep`; the
// outputs, layout and contract are the ones spd_estep.cu states.
//
// What bounds it: one fullt launch must read G's lower triangle and write
// SM's, all that its consumer reads (~4 k(k+1) bytes per sample in float32:
// 141 MB at B=8192, k=64, 42 us at 3.35 TB/s; this kernel writes SM whole),
// and do ~k^3 floating-point operations (34 us at 67 TFLOP/s).  A sample's
// work is a chain of k dependent
// pivot steps, so what can hold the kernel back is the latency of that
// chain and the traffic of each step inside the SM, not device memory.
//
// The design:
// * M = sigma^2 I + G is inverted in place by k symmetric sweeps
//   (Gauss-Jordan on an SPD matrix, no pivoting):
//     d = A[j][j], u = A[:,j] / sqrt(d);
//     A[i][l] -= u[i] u[l];  A[j][l] = A[l][j] = A[l][j] / d;  A[j][j] = -1/d,
//   after which A = -M^{-1}.  Every step touches the whole tile with one
//   formula, so the tile stays in registers with indices fixed at compile
//   time: k^3 FMAs in all, the cost of potrf + trtri + lauum, in one buffer
//   and with no second k x k matrix for W = L^{-1}.  The pivots d_j are the
//   Cholesky pivots, so log det M = sum log d_j.  b rides as one more
//   column: it ends as s = M^{-1} b, and the squares of its pivot entries
//   sum to b^T M^{-1} b = |L^{-1} b|^2 for the llk.  The update is
//   u[i] u[l] with one rounding, so a symmetric G gives a bitwise
//   symmetric SM.
// * A sample belongs to NL lanes (4 to 32 of one warp; two whole warps for
//   float64 at KP=64; four at float32 KP=128), laid out as the GR x GC
//   lane grid of tile_common.cuh; each lane holds the 4P x 4Q elements at
//   rows p*4GR + 4r + (0..3) and columns q*4GC + 4c + (0..3).  A block
//   holds several samples below 128 lanes a sample, one from there up.
// * Per step the lanes owning column j write it (with b's pivot entry) to a
//   double-buffered vector in shared memory with 16-byte stores, the group
//   syncs once (__syncwarp, or `bar.sync id, NL` for a sample of whole
//   warps: a named barrier, never the block's), and every lane reads its
//   rows' and columns' entries back with 16-byte broadcast loads.  The
//   other samples on the SM hide the chain's latency.  The end-of-sweep
//   sums (log det M, tr M^{-1}) are taken by every warp of the sample over
//   all k entries in shared memory, so they need no exchange between its
//   warps.
// * G is read, and SM / Sigma written, with 16-byte streaming accesses
//   when k % 4 == 0 (four neighbouring lanes cover 64 contiguous bytes of
//   a row); both triangles are read as they are.
// * k is padded to the tile KP in {8, 16, 32, 64, 128} with an identity
//   block, which changes neither log det M (its pivots are 1) nor s;
//   nothing of the padding is written.
// * A sample whose M is not positive definite has a pivot <= 0 (or NaN):
//   its log det is not finite and every output element of that sample is
//   written NaN.  Nothing reduces across samples, so its neighbours in the
//   warp or block stay exact.

#pragma once

#include <cuda_runtime.h>

#include "spd_common.cuh"
#include "tile_common.cuh"

namespace ppca {
namespace tile {

constexpr int kFullT = 0;
constexpr int kStates = 1;
constexpr int kLlk = 2;
constexpr int kInfer = 3;
constexpr int kFull = 4;

constexpr double kLn2Pi = 1.8378770664093453;

// A sample's shared memory: the pivot column, double-buffered, with b's
// pivot entry at [KP]; the pivots; the diagonal of M^{-1}; s.
template <typename T, int KP>
struct alignas(16) Scratch {
  T v[2][KP + 4];
  T piv[KP];
  T dg[KP];
  T s[KP];
};

template <typename T, int KP, int WANT>
__global__ void __launch_bounds__(Shape<T, KP>::THREADS)
spd_estep_tile_kernel(const T* __restrict__ sigma, long long sigma_stride,
                      const T* __restrict__ G, const T* __restrict__ b,
                      const T* __restrict__ rnorm, const T* __restrict__ d_obs,
                      T* __restrict__ s_out, T* __restrict__ m_out,
                      T* __restrict__ llk_out, T* __restrict__ sq_out,
                      long long B, int k, bool vec) {
  using S = Shape<T, KP>;
  constexpr int GR = S::GR, GC = S::GC, NL = S::NL, P = S::P, Q = S::Q;
  constexpr int RS = 4 * GR;                // rows between a lane's row quads
  constexpr int CS = 4 * GC;                // columns between its column quads
  constexpr int W = NL < 32 ? NL : 32;      // lanes of one reduction (one warp)
  constexpr bool kInverse = WANT == kFullT || WANT == kFull || WANT == kInfer;
  constexpr bool kSecond = WANT == kFullT || WANT == kFull;

  __shared__ Scratch<T, KP> scratch[S::GROUPS];
  const int group = threadIdx.x / NL;
  const int lane = threadIdx.x % NL;
  const int lr = lane / GC;
  const int lc = lane % GC;
  Scratch<T, KP>& sc = scratch[group];
  const long long n = static_cast<long long>(blockIdx.x) * S::GROUPS + group;
  const bool live = n < B;  // a group past B sweeps the identity and writes nothing
  const T sig = live ? sigma[n * sigma_stride] : T(1);
  const T s2 = sig * sig;
  const size_t kk = static_cast<size_t>(k) * k;

  // A = M = sigma^2 I + G, padded with an identity block; x = b, padded with 0.
  T A[P][4][Q][4];
  T x[P][4];
  const T* Gn = G + (live ? n : 0) * kk;
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int er = 0; er < 4; ++er) {
      const int i = p * RS + 4 * lr + er;
      const bool row_in = live && i < k;
      x[p][er] = row_in ? b[n * k + i] : T(0);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int l0 = q * CS + 4 * lc;
        const T* src = Gn + static_cast<size_t>(i) * k + l0;
        T g[4];
        if (vec && row_in && l0 < k) {
          load_quad_stream(src, g);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) g[e] = (row_in && l0 + e < k) ? src[e] : T(0);
        }
#pragma unroll
        for (int ec = 0; ec < 4; ++ec) {
          const int l = l0 + ec;
          A[p][er][q][ec] = g[ec] + (i == l ? (i < k ? s2 : T(1)) : T(0));
        }
      }
    }
  }

  // The k sweeps.  Pivot j = qq*CS + 4c + e lies in column quad qq of the
  // lanes with lc == c and in row quad pp of the lanes with lr == rbase + c;
  // qq and e are unrolled so that every register index is a constant.
  T quad = T(0);
#pragma unroll
  for (int qq = 0; qq < Q; ++qq) {
    const int pp = (qq * GC) / GR;
    const int rbase = (qq % (GR / GC)) * GC;
#pragma unroll 1
    for (int c = 0; c < GC; ++c) {
      const bool col_owner = lc == c;
      const bool row_owner = lr == rbase + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = qq * CS + 4 * c + e;
        T* buf = sc.v[e & 1];
        if (col_owner) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const T col[4] = {A[p][0][qq][e], A[p][1][qq][e], A[p][2][qq][e], A[p][3][qq][e]};
            store_quad(buf + p * RS + 4 * lr, col);
          }
          if (row_owner) buf[KP] = x[pp][e];
        }
        group_sync<NL>(group);
        const T d = buf[j];
        const T xj = buf[KP];
        T vr[P][4];
        T vc[Q][4];
#pragma unroll
        for (int p = 0; p < P; ++p) load_quad(buf + p * RS + 4 * lr, vr[p]);
#pragma unroll
        for (int q = 0; q < Q; ++q) load_quad(buf + q * CS + 4 * lc, vc[q]);
        const T inv_d = T(1) / d;
        const T rs = sqrt_t(inv_d);
        const T t = xj * rs;
        quad += t * t;
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int er = 0; er < 4; ++er) vr[p][er] *= rs;
#pragma unroll
        for (int q = 0; q < Q; ++q)
#pragma unroll
          for (int ec = 0; ec < 4; ++ec) vc[q][ec] *= rs;
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int er = 0; er < 4; ++er) {
#pragma unroll
            for (int q = 0; q < Q; ++q)
#pragma unroll
              for (int ec = 0; ec < 4; ++ec)
                A[p][er][q][ec] = fma(-vr[p][er], vc[q][ec], A[p][er][q][ec]);
            x[p][er] = fma(-vr[p][er], t, x[p][er]);
          }
        // the pivot row and column become v / d, the pivot -1/d
        if (row_owner) {
#pragma unroll
          for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int ec = 0; ec < 4; ++ec) A[pp][e][q][ec] = vc[q][ec] * rs;
          x[pp][e] = t * rs;
        }
        if (col_owner) {
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int er = 0; er < 4; ++er) A[p][er][qq][e] = vr[p][er] * rs;
        }
        if (row_owner && col_owner) {
          A[pp][e][qq][e] = -inv_d;
          sc.piv[j] = d;
        }
      }
    }
  }

  // diag(M^{-1}) = -diag(A) and s = x to shared memory, then log det M and
  // tr M^{-1} over the first k dimensions, summed over one warp's lanes.
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int er = 0; er < 4; ++er) {
      const int i = p * RS + 4 * lr + er;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (q * CS + 4 * lc == p * RS + 4 * lr) sc.dg[i] = -A[p][er][q][er];
      if (lc == 0) sc.s[i] = x[p][er];
    }
  group_sync<NL>(group);
  T logdet = T(0);
  T tr = T(0);
  for (int t = lane % W; t < k; t += W) {
    logdet += log_t(sc.piv[t]);
    tr += sc.dg[t];
  }
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    logdet += __shfl_xor_sync(0xffffffffu, logdet, off);
    tr += __shfl_xor_sync(0xffffffffu, tr, off);
  }
  // A pivot <= 0 (M not positive definite) or NaN: the whole sample is NaN.
  const T poison = isfinite(logdet) ? T(0) : nan_like(logdet);
  if (!live) return;

  if (lane == 0) {
    const T dob = d_obs[n];
    llk_out[n] = T(-0.5) * ((rnorm[n] - quad) / s2 + logdet + log_t(s2) * (dob - T(k)) +
                            T(kLn2Pi) * dob) + poison;
    if (kInverse) sq_out[n] = s2 * (T(k) - s2 * tr) + poison;
  }
  if (WANT == kLlk) return;
  if (lc == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i0 = p * RS + 4 * lr;
      T o[4];
#pragma unroll
      for (int er = 0; er < 4; ++er) o[er] = x[p][er] + poison;
      T* dst = s_out + n * k + i0;
      if (vec && i0 < k) {
        store_quad(dst, o);
      } else {
#pragma unroll
        for (int er = 0; er < 4; ++er)
          if (i0 + er < k) dst[er] = o[er];
      }
    }
  }
  if (WANT == kStates) return;

  // SM = s s^T + sigma^2 M^{-1} (fullt, full) or Sigma = sigma^2 M^{-1}
  // (infer), each lane its own elements.
  T scol[Q][4];
#pragma unroll
  for (int q = 0; q < Q; ++q) load_quad(sc.s + q * CS + 4 * lc, scol[q]);
  T* Mn = m_out + n * kk;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int er = 0; er < 4; ++er) {
      const int i = p * RS + 4 * lr + er;
      if (i >= k) continue;
      const T si = x[p][er];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int l0 = q * CS + 4 * lc;
        if (l0 >= k) continue;
        T o[4];
#pragma unroll
        for (int ec = 0; ec < 4; ++ec) {
          const T cov = s2 * -A[p][er][q][ec];
          o[ec] = (kSecond ? fma(si, scol[q][ec], cov) : cov) + poison;
        }
        T* dst = Mn + static_cast<size_t>(i) * k + l0;
        if (vec) {
          store_quad_stream(dst, o);
        } else {
#pragma unroll
          for (int ec = 0; ec < 4; ++ec)
            if (l0 + ec < k) dst[ec] = o[ec];
        }
      }
    }
}

template <typename T, int KP, int WANT>
cudaError_t launch_tile(const T* sigma, long long sigma_stride, const T* G, const T* b,
                        const T* rnorm, const T* d_obs, T* s, T* m, T* llk, T* sq,
                        long long B, int k, bool vec, cudaStream_t stream) {
  using S = Shape<T, KP>;
  const long long blocks = (B + S::GROUPS - 1) / S::GROUPS;
  spd_estep_tile_kernel<T, KP, WANT><<<static_cast<unsigned>(blocks), S::THREADS, 0, stream>>>(
      sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, vec);
  return cudaGetLastError();
}

template <typename T, int KP>
cudaError_t launch_tile_want(int want, const T* sigma, long long sigma_stride, const T* G,
                             const T* b, const T* rnorm, const T* d_obs, T* s, T* m, T* llk,
                             T* sq, long long B, int k, bool vec, cudaStream_t stream) {
  switch (want) {
    case kFullT:
      return launch_tile<T, KP, kFullT>(sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, vec, stream);
    case kStates:
      return launch_tile<T, KP, kStates>(sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, vec, stream);
    case kLlk:
      return launch_tile<T, KP, kLlk>(sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, vec, stream);
    case kInfer:
      return launch_tile<T, KP, kInfer>(sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, vec, stream);
    case kFull:
      return launch_tile<T, KP, kFull>(sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The register-tile E-step for 1 <= k <= estep_tile_max_k<T>(), on the
// smallest tile that holds k.  Arguments as spd_estep.cu's entry points
// take them.
template <typename T>
cudaError_t spd_estep_tile(int want, const void* sigma, long long sigma_stride, const void* G,
                           const void* b, const void* rnorm, const void* d_obs, void* s,
                           void* m, void* llk, void* sq, long long B, int k, cudaStream_t stream) {
  const bool vec = k % 4 == 0 && aligned16(G) && aligned16(s) && aligned16(m);
  const T* sg = static_cast<const T*>(sigma);
  const T* g = static_cast<const T*>(G);
  const T* bb = static_cast<const T*>(b);
  const T* rn = static_cast<const T*>(rnorm);
  const T* dob = static_cast<const T*>(d_obs);
  T* so = static_cast<T*>(s);
  T* mo = static_cast<T*>(m);
  T* lo = static_cast<T*>(llk);
  T* qo = static_cast<T*>(sq);
  if (k <= 8) return launch_tile_want<T, 8>(want, sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, vec, stream);
  if (k <= 16) return launch_tile_want<T, 16>(want, sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, vec, stream);
  if (k <= 32) return launch_tile_want<T, 32>(want, sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, vec, stream);
  if (k <= 64) return launch_tile_want<T, 64>(want, sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, vec, stream);
  if constexpr (estep_tile_max_k<T>() > 64) {
    if (k <= estep_tile_max_k<T>()) return launch_tile_want<T, 128>(want, sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, vec, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tile
}  // namespace ppca
