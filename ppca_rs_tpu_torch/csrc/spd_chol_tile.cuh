// Register-tile design of the batched Cholesky factor (sm_90a), for
// k <= chol_tile_max_k<T>().
//
// Replaces, with spd_chol.cu's entry points, the Pallas TPU kernel
// `ppca_rs_tpu/ops/kernels.py:spd_chol` (the "chol" variant of
// `_make_kernel`); the outputs, layout and contract are the ones
// spd_chol.cu states: L (B,k,k) lower with L L^T = M, explicit zeros above
// the diagonal, only the lower triangle of M read.
//
// What bounds it: one launch must read M's lower triangle and write L
// whole (~6 k^2 bytes a sample in float32: 0.24 ms at B=8192, k=128 at
// 3.35 TB/s) and do k^3/3 FLOPs (k^3/6 FMAs); the factorization is a
// chain of k dependent pivot steps, so the latency of that chain, not
// device memory, is what the design works on.
//
// The design, on the lane grid of tile_common.cuh:
// * The tile A starts as M's lower triangle, padded to KP with an identity
//   block, and stays in registers.  Step j, one formula over the whole
//   tile so that every register index is a compile-time constant:
//     d = A[j][j];  u = A[:,j] / sqrt(d) at rows >= j, 0 above;
//     A -= u u^T;  column j = u.
//   With u = 0 above the pivot the update leaves the finished columns as
//   they are; what it leaves above the diagonal is never read (u is 0
//   there) and never written (L is written 0 above the diagonal), so M's
//   upper triangle is never read and need not be mirrored in.
// * u's zeros are chosen on the broadcast vectors, not on the tile, and
//   cost no compare per element: a lane's row and column quads that lie
//   wholly above the pivots' quad of four take the scale 0 instead of
//   1/sqrt(d) (one select a quad, decided once per quad of pivots), and
//   inside that quad the lanes that own it zero the (at most three)
//   entries above the pivot at compile-time indices.  The update is then
//   one block of 16 P Q FMAs with no branch.
// * Per step a warp skips the update of a row quad whose rows all lie
//   above the pivot in each of its lanes (u = 0 there): a branch that no
//   warp diverges on, since the lanes of a warp hold neighbouring rows.
// * Per step the lanes owning column j write it to a double-buffered
//   vector in shared memory with 16-byte stores, the sample's lanes sync
//   once (__syncwarp, or a named barrier for a sample of whole warps), and
//   every lane reads its rows' and columns' entries back with 16-byte
//   broadcast loads.  Whole column quads of the padding are not swept.
// * A pivot <= 0 or NaN (M not positive definite) makes the sample's
//   factor NaN on and below the diagonal; above it stays 0.  Nothing
//   reduces across samples, so its neighbours stay exact.
// * M is read, and L written, with 16-byte streaming accesses when
//   k % 4 == 0, scalar ones otherwise.

#pragma once

#include <cuda_runtime.h>

#include "spd_common.cuh"
#include "tile_common.cuh"

namespace ppca {
namespace tile {

template <typename T, int KP>
__global__ void __launch_bounds__(Shape<T, KP>::THREADS)
spd_chol_tile_kernel(const T* __restrict__ M, T* __restrict__ L, long long B, int k, bool vec) {
  using S = Shape<T, KP>;
  constexpr int GR = S::GR, GC = S::GC, NL = S::NL, P = S::P, Q = S::Q;
  constexpr int RS = 4 * GR;  // rows between a lane's row quads
  constexpr int CS = 4 * GC;  // columns between its column quads

  __shared__ __align__(16) T colbuf[S::GROUPS][2][KP];
  const int group = threadIdx.x / NL;
  const int lane = threadIdx.x % NL;
  const int lr = lane / GC;
  const int lc = lane % GC;
  const long long n = static_cast<long long>(blockIdx.x) * S::GROUPS + group;
  const bool live = n < B;  // a group past B factors the identity and writes nothing
  const int kl = live ? k : 0;
  const size_t kk = static_cast<size_t>(k) * k;
  const T* Mn = M + (live ? n : 0) * kk;
  // The last lane row in this lane's warp: a row quad p is done for the
  // whole warp once p * RS + 4 * lr_hi + 3 < j.
  constexpr int LPW = NL < 32 ? NL : 32;  // the sample's lanes in one warp
  const int lr_hi = ((lane / LPW) * LPW + LPW - 1) / GC;

  // A = tril(M), zeros above, padded with an identity block.
  T A[P][4][Q][4];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int er = 0; er < 4; ++er) {
      const int i = p * RS + 4 * lr + er;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int l0 = q * CS + 4 * lc;
        const T* src = Mn + static_cast<size_t>(i) * k + l0;
        T g[4];
        if (vec && i < kl && l0 + 3 <= i) {
          load_quad_stream(src, g);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) g[e] = (i < kl && l0 + e <= i) ? src[e] : T(0);
        }
#pragma unroll
        for (int ec = 0; ec < 4; ++ec) {
          const int l = l0 + ec;
          A[p][er][q][ec] = (i >= kl && i == l) ? T(1) : g[ec];
        }
      }
    }
  }

  bool ok = true;  // every pivot so far > 0
#pragma unroll
  for (int qq = 0; qq < Q; ++qq) {
    const int pp = (qq * GC) / GR;
    const int rbase = (qq % (GR / GC)) * GC;
#pragma unroll 1
    for (int c = 0; c < GC; ++c) {
      const int j0 = qq * CS + 4 * c;  // the pivots' quad: j0 .. j0 + 3
      // the rest is padding (k, not kl: a group past B sweeps with the
      // others, whose __syncwarp it may share)
      if (j0 >= k) break;
      const bool col_owner = lc == c;
      const bool row_owner = lr == rbase + c;
      // u is 0 at the rows of every quad before the pivots' quad: the scale
      // of a lane's row and column quads is 0 there, 1/sqrt(d) elsewhere
      bool rlive[P], clive[Q];
#pragma unroll
      for (int p = 0; p < P; ++p) rlive[p] = p * RS + 4 * lr >= j0;
#pragma unroll
      for (int q = 0; q < Q; ++q) clive[q] = q * CS + 4 * lc >= j0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        T* buf = colbuf[group][e & 1];
        if (col_owner) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const T col[4] = {A[p][0][qq][e], A[p][1][qq][e], A[p][2][qq][e], A[p][3][qq][e]};
            store_quad(buf + p * RS + 4 * lr, col);
          }
        }
        group_sync<NL>(group);
        const T d = buf[j];
        T vr[P][4];
        T vc[Q][4];
#pragma unroll
        for (int p = 0; p < P; ++p) load_quad(buf + p * RS + 4 * lr, vr[p]);
#pragma unroll
        for (int q = 0; q < Q; ++q) load_quad(buf + q * CS + 4 * lc, vc[q]);
        ok = ok && d > T(0);
        const T rs = sqrt_t(T(1) / d);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const T f = rlive[p] ? rs : T(0);
#pragma unroll
          for (int er = 0; er < 4; ++er) vr[p][er] *= f;
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const T f = clive[q] ? rs : T(0);
#pragma unroll
          for (int ec = 0; ec < 4; ++ec) vc[q][ec] *= f;
        }
        // ... and at the rows of the pivots' quad above the pivot
#pragma unroll
        for (int er = 0; er < e; ++er) {
          if (row_owner) vr[pp][er] = T(0);
          if (col_owner) vc[qq][er] = T(0);
        }
        // A -= u u^T over the whole tile: the finished columns (u = 0 there)
        // keep their values; column j is rewritten below
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            if (p * RS + 4 * lr_hi + 3 < j) continue;  // the warp's rows done
#pragma unroll
            for (int er = 0; er < 4; ++er)
#pragma unroll
              for (int ec = 0; ec < 4; ++ec)
                A[p][er][q][ec] = fma(-vr[p][er], vc[q][ec], A[p][er][q][ec]);
          }
        // column j becomes u: 0 above the pivot, d / sqrt(d) on it
        if (col_owner) {
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int er = 0; er < 4; ++er) A[p][er][qq][e] = vr[p][er];
        }
      }
    }
  }
  if (!live) return;

  // L: the tile on and below the diagonal (NaN there if a pivot failed),
  // zeros above it.
  const T bad = ok ? T(0) : nan_like(T(0));
  T* Ln = L + n * kk;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int er = 0; er < 4; ++er) {
      const int i = p * RS + 4 * lr + er;
      if (i >= k) continue;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int l0 = q * CS + 4 * lc;
        if (l0 >= k) continue;
        T o[4];
#pragma unroll
        for (int ec = 0; ec < 4; ++ec) o[ec] = l0 + ec <= i ? A[p][er][q][ec] + bad : T(0);
        T* dst = Ln + static_cast<size_t>(i) * k + l0;
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

template <typename T, int KP>
cudaError_t launch_chol_tile(const T* M, T* L, long long B, int k, bool vec, cudaStream_t stream) {
  using S = Shape<T, KP>;
  const long long blocks = (B + S::GROUPS - 1) / S::GROUPS;
  spd_chol_tile_kernel<T, KP><<<static_cast<unsigned>(blocks), S::THREADS, 0, stream>>>(M, L, B, k, vec);
  return cudaGetLastError();
}

// The register-tile Cholesky factor for 1 <= k <= chol_tile_max_k<T>(), on the
// smallest tile that holds k.  Arguments as spd_chol.cu's entry points take
// them.
template <typename T>
cudaError_t spd_chol_tile(const void* M, void* L, long long B, int k, cudaStream_t stream) {
  const bool vec = k % 4 == 0 && aligned16(M) && aligned16(L);
  const T* m = static_cast<const T*>(M);
  T* l = static_cast<T*>(L);
  if (k <= 8) return launch_chol_tile<T, 8>(m, l, B, k, vec, stream);
  if (k <= 16) return launch_chol_tile<T, 16>(m, l, B, k, vec, stream);
  if (k <= 32) return launch_chol_tile<T, 32>(m, l, B, k, vec, stream);
  if (k <= 64) return launch_chol_tile<T, 64>(m, l, B, k, vec, stream);
  if (k <= chol_tile_max_k<T>()) return launch_chol_tile<T, 128>(m, l, B, k, vec, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tile
}  // namespace ppca
