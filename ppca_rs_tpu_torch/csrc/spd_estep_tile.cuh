// Tile design of the batched SPD E-step (sm_90a), for k <= estep_tile_max_k<T>()
// (128 in float, 64 in double), and of the batched Cholesky factor (the sixth
// variant, kChol), for k <= chol_tile_max_k<T>() (128 in both).
//
// Replaces, with spd_estep.cu's entry points, the Pallas TPU kernel
// `ppca_rs_tpu/ops/kernels.py:_make_kernel` as launched by `spd_estep`; the
// outputs, layout and contract are the ones spd_estep.cu states (fullt writes
// SM's lower triangle only, as the TPU kernel did).  With spd_chol.cu's entry
// points, kChol replaces the same body as launched by `spd_chol` (the "chol"
// variant): M in (lower triangle read), L out whole, the contract spd_chol.cu
// states.
//
// What bounds it on this card: one fullt launch must read G's lower triangle
// and write SM's (~4 k(k+1) bytes a sample in float32: 141 MB at B=8192,
// k=64, 42 us at 3.35 TB/s) and do ~k^3 flops (k^3/2 FMAs) for the inverse
// variants, k^3/3 for llk and states.  At the SIMT float32 rate (67 TFLOP/s)
// bytes bound k <= ~64 and operations k=128 (262 us at B=8192); at 3xTF32's
// 165 TFLOP/s of float32 work bytes bound every k of the tile.  Neither is
// what holds the design back on an H100 (PERF.md): a sample is a chain of k
// dependent pivots, and the instructions a sample issues around its products
// (staging, fragment splits, accumulator traffic, the output rows) keep the
// multiprocessors' issue slots busy.
//
// The design, two bodies by the padded size KP:
// * KP in {8, 16}: one diagonal block, no tensor cores.  A sample is a
//   segment of KP lanes (32/KP samples a warp); lane r holds row r of
//   M = sigma^2 I + G in registers, read from G's lower triangle staged in
//   shared memory by cp.async, and the symmetric Gauss-Jordan sweep runs on
//   it with shuffles (gj_sweep) for every variant: A ends as -M^{-1}, b,
//   riding as one more column, as s = M^{-1} b.  G's rows come into shared
//   memory (in float), and full's and infer's rows go out through it, a
//   chunk a lane, neighbouring lanes on neighbouring chunks; fullt writes
//   its triangle a row a lane.
// * KP in {32, 64, 128}: one CTA of NW warps (1, 2, 8) a sample, a
//   persistent grid of as many CTAs as fit a multiprocessor (in float 20 at
//   KP=32, by registers; 8 at KP=64 and 2 at KP=128, by shared memory).  The sample's working matrix is KP x KP in dynamic
//   shared memory, lower triangle only, row stride KP + 8 (8- or 16-byte
//   accumulator accesses fall on distinct banks).  G's lower triangle and b
//   are staged by cp.async, 16-byte copies where a row is 16-byte aligned in
//   device memory and element copies otherwise, 32 / (KP / V) rows a warp
//   pass (V elements a lane); the next sample's rows go into A as soon as
//   this sample's are dead (a lane restages the chunk it has just written
//   out, llk each pivot block's rows after its step), so the copies overlap
//   the end of the sample before.  (A second buffer for the next sample's G measured slower:
//   it halved the CTAs a multiprocessor holds.)  k is padded to KP with an
//   identity block, which changes neither log det M nor s.
//   Steps of NB = 16 columns, at J0, S = A[J][J]; the active rows are those
//   below block J (llk, states: the right-looking block LDL^T factor, k^3/6
//   FMAs) or all rows but block J's (fullt, full, infer: the blocked
//   symmetric Gauss-Jordan sweep, k^3/2 FMAs, the cost of potrf + trtri +
//   lauum, with no second k x k buffer; rows above block J keep their panel
//   entries as columns, A[J0 + t][i]).  Per step, three barriers:
//   (1) warp 0 inverts S in registers by the Gauss-Jordan sweep, two lanes
//       a row (gj_sweep_halves: shuffles, no shared-memory round trip per
//       pivot, 1/sqrt(d) one reciprocal square root): P = S^{-1}, its pivots
//       (log det), z = L11^{-1} x_J (|z|^2 adds to b^T M^{-1} b) and
//       x_J <- P x_J; the inverse variants store -P in block J.  Meanwhile
//       the other warps (or warp 0 after it, alone at KP=32) stage the
//       active rows' panel entries U;
//   (2) Y = U P on the tensor cores, a 16-row block a warp; x_i -= Y_i x_J;
//       Y is stored for (3) and written as block column J (the inverse's
//       new panel, and states' L_iJ for the back substitution);
//   (3) the active lower triangle takes A[i][l] -= Y_i . U_l, a 16 x 16
//       tile a warp, round-robin.  (Inverting the next pivot block during
//       (3) measured slower at KP=32 and 128 and no faster at 64.)
//   The products run on mma.sync: float as 3xTF32 m16n8k8 (spd_panel_mma.cuh:
//   lo*hi + hi*lo + hi*hi, float32 accuracy), double on FP64 MMA m8n8k4.
//   states then back-substitutes s_J = x_J - sum over blocks I > J of
//   Y_IJ^T s_I, one block of rows a pass; full and infer mirror the lower
//   triangle in shared memory before their write.
// * Outputs are written once, with streaming stores, 16-byte where a row is
//   aligned: fullt's SM = s s^T + sigma^2 M^{-1} on and below the diagonal
//   only (nothing above it is written), full's SM and infer's
//   Sigma = sigma^2 M^{-1} whole.
// * G's layout is a template argument of the blocked body, SLAB (chosen by
//   spd_estep.cu's `layout`; a runtime argument measured 3-8% slower on
//   square G for fullt on an H100, PERF.md): square, or slabs (k a multiple
//   of 8): blocks of 8 rows, row r
//   of block j = r / 8 holding its first 8 (j + 1) entries, the lower
//   triangle and the upper part of its 8 x 8 diagonal block, rows one after
//   another, 32 m (m + 1) elements a sample for m = k / 8 (row_offset).  Only
//   where a row starts changes: every slab row starts 16-byte aligned, and
//   its chunks on or below the diagonal lie inside it, so stage_rows takes
//   16-byte copies.  Under slabs fullt's SM is written in the same layout,
//   each row's whole slab width: SM on and below the diagonal, zeros above
//   it.  The one-block body and kChol take square matrices only, so the
//   slab instantiations are the five E-step variants at KP in {32, 64, 128}
//   (float) and {32, 64} (double).
// * A sample whose M is not positive definite has a pivot <= 0 (or NaN): its
//   log det is not finite and every output element of that sample is written
//   NaN.  Nothing reduces across samples.
// * kChol, the Cholesky factor L of M itself (no sigma^2, no right-hand
//   side, no llk; sigma, b, rnorm, d_obs and those outputs are null, L is
//   m_out).  Its bound: M's lower triangle in and L out whole (~6 k^2 bytes
//   a sample in float32) against k^3/6 FMAs, bytes at every k of the tile
//   at the tensor cores' rate.  KP in {8, 16}: lane r holds row r of M's
//   lower triangle and the segment runs the column step with shuffles
//   (d = A[j][j], column j becomes A[:,j] / sqrt(d) at rows >= j, the rows
//   below take -L[i][j] L[l][j]); its rows go out as full's do.  KP in {32,
//   64, 128}: the steps of llk and states (rows below block J active, three
//   barriers a step), with the pivot block the Cholesky block:
//   (1) warp 0 factors S = L11 L11^T in registers by the same column step,
//       lane r (and r + NB beside it) row r, one reciprocal square root a
//       pivot; writes L11 into block J and L11^{-1} (lane c forms column c
//       by forward substitution) into P;
//   (2) L21 = U L11^{-T} on the tensor cores (the form this design uses),
//       stored in Y and as block column J;
//   (3) A22 -= L21 L21^T over the active lower triangle, Y both operands.
//   Rows J0 .. J0 + NB - 1 of L are final after step J's (1): they go out
//   then (zeros above the diagonal, 16-byte stores where a row is aligned)
//   and the next sample's rows are staged in their place, so the copies
//   overlap the steps after.  Whether the sample factored is known at the
//   last step's (1), which warp 0 publishes before its barrier: a failed
//   sample's earlier rows are then written again, NaN on and below the
//   diagonal (a rewrite only for a bad sample).  Identity padding rows are
//   never written out.  In double KP=128 (k 65..128) is instantiated for
//   kChol alone: its ~176 KB of shared memory leave one CTA a
//   multiprocessor.
// * Offsets are size_t; B fits an int (spd_estep.cu checks it).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "spd_common.cuh"
#include "spd_panel_mma.cuh"

namespace ppca {
namespace tile {

constexpr int kFullT = 0;
constexpr int kStates = 1;
constexpr int kLlk = 2;
constexpr int kInfer = 3;
constexpr int kFull = 4;
constexpr int kChol = 5;  // spd_chol: M in, L out

constexpr double kLn2Pi = 1.8378770664093453;
constexpr unsigned kAll = 0xffffffffu;
// Shared memory a multiprocessor has for blocks, and what each block reserves.
constexpr int kSmemPerSm = 233472;
constexpr int kSmemReserved = 1024;

__host__ __device__ constexpr bool is_inverse(int want) {
  return want == kFullT || want == kFull || want == kInfer;
}
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// ---------------------------------------------------------------------------
// Pieces of both bodies

// The symmetric Gauss-Jordan sweep of an NB x NB SPD block held by a segment
// of NB lanes, lane r holding row r in a, with the right-hand side's entry in
// x.  Step j: d = A[j][j], w_i = A[i][j] / d; A[i][l] -= w_i A[j][l];
// row and column j become A[j][l] / d, the pivot -1/d.  The block ends as
// -S^{-1} and x as S^{-1} x.  Lane r returns its own pivot (the Cholesky
// pivot d_r of S) and z_r = x_r / sqrt(d_r) at its step (z = L^{-1} x).
// 1/d is the square of one reciprocal square root: an IEEE division and
// square root lengthen every pivot's chain.  The own row is selected rather
// than branched on (a branch per step diverges).
template <typename T, int NB>
__device__ __forceinline__ void gj_sweep(T (&a)[NB], T& x, int r, T& piv, T& z) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    T u[NB];  // row j
#pragma unroll
    for (int l = 0; l < NB; ++l) u[l] = __shfl_sync(kAll, a[l], j, NB);
    const T xj = __shfl_sync(kAll, x, j, NB);
    const T d = u[j];
    const T rs = rsqrt_t(d);
    const T inv_d = rs * rs;
    const T w = a[j] * inv_d;
#pragma unroll
    for (int l = 0; l < NB; ++l) a[l] = fma(-w, u[l], a[l]);
    x = fma(-w, xj, x);
    a[j] = w;
    const bool own = r == j;
#pragma unroll
    for (int l = 0; l < NB; ++l) a[l] = own ? u[l] * inv_d : a[l];
    a[j] = own ? -inv_d : a[j];
    x = own ? xj * inv_d : x;
    piv = own ? d : piv;
    z = own ? xj * rs : z;
  }
}

// The same sweep over a whole warp, two lanes a row: lane r + NB h holds the
// columns NB/2 h .. NB/2 h + NB/2 - 1 of row r, so a step takes NB/2 + 3
// shuffles and NB/2 multiply-adds a lane (the pivot row's half from lane
// j + NB h, the pivot from lane j + NB (j / (NB/2)), this row's entry in
// column j from lane r + NB (j / (NB/2)), x_j from lane j).  x is held by
// both lanes of a row; piv and z as gj_sweep returns them, in both.
template <typename T, int NB>
__device__ __forceinline__ void gj_sweep_halves(T (&a)[NB / 2], T& x, int r, int h, T& piv, T& z) {
  constexpr int HB = NB / 2;
  static_assert(2 * NB == 32, "two lanes a row fill one warp");
  // the pivots of one half unrolled (register indices fixed at compile
  // time), the two halves a loop: half the code of a full unroll
#pragma unroll 1
  for (int jh = 0; jh < 2; ++jh)
#pragma unroll
  for (int je = 0; je < HB; ++je) {
    const int j = jh * HB + je;
    T u[HB];  // row j's half
#pragma unroll
    for (int e = 0; e < HB; ++e) u[e] = __shfl_sync(kAll, a[e], j + NB * h);
    const T d = __shfl_sync(kAll, a[je], j + NB * jh);
    const T arj = __shfl_sync(kAll, a[je], r + NB * jh);
    const T xj = __shfl_sync(kAll, x, j);
    const T rs = rsqrt_t(d);
    const T inv_d = rs * rs;
    const T w = arj * inv_d;
#pragma unroll
    for (int e = 0; e < HB; ++e) a[e] = fma(-w, u[e], a[e]);
    x = fma(-w, xj, x);
    if (h == jh) a[je] = w;
    const bool own = r == j;
#pragma unroll
    for (int e = 0; e < HB; ++e) a[e] = own ? u[e] * inv_d : a[e];
    if (h == jh) a[je] = own ? -inv_d : a[je];
    x = own ? xj * inv_d : x;
    piv = own ? d : piv;
    z = own ? xj * rs : z;
  }
}

// Copy the first n elements of a row of G (k elements long) into shared
// memory by cp.async, as `lanes` threads (this one is `lane`): 16-byte copies
// where the row starts 16-byte aligned (the tail of the last one zero-filled
// past k), element copies otherwise.  dst is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* src, int n, int k, int lane, int lanes) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    for (int c = lane * V; c < n; c += lanes * V)
      panel::cp_async16(dst + c, src + c, cmin(V, k - c) * static_cast<int>(sizeof(T)));
  } else {
    for (int c = lane; c < n; c += lanes) panel::cp_async_elem(dst + c, src + c);
  }
}

// Where row r of a sample's k x k matrix starts, from the sample's start:
// r k in the square layout; in the slab layout (k a multiple of 8), block
// j = r / 8 starts at 32 j (j + 1) and its rows are 8 (j + 1) wide, so row r
// at 8 (j + 1) (r - 4 j).
__device__ __forceinline__ size_t row_offset(int r, int k, bool slab) {
  const int j = r >> 3;
  return slab ? static_cast<size_t>(8 * (j + 1) * (r - 4 * j)) : static_cast<size_t>(r) * k;
}

// Elements of one sample's slabs.
__host__ __device__ constexpr long long slab_width(int k) {
  return 32LL * (k / 8) * (k / 8 + 1);
}

// One warp pass over RP = 32 / Q rows of G, Q = KP / V chunks of V
// elements a row: lane l takes row r0 + l / Q and its chunk l % Q, and
// copies the part of it on or below the diagonal (the lower triangle) into
// row r of A (row stride LD) by cp.async: one 16-byte copy where the row
// starts 16-byte aligned in device memory, element copies otherwise.  Where
// a row has more than 32 chunks (double at KP=128, kChol only) a pass is
// the one row r0, lane l taking its chunks l, l + 32, ...  Gn is the
// sample's G, square or (slab) in slabs.
template <typename T, int KP, int LD>
__device__ __forceinline__ void stage_rows(T* A, const T* Gn, int r0, int k, int lane,
                                           bool slab = false) {
  constexpr int V = 16 / static_cast<int>(sizeof(T)), Q = KP / V;
  if constexpr (Q <= 32) {
    static_assert(32 % Q == 0, "a warp pass covers whole rows");
    const int r = r0 + lane / Q, c = (lane % Q) * V;
    if (r >= k || c > r) return;
    const T* src = Gn + row_offset(r, k, slab);
    T* dst = A + r * LD;
    if ((reinterpret_cast<size_t>(src) & 15) == 0) {
      panel::cp_async16(dst + c, src + c, cmin(V, k - c) * static_cast<int>(sizeof(T)));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (c + e <= r) panel::cp_async_elem(dst + c + e, src + c + e);
    }
  } else {
    static_assert(Q % 32 == 0, "a warp pass covers one row");
    const int r = r0;
    if (r >= k) return;
    const T* src = Gn + row_offset(r, k, slab);
    T* dst = A + r * LD;
    const bool vec = (reinterpret_cast<size_t>(src) & 15) == 0;
#pragma unroll
    for (int h = 0; h < Q / 32; ++h) {
      const int c = (lane + 32 * h) * V;
      if (c > r) break;
      if (vec) {
        panel::cp_async16(dst + c, src + c, cmin(V, k - c) * static_cast<int>(sizeof(T)));
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (c + e <= r) panel::cp_async_elem(dst + c + e, src + c + e);
      }
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store_stream(float* p, const float (&o)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
}
__device__ __forceinline__ void store_stream(double* p, const double (&o)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(o[0], o[1]));
}

// The V = 16 / sizeof(T) elements of an output row from column c0 on, of
// which those below ncols are written: one 16-byte streaming store where
// the row is aligned and all V are written, element stores otherwise.
template <typename T, int V>
__device__ __forceinline__ void write_chunk(T* row, int c0, int ncols, bool vec, const T (&o)[V]) {
  if (vec && c0 + V <= ncols) {
    store_stream(row + c0, o);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (c0 + e < ncols) __stcs(row + c0 + e, o[e]);
  }
}

// kChol's rows of L out (Ln the sample's k x k output), on the lanes and
// chunks of stage_rows' warp pass from row r0, so that each lane may stage
// the next sample's chunks in place of those it has just written: on and
// below the diagonal A + poison (from_a) or poison alone, zeros above it;
// nothing at rows or columns k and beyond.
template <typename T, int KP, int LD>
__device__ __forceinline__ void chol_rows_out(T* Ln, const T* A, int r0, int k, int lane,
                                              T poison, bool from_a) {
  constexpr int V = 16 / static_cast<int>(sizeof(T)), Q = KP / V, QW = Q < 32 ? Q : 32;
  const int r = r0 + lane / QW;
  if (r >= k) return;
  T* row = Ln + static_cast<size_t>(r) * k;
  const bool vec = (reinterpret_cast<size_t>(row) & 15) == 0;
#pragma unroll
  for (int h = 0; h < Q / QW; ++h) {
    const int c0 = (lane % QW + QW * h) * V;
    if (c0 >= k) break;
    T o[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      o[e] = c0 + e <= r ? (from_a ? A[r * LD + c0 + e] : T(0)) + poison : T(0);
    write_chunk<T, V>(row, c0, k, vec, o);
  }
}

// ---------------------------------------------------------------------------
// KP in {8, 16}: one diagonal block a sample, KP lanes a sample.

constexpr int kSmallThreads = 128;

template <typename T, int KP, int WANT>
__global__ void __launch_bounds__(kSmallThreads)
spd_estep_small_kernel(const T* __restrict__ sigma, long long sigma_stride,
                       const T* __restrict__ G, const T* __restrict__ b,
                       const T* __restrict__ rnorm, const T* __restrict__ d_obs,
                       T* __restrict__ s_out, T* __restrict__ m_out,
                       T* __restrict__ llk_out, T* __restrict__ sq_out, long long B, int k) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int Q = KP / V;                      // chunks of V elements a row
  constexpr int PER_BLOCK = kSmallThreads / KP;  // samples a block
  constexpr int LDS = KP + 4;                    // staged row stride
  constexpr bool kInverse = is_inverse(WANT);
  constexpr bool kSecond = WANT == kFullT || WANT == kFull;
  __shared__ __align__(16) T stage[PER_BLOCK][KP][LDS];
  __shared__ __align__(16) T svec[PER_BLOCK][KP];  // s, for full's rows

  const int slot = threadIdx.x / KP;
  const int r = threadIdx.x % KP;
  const long long n = static_cast<long long>(blockIdx.x) * PER_BLOCK + slot;
  const bool live = n < B;
  const size_t kk = static_cast<size_t>(k) * k;
  T (*S)[LDS] = stage[slot];
  // G's lower triangle in: in float a chunk a lane, neighbouring lanes on
  // neighbouring chunks of a row (lane r takes chunk r % Q of rows V i +
  // r / Q; a row a lane leaves each access's sectors half used); in double a
  // row a lane (the chunks put local-memory accesses into KP=8's fullt,
  // states and llk).
  if constexpr (sizeof(T) == 4) {
    if (live) {
#pragma unroll
      for (int i = 0; i < Q; ++i) stage_rows<T, KP, LDS>(&S[0][0], G + n * kk, V * i, k, r);
    }
  } else {
    if (live && r < k) stage_row(&S[r][0], G + n * kk + static_cast<size_t>(r) * k, r + 1, k, 0, 1);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  if constexpr (WANT == kChol) {
    // row r of M's lower triangle, zeros above it, the identity past k
    T a[KP];
#pragma unroll
    for (int c = 0; c < KP; ++c)
      a[c] = c > r ? T(0) : live && r < k ? S[r][c] : c == r ? T(1) : T(0);
    // the column step: d = A[j][j]; column j becomes A[:,j] / sqrt(d) at
    // rows >= j (0 above), and each row i takes -L[i][j] L[l][j] at l > j
    // (what a row keeps right of its diagonal is zeroed at that column's step)
    T piv = T(1);
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const T d = __shfl_sync(kAll, a[j], j, KP);
      const T u = r >= j ? a[j] * rsqrt_t(d) : T(0);
      a[j] = u;
#pragma unroll
      for (int l = j + 1; l < KP; ++l) a[l] = fma(-u, __shfl_sync(kAll, u, l, KP), a[l]);
      piv = r == j ? d : piv;
    }
    T logdet = r < k ? log_t(piv) : T(0);
#pragma unroll
    for (int off = KP / 2; off > 0; off >>= 1) logdet += __shfl_xor_sync(kAll, logdet, off, KP);
    if (!live) return;  // the segment's lanes share their sample
    // A pivot <= 0 (M not positive definite) or NaN: NaN on and below the diagonal.
    const T poison = isfinite(logdet) ? T(0) : nan_like(logdet);
    // lane r puts row r in its staging row (it read that row alone); the
    // segment writes the rows a chunk a lane, as full's
    const unsigned seg = ((1u << KP) - 1u) << (threadIdx.x & 31 & ~(KP - 1));
#pragma unroll
    for (int c = 0; c < KP; ++c) S[r][c] = c <= r ? a[c] + poison : T(0);
    __syncwarp(seg);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int row = V * i + r / Q, c0 = (r % Q) * V;
      if (row < k) {
        T o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = S[row][c0 + e];
        T* dst = m_out + n * kk + static_cast<size_t>(row) * k;
        write_chunk<T, V>(dst, c0, k, (reinterpret_cast<size_t>(dst) & 15) == 0, o);
      }
    }
    return;
  }

  const T sig = live ? sigma[n * sigma_stride] : T(1);
  const T s2 = sig * sig;
  // row r of M = sigma^2 I + G from its lower triangle, the identity past k
  T a[KP];
#pragma unroll
  for (int c = 0; c < KP; ++c) {
    const bool in = live && r < k && c < k;
    a[c] = in ? (c <= r ? S[r][c] : S[c][r]) : T(0);
    if (c == r) a[c] += in ? s2 : T(1);
  }
  T x = live && r < k ? b[n * k + r] : T(0);
  T piv = T(1), z = T(0);
  gj_sweep<T, KP>(a, x, r, piv, z);

  // log det M, |L^{-1} b|^2 and tr M^{-1} over the segment's first k lanes
  T logdet = r < k ? log_t(piv) : T(0);
  T quad = z * z;
  T tr = T(0);
#pragma unroll
  for (int c = 0; c < KP; ++c)
    if (c == r && r < k) tr = -a[c];
#pragma unroll
  for (int off = KP / 2; off > 0; off >>= 1) {
    logdet += __shfl_xor_sync(kAll, logdet, off, KP);
    quad += __shfl_xor_sync(kAll, quad, off, KP);
    tr += __shfl_xor_sync(kAll, tr, off, KP);
  }
  T sc[KP];  // s, for fullt's rows
  if constexpr (WANT == kFullT) {
#pragma unroll
    for (int c = 0; c < KP; ++c) sc[c] = __shfl_sync(kAll, x, c, KP);
  }
  if (!live) return;  // the segment's lanes share their sample
  // A pivot <= 0 (M not positive definite) or NaN: the whole sample is NaN.
  const T poison = isfinite(logdet) ? T(0) : nan_like(logdet);
  if (r == 0) {
    const T dob = d_obs[n];
    __stcs(llk_out + n, T(-0.5) * ((rnorm[n] - quad) / s2 + logdet + log_t(s2) * (dob - T(k)) +
                                   T(kLn2Pi) * dob) + poison);
    if (kInverse) __stcs(sq_out + n, s2 * (T(k) - s2 * tr) + poison);
  }
  if (WANT == kLlk) return;
  if (r < k) __stcs(s_out + n * k + r, x + poison);
  if (WANT == kStates) return;

  // Out: SM = s s^T + sigma^2 M^{-1} (fullt: on and below the diagonal) or
  // Sigma = sigma^2 M^{-1}.  fullt: lane r writes its row's chunks, s from
  // the segment by shuffles.  full, infer: lane r puts row r in its staging
  // row (full's s from shared memory), and the segment writes the rows a
  // chunk a lane, neighbouring lanes on neighbouring chunks.  (On an H100
  // the chunks are faster for whole rows and slower for fullt's triangle;
  // s from shared memory faster for full and slower for fullt.)
  if constexpr (WANT == kFullT) {
    if (r >= k) return;
    T* row = m_out + n * kk + static_cast<size_t>(r) * k;
    const bool vec = (reinterpret_cast<size_t>(row) & 15) == 0;
#pragma unroll
    for (int c0 = 0; c0 < KP; c0 += V) {
      if (c0 > r) break;
      T o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = fma(x, sc[c0 + e], s2 * -a[c0 + e]) + poison;
      write_chunk<T, V>(row, c0, r + 1, vec, o);
    }
  } else {
    const unsigned seg = ((1u << KP) - 1u) << (threadIdx.x & 31 & ~(KP - 1));
    T* sv = svec[slot];
    if (kSecond) sv[r] = x;
    __syncwarp(seg);  // s is there, and the segment has read its staged rows
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      const T cov = s2 * -a[c];
      S[r][c] = (kSecond ? fma(x, sv[c], cov) : cov) + poison;
    }
    __syncwarp(seg);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int row = V * i + r / Q, c0 = (r % Q) * V;
      if (row < k) {
        T o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = S[row][c0 + e];
        T* dst = m_out + n * kk + static_cast<size_t>(row) * k;
        write_chunk<T, V>(dst, c0, k, (reinterpret_cast<size_t>(dst) & 15) == 0, o);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// KP in {32, 64, 128}: the blocked body, one CTA a sample.

template <typename T, int KP>
struct Blocked {
  static constexpr int NB = 16;                 // pivot block, and the product blocks' size
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static constexpr int LD = KP + 8;             // working matrix row stride
  static constexpr int LDP = NB + 4;            // staged panel row stride (spd_panel_mma.cuh)
  // warps a CTA: at KP=32 one (twice the samples in flight of two warps,
  // which registers cap: fullt 0.61 -> 0.41 ms at B=65,536 on an H100)
  static constexpr int NW = KP == 32 ? 1 : KP == 64 ? 2 : 8;
  static constexpr int THREADS = 32 * NW;
  static constexpr int MU = KP - NB;            // most active rows
  // the working matrix, then the right-hand side x in two buffers (this
  // sample's and the next one's b)
  static constexpr size_t X_OFF = static_cast<size_t>(KP) * LD * sizeof(T);
  static constexpr size_t OFF_U = X_OFF + 2 * KP * sizeof(T);
  static constexpr size_t OFF_Y = OFF_U + static_cast<size_t>(MU) * LDP * sizeof(T);
  static constexpr size_t OFF_P = OFF_Y + static_cast<size_t>(MU) * LDP * sizeof(T);
  static constexpr size_t OFF_XJ = OFF_P + static_cast<size_t>(NB) * LDP * sizeof(T);
  static constexpr size_t OFF_FLAG = OFF_XJ + NB * sizeof(T);
  static constexpr size_t BYTES = OFF_FLAG + 16;
  // CTAs a multiprocessor holds: shared memory, threads, and at least 104
  // registers a thread (168 in double): with a minimum that capped them at
  // 96, ptxas spilled in some instantiations; the launch bounds' minimum
  static constexpr int CTAS = cmin(cmin(kSmemPerSm / static_cast<int>(BYTES + kSmemReserved),
                                        2048 / THREADS),
                                   cmin(32, 65536 / (THREADS * (sizeof(T) == 4 ? 104 : 168))));
  static_assert(KP % NB == 0 && MU % 16 == 0, "blocks of 16 rows cover the tile");
  static_assert(CTAS >= 1, "one CTA fits a multiprocessor");
};

// One warp's 16 x 16 block of products: MI x NI mma tiles.
template <typename T>
struct Acc16 {
  using F = panel::Mma<T>;
  static constexpr int MI = 16 / F::M, NI = 16 / F::N;
  T c[MI][NI][F::NC];
};

// acc += (neg ? -1 : 1) a bt^T over NB = 16 columns: a the 16 x 16 block at
// `a`, bt the 16 x 16 block at `bt`, both staged with row stride LDP, split
// into TF32 hi/lo as their fragments are loaded (float).  (Keeping U and Y
// split in shared memory instead measured no faster at KP=128 and slower at
// KP=64, where it costs CTAs a multiprocessor.)
template <typename T, int LDP>
__device__ __forceinline__ void product16(Acc16<T>& acc, const T* a, const T* bt, bool neg) {
  using F = panel::Mma<T>;
  constexpr int MI = Acc16<T>::MI, NI = Acc16<T>::NI;
#pragma unroll
  for (int k0 = 0; k0 < 16; k0 += F::K) {
    typename F::A fa[MI];
    typename F::B fb[NI];
#pragma unroll
    for (int i = 0; i < MI; ++i) panel::load_a(fa[i], a + i * F::M * LDP + k0, LDP, neg);
#pragma unroll
    for (int j = 0; j < NI; ++j) panel::load_b(fb[j], bt + j * F::N * LDP + k0, LDP);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) panel::mma(acc.c[i][j], fa[i], fb[j]);
  }
}

// A lane's log pivot and z_r^2 from one pivot block.
template <typename T>
struct PivotOut {
  T logpiv, z2;
};

// (1) of a step, by one warp: the pivot block at J0 of the working matrix A
// (row stride LD) inverted in registers, lanes r and r + NB its row r, a
// half each (gj_sweep_halves): P = S^{-1} (row stride LDP), x_J <- P x_J
// (the old x_J kept in xJ), and for the inverse variants block J <- -P.
// Not inlined: the kernel around it keeps fewer registers live.
template <typename T, int NB, int LD, int LDP, bool kInverse>
__device__ __noinline__ PivotOut<T> pivot_block(T* A, T* x, T* P, T* xJ, int J0) {
  constexpr int HB = NB / 2;
  const int lane = threadIdx.x & 31;
  const int r = lane % NB, h = lane / NB;
  T* Sb = A + J0 * LD + J0;
  T a[HB];
#pragma unroll
  for (int e = 0; e < HB; ++e) {
    const int c = HB * h + e;
    a[e] = c <= r ? Sb[r * LD + c] : Sb[c * LD + r];
  }
  const T x0 = x[J0 + r];
  T xv = x0, piv = T(1), z = T(0);
  gj_sweep_halves<T, NB>(a, xv, r, h, piv, z);
  __syncwarp();
  if (h == 0) {
    xJ[r] = x0;
    x[J0 + r] = xv;
  }
#pragma unroll
  for (int e = 0; e < HB; ++e) {
    const int c = HB * h + e;
    P[r * LDP + c] = -a[e];
    if (kInverse && c <= r) Sb[r * LD + c] = a[e];
  }
  return {log_t(piv), z * z};
}

// kChol's (1), by one warp: the pivot block S at J0 of the working matrix A
// (row stride LD) factored as L11 L11^T in registers, lane r and r + NB row
// r (the same work, so that every shuffle reads a lane of the first half):
// the column step, one reciprocal square root a pivot.  L11 goes into block
// J on and below the diagonal, L11^{-1} into P (row stride LDP, zeros above
// the diagonal; lane c forms column c by forward substitution on e_c, lanes
// c and c + NB a half of its rows each).  Returns lane r's log pivot.
// Inlined at KP=32 and not above (chol_pivot_call): on an H100, inlined,
// k=64 and 128 ran 3-8% slower; at KP=32, not inlined, the kernel spilled.
template <typename T, int NB, int LD, int LDP>
__device__ __forceinline__ T chol_pivot_block(T* A, T* P, int J0) {
  static_assert(2 * NB == 32, "two lanes a row fill one warp");
  const int lane = threadIdx.x & 31;
  const int r = lane % NB, h = lane / NB;
  T* Sb = A + J0 * LD + J0;
  T a[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) a[c] = c <= r ? Sb[r * LD + c] : T(0);
  T piv = T(1), rs_own = T(1);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const T d = __shfl_sync(kAll, a[c], c);
    const T rs = rsqrt_t(d);
    const T u = r >= c ? a[c] * rs : T(0);
    a[c] = u;
#pragma unroll
    for (int l = c + 1; l < NB; ++l) a[l] = fma(-u, __shfl_sync(kAll, u, l), a[l]);
    piv = r == c ? d : piv;
    rs_own = r == c ? rs : rs_own;
  }
#pragma unroll
  for (int c = 0; c < NB; ++c)
    if (c / (NB / 2) == h && c <= r) Sb[r * LD + c] = a[c];
  __syncwarp();
  T xc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) xc[i] = i == r ? T(1) : T(0);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    xc[i] *= __shfl_sync(kAll, rs_own, i);
#pragma unroll
    for (int l = i + 1; l < NB; ++l) xc[l] = fma(-Sb[l * LD + i], xc[i], xc[l]);
  }
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (i / (NB / 2) == h) P[i * LDP + r] = xc[i];
  return log_t(piv);
}

template <typename T, int NB, int LD, int LDP>
__device__ __noinline__ T chol_pivot_call(T* A, T* P, int J0) {
  return chol_pivot_block<T, NB, LD, LDP>(A, P, J0);
}

// kChol after step J's (1): block J's rows of L are final.  They go out
// (Ln the sample's output) and the next sample's rows (Gx, null if none) are
// staged in their place, each lane the chunks it has just written.  At the
// last step the sample's poison is known (flag): a failed sample's earlier
// rows go out again, NaN, on the same lanes.
template <typename T, int KP>
__device__ __forceinline__ void chol_block_out(T* Ln, T* A, const T* Gx, const T* flag, int J0, int k) {
  using S = Blocked<T, KP>;
  constexpr int NB = S::NB, LD = S::LD, NW = S::NW, Q = KP / S::V, RP = Q < 32 ? 32 / Q : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T poison = J0 == KP - NB ? *flag : T(0);
  if (isnan(poison)) {
    for (int I0 = 0; I0 < J0; I0 += NB)
      for (int r0 = I0 + warp * RP; r0 < I0 + NB && r0 < k; r0 += NW * RP)
        chol_rows_out<T, KP, LD>(Ln, A, r0, k, lane, poison, false);
  }
  for (int r0 = J0 + warp * RP; r0 < J0 + NB && r0 < k; r0 += NW * RP) {
    chol_rows_out<T, KP, LD>(Ln, A, r0, k, lane, poison, true);
    if (Gx != nullptr) stage_rows<T, KP, LD>(A, Gx, r0, k, lane);
  }
}

template <typename T, int KP, int WANT, bool SLAB>
__global__ void __launch_bounds__(Blocked<T, KP>::THREADS, Blocked<T, KP>::CTAS)
spd_estep_tile_kernel(const T* __restrict__ sigma, long long sigma_stride,
                      const T* __restrict__ G, const T* __restrict__ b,
                      const T* __restrict__ rnorm, const T* __restrict__ d_obs,
                      T* __restrict__ s_out, T* __restrict__ m_out,
                      T* __restrict__ llk_out, T* __restrict__ sq_out, long long B, int k) {
  static_assert(!(SLAB && WANT == kChol), "kChol takes square M");
  constexpr bool slab = SLAB;
  using S = Blocked<T, KP>;
  using F = panel::Mma<T>;
  constexpr int NB = S::NB, LD = S::LD, LDP = S::LDP, NW = S::NW, V = S::V;
  // chunks a row, rows a warp pass (stage_rows; one row from 32 chunks on)
  constexpr int Q = KP / V, RP = Q < 32 ? 32 / Q : 1;
  constexpr int MI = Acc16<T>::MI, NI = Acc16<T>::NI;
  constexpr int H = F::NC == 4 ? 2 : 1;  // rows of an mma tile a lane holds
  constexpr bool kInverse = is_inverse(WANT);
  constexpr bool kSecond = WANT == kFullT || WANT == kFull;
  // block column J keeps Y (kChol: L21)
  constexpr bool kPanelOut = kInverse || WANT == kStates || WANT == kChol;

  extern __shared__ __align__(16) unsigned char smem[];
  T* A = reinterpret_cast<T*>(smem);
  T* xb = reinterpret_cast<T*>(smem + S::X_OFF);
  T* U = reinterpret_cast<T*>(smem + S::OFF_U);
  T* Y = reinterpret_cast<T*>(smem + S::OFF_Y);
  T* P = reinterpret_cast<T*>(smem + S::OFF_P);
  T* xJ = reinterpret_cast<T*>(smem + S::OFF_XJ);
  T* flag = reinterpret_cast<T*>(smem + S::OFF_FLAG);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane / 4, tq = lane & 3;
  const size_t kk = static_cast<size_t>(k) * k;
  // elements of a sample's G, and of fullt's SM, which takes G's layout
  const size_t gk = slab ? static_cast<size_t>(slab_width(k)) : kk;
  const size_t mk = WANT == kFullT ? gk : kk;

  // Step J0's active rows, in compressed order: `above` rows stored as
  // columns (the inverse variants' rows above block J), then the rest;
  // compressed row ci >= above is real row ci + base.
  struct Step {
    int above, m, base;
  };
  auto step_at = [&](int J0) {
    Step s;
    s.above = kInverse ? J0 : 0;
    s.m = kInverse ? KP - NB : KP - J0 - NB;
    s.base = kInverse ? NB : J0 + NB;
    return s;
  };
  auto real = [](const Step& s, int c0) { return c0 < s.above ? c0 : c0 + s.base; };

  T logdet = T(0), quad = T(0);  // warp 0: lane r's log pivots and z_r^2

  // (3) one 16 x 16 tile (R, C) of the active lower triangle: the old values
  // first, the products, the stores
  // (elements 2h and 2h + 1 of an accumulator are neighbours in a row:
  // one 8- or 16-byte access; above the diagonal of a diagonal tile the
  // values loaded are never stored)
  using Pair = std::conditional_t<sizeof(T) == 4, float2, double2>;
  auto update_tile = [&](const Step& s, int R, int C) {
    T* tile = A + real(s, 16 * R) * LD + real(s, 16 * C);
    Acc16<T> acc;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int rr = i * F::M + F::crow(2 * h), cc = j * F::N + F::ccol(2 * h);
          const Pair v = *reinterpret_cast<const Pair*>(tile + rr * LD + cc);
          acc.c[i][j][2 * h] = v.x;
          acc.c[i][j][2 * h + 1] = v.y;
        }
    // Y U^T = U P U^T, or for kChol L21 L21^T
    product16<T, LDP>(acc, Y + 16 * R * LDP, (WANT == kChol ? Y : U) + 16 * C * LDP, true);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int rr = i * F::M + F::crow(2 * h), cc = j * F::N + F::ccol(2 * h);
          T* dst = tile + rr * LD + cc;
          const T v0 = acc.c[i][j][2 * h], v1 = acc.c[i][j][2 * h + 1];
          if (R != C || cc + 1 <= rr) {
            Pair v;
            v.x = v0;
            v.y = v1;
            *reinterpret_cast<Pair*>(dst) = v;
          } else if (cc <= rr) {
            dst[0] = v0;
          }
        }
  };

  // The next sample's G is staged by cp.async into A as soon as this
  // sample's rows are dead (a warp restages the rows it has just written
  // out; llk a pivot block's rows once the step has read them; states after
  // its back substitution), its b into the other x buffer; sigma, rnorm and
  // d_obs are read a sample ahead.  So a sample's copies from device memory
  // overlap the end of the sample before it.  (kChol: M staged as G is,
  // block J's rows restaged once they are out; nothing else read.)
  long long n = blockIdx.x;
  T sig = T(1), rn = T(0), dob = T(0);
  if constexpr (WANT != kChol) {
    sig = sigma[n * sigma_stride];
    rn = rnorm[n];
    dob = d_obs[n];
  }
  int cur = 0;
  for (int r0 = warp * RP; r0 < k; r0 += NW * RP) stage_rows<T, KP, LD>(A, G + n * gk, r0, k, lane, slab);
  if constexpr (WANT != kChol) stage_row(xb, b + n * k, k, k, tid, S::THREADS);
  cp_async_commit();
  for (; n < B; n += gridDim.x) {
    const long long next = n + gridDim.x;
    const bool more = next < B;
    const T* Gx = G + (more ? next : n) * gk;
    T* x = xb + cur * KP;
    T sig_next = T(1), rn_next = T(0), dob_next = T(0);
    if constexpr (WANT != kChol) {
      if (more) {
        sig_next = sigma[next * sigma_stride];
        rn_next = rnorm[next];
        dob_next = d_obs[next];
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (WANT != kChol) {
      if (more) stage_row(xb + (cur ^ 1) * KP, b + next * k, k, k, tid, S::THREADS);
      cp_async_commit();
    }

    // M = G + sigma^2 I, padded with an identity block; x = b, padded with 0
    // (kChol: M itself, padded)
    const T s2 = sig * sig;
    if constexpr (WANT != kChol) {
      for (int i = tid; i < KP; i += S::THREADS) {
        if (i < k) A[i * LD + i] += s2;
        else x[i] = T(0);
      }
    }
    for (int e = tid; e < (KP - k) * KP; e += S::THREADS) {
      const int i = k + e / KP, c = e % KP;
      if (c <= i) A[i * LD + c] = c == i ? T(1) : T(0);
    }
    __syncthreads();

    logdet = quad = T(0);
    for (int J0 = 0; J0 < KP; J0 += NB) {
      const Step s = step_at(J0);
      const int mt = s.m / 16;
      // (1) warp 0 inverts the pivot block (kChol: factors it) while the
      // other warps (or, alone, warp 0 after it) stage the active rows'
      // panel entries U, a 16-row block a warp
      if (warp == 0) {
        if constexpr (WANT == kChol) {
          if constexpr (KP == 32) logdet += chol_pivot_block<T, NB, LD, LDP>(A, P, J0);
          else logdet += chol_pivot_call<T, NB, LD, LDP>(A, P, J0);
          if (J0 == KP - NB) {
            // the last pivot: whether the sample factored, for every warp
            // after this step's barrier
            T ld = lane < NB ? logdet : T(0);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) ld += __shfl_xor_sync(kAll, ld, off);
            if (lane == 0) *flag = isfinite(ld) ? T(0) : nan_like(ld);
          }
        } else {
          const PivotOut<T> o = pivot_block<T, NB, LD, LDP, kInverse>(A, x, P, xJ, J0);
          logdet += o.logpiv;
          quad += o.z2;
        }
      }
      constexpr int W0 = NW > 1 ? 1 : 0;  // the first staging warp
      for (int blk = warp - W0; warp >= W0 && blk < mt; blk += NW - W0) {
        const int c0 = blk * 16;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int e = lane + 32 * q;
          if (c0 < s.above) {
            const int ci = c0 + e % 16, t = e / 16;
            U[ci * LDP + t] = A[(J0 + t) * LD + ci];
          } else {
            const int ci = c0 + e / 16, t = e % 16;
            U[ci * LDP + t] = A[(ci + s.base) * LD + J0 + t];
          }
        }
      }
      __syncthreads();
      if (WANT == kLlk && more) {
        // llk reads block J's rows no more: the next sample's go there
        for (int r0 = J0 + warp * RP; r0 < J0 + NB && r0 < k; r0 += NW * RP)
          stage_rows<T, KP, LD>(A, Gx, r0, k, lane, slab);
        cp_async_commit();
      }
      if constexpr (WANT == kChol) {
        chol_block_out<T, KP>(m_out + n * kk, A, more ? Gx : nullptr, flag, J0, k);
        cp_async_commit();
      }
      if (s.m == 0) continue;

      // (2) Y = U P^T, a 16-row block a warp (P = S^{-1}, or for kChol
      // L11^{-1}: Y = L21); x_i -= Y_i . x_J; Y stored for (3) and (inverse
      // variants, states, kChol) as block column J
      for (int blk = warp; blk < mt; blk += NW) {
        const int c0 = blk * 16;
        Acc16<T> acc;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < F::NC; ++e) acc.c[i][j][e] = T(0);
        product16<T, LDP>(acc, U + c0 * LDP, P, false);
        const bool col = c0 < s.above;  // rows stored as columns
        const int rbase = real(s, c0);
        T part[MI][H];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < H; ++h) part[i][h] = T(0);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < F::NC; ++e) {
              const int rr = i * F::M + F::crow(e), cc = j * F::N + F::ccol(e);
              const T y = acc.c[i][j][e];
              Y[(c0 + rr) * LDP + cc] = y;
              if constexpr (WANT != kChol) part[i][F::NC == 4 ? e / 2 : 0] += y * xJ[cc];
              if (kPanelOut) {
                if (col) A[(J0 + cc) * LD + c0 + rr] = y;
                else A[(rbase + rr) * LD + J0 + cc] = y;
              }
            }
        if constexpr (WANT != kChol) {
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int h = 0; h < H; ++h) {
              T sum = part[i][h];
              sum += __shfl_xor_sync(kAll, sum, 1);
              sum += __shfl_xor_sync(kAll, sum, 2);
              if (tq == 0) x[rbase + i * F::M + g + 8 * h] -= sum;
            }
        }
      }
      __syncthreads();

      // (3) A[i][l] -= Y_i . U_l over the active lower triangle, a 16 x 16
      // tile a warp, round-robin
      int p = 0;
      for (int R = 0; R < mt; ++R)
        for (int C = 0; C <= R; ++C, ++p)
          if (p % NW == warp) update_tile(s, R, C);
      __syncthreads();
    }
    if constexpr (WANT == kChol) continue;  // L is out, the next sample's rows in

    // log det M, b^T M^{-1} b and (inverse variants) tr M^{-1}: warp 0
    if (warp == 0) {
      T ld = lane < NB ? logdet : T(0);
      T q = lane < NB ? quad : T(0);
      T tr = T(0);
      if (kInverse)
        for (int i = lane; i < k; i += 32) tr -= A[i * LD + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ld += __shfl_xor_sync(kAll, ld, off);
        q += __shfl_xor_sync(kAll, q, off);
        tr += __shfl_xor_sync(kAll, tr, off);
      }
      // A pivot <= 0 (M not positive definite) or NaN: the whole sample is NaN.
      const T poison = isfinite(ld) ? T(0) : nan_like(ld);
      if (lane == 0) {
        *flag = poison;
        __stcs(llk_out + n, T(-0.5) * ((rn - q) / s2 + ld + log_t(s2) * (dob - T(k)) +
                                       T(kLn2Pi) * dob) + poison);
        if (kInverse) __stcs(sq_out + n, s2 * (T(k) - s2 * tr) + poison);
      }
    }
    sig = sig_next;
    rn = rn_next;
    dob = dob_next;
    cur ^= 1;
    if (WANT == kLlk) continue;

    if (WANT == kStates) {
      // s_J = x_J - sum over the rows i of later blocks of A[i][J] s_i,
      // the last block first; x_J already holds P_J y_J
      for (int I0 = KP - NB; I0 > 0; I0 -= NB) {
        __syncthreads();
        for (int c = tid; c < I0; c += S::THREADS) {
          T acc = T(0);
#pragma unroll
          for (int t = 0; t < NB; ++t) acc = fma(A[(I0 + t) * LD + c], x[I0 + t], acc);
          x[c] -= acc;
        }
      }
    } else if (WANT != kFullT) {
      // full, infer: the upper triangle from the lower, in 8 x 4 patches
      // (lane (a, bb): element (8 ib + bb, 4 jb + a) to its transpose)
      for (int p = warp; p < (KP / 8) * (KP / 4); p += NW) {
        const int i = (p / (KP / 4)) * 8 + lane / 4, j = (p % (KP / 4)) * 4 + (lane & 3);
        if (j < i) A[j * LD + i] = A[i * LD + j];
      }
    }
    __syncthreads();
    if (WANT == kStates && more) {
      for (int r0 = warp * RP; r0 < k; r0 += NW * RP) stage_rows<T, KP, LD>(A, Gx, r0, k, lane, slab);
      cp_async_commit();
    }
    const T poison = *flag;
    for (int i = tid; i < k; i += S::THREADS) __stcs(s_out + n * k + i, x[i] + poison);
    if (kInverse) {
      // rows of SM = s s^T + sigma^2 M^{-1} (fullt: on and below the
      // diagonal; under slabs the row's whole slab width, zeros above the
      // diagonal) or Sigma = sigma^2 M^{-1}, on stage_rows' lanes: each lane
      // writes its chunk, then stages the next sample's chunk in its place
      constexpr bool slab_out = WANT == kFullT && slab;
      for (int r0 = warp * RP; r0 < k; r0 += NW * RP) {
        const int r = r0 + lane / Q, c0 = (lane % Q) * V;
        const int ncols = WANT != kFullT ? k : slab_out ? 8 * ((r >> 3) + 1) : r + 1;
        if (r < k && c0 < ncols) {
          T* row = m_out + n * mk + row_offset(r, k, slab_out);
          const T si = x[r];
          T o[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const T cov = s2 * -A[r * LD + c0 + e];
            o[e] = (kSecond ? fma(si, x[c0 + e], cov) : cov) + poison;
            if (slab_out && c0 + e > r) o[e] = T(0);
          }
          write_chunk<T, V>(row, c0, ncols, (reinterpret_cast<size_t>(row) & 15) == 0, o);
        }
        if (more) stage_rows<T, KP, LD>(A, Gx, r0, k, lane, slab);
      }
      cp_async_commit();
    }
  }
}

// CTAs a multiprocessor of the current device holds for one instantiation of
// the blocked body, with its dynamic shared memory limit raised (above the
// default 48 KB) once per instantiation and device.
template <typename T, int KP, int WANT, bool SLAB = false>
cudaError_t blocked_slots(int& per_sm, int& sms) {
  using S = Blocked<T, KP>;
  static int cached_per_sm[kMaxDevices] = {};
  static int cached_sms[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached_per_sm[device] == 0) {
    err = cudaFuncSetAttribute(spd_estep_tile_kernel<T, KP, WANT, SLAB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(S::BYTES));
    if (err != cudaSuccess) return err;
    int blocks = 0, count = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, spd_estep_tile_kernel<T, KP, WANT, SLAB>, S::THREADS, S::BYTES);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cached_sms[device] = count;
    cached_per_sm[device] = blocks;
  }
  per_sm = cached_per_sm[device];
  sms = cached_sms[device];
  return cudaSuccess;
}

template <typename T, int KP, int WANT, bool SLAB>
cudaError_t launch_blocked(const T* sigma, long long sigma_stride, const T* G, const T* b,
                           const T* rnorm, const T* d_obs, T* s, T* m, T* llk, T* sq, long long B,
                           int k, cudaStream_t stream) {
  using S = Blocked<T, KP>;
  int per_sm = 0, sms = 0;
  const cudaError_t err = blocked_slots<T, KP, WANT, SLAB>(per_sm, sms);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(B < slots ? B : slots);
  spd_estep_tile_kernel<T, KP, WANT, SLAB><<<grid, S::THREADS, S::BYTES, stream>>>(
      sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k);
  return cudaGetLastError();
}

template <typename T, int KP, int WANT>
cudaError_t launch_tile(const T* sigma, long long sigma_stride, const T* G, const T* b,
                        const T* rnorm, const T* d_obs, T* s, T* m, T* llk, T* sq, long long B,
                        int k, bool slab, cudaStream_t stream) {
  if constexpr (KP <= 16 || WANT == kChol) {
    if (slab) return cudaErrorInvalidValue;  // square matrices only
  }
  if constexpr (KP <= 16) {
    constexpr int per_block = kSmallThreads / KP;
    const long long blocks = (B + per_block - 1) / per_block;
    spd_estep_small_kernel<T, KP, WANT><<<static_cast<unsigned>(blocks), kSmallThreads, 0, stream>>>(
        sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k);
    return cudaGetLastError();
  } else if constexpr (WANT == kChol) {
    return launch_blocked<T, KP, WANT, false>(sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk,
                                              sq, B, k, stream);
  } else {
    return slab ? launch_blocked<T, KP, WANT, true>(sigma, sigma_stride, G, b, rnorm, d_obs, s, m,
                                                   llk, sq, B, k, stream)
                : launch_blocked<T, KP, WANT, false>(sigma, sigma_stride, G, b, rnorm, d_obs, s,
                                                    m, llk, sq, B, k, stream);
  }
}

template <typename T, int KP>
cudaError_t launch_tile_want(int want, const T* sigma, long long sigma_stride, const T* G,
                             const T* b, const T* rnorm, const T* d_obs, T* s, T* m, T* llk,
                             T* sq, long long B, int k, bool slab, cudaStream_t stream) {
#define PPCA_TILE_CASE(W) \
  case W:                 \
    return launch_tile<T, KP, W>(sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, slab, stream);
  switch (want) {
    PPCA_TILE_CASE(kFullT)
    PPCA_TILE_CASE(kStates)
    PPCA_TILE_CASE(kLlk)
    PPCA_TILE_CASE(kInfer)
    PPCA_TILE_CASE(kFull)
    PPCA_TILE_CASE(kChol)
    default:
      return cudaErrorInvalidValue;
  }
#undef PPCA_TILE_CASE
}

// The tile design for 1 <= k <= estep_tile_max_k<T>() (want kChol: k <=
// chol_tile_max_k<T>()), on the smallest padded size that holds k.
// Arguments as spd_estep.cu's entry points take them (slab: G in slabs,
// and fullt's SM, for k a multiple of 8 above 16, the E-step variants; the
// one-block body and kChol refuse it in launch_tile); for kChol M is G and L
// is m, the rest null.
template <typename T>
cudaError_t spd_estep_tile(int want, const void* sigma, long long sigma_stride, const void* G,
                           const void* b, const void* rnorm, const void* d_obs, void* s,
                           void* m, void* llk, void* sq, long long B, int k, bool slab,
                           cudaStream_t stream) {
  if (slab && k % 8 != 0) return cudaErrorInvalidValue;
  const T* sg = static_cast<const T*>(sigma);
  const T* g = static_cast<const T*>(G);
  const T* bb = static_cast<const T*>(b);
  const T* rn = static_cast<const T*>(rnorm);
  const T* dob = static_cast<const T*>(d_obs);
  T* so = static_cast<T*>(s);
  T* mo = static_cast<T*>(m);
  T* lo = static_cast<T*>(llk);
  T* qo = static_cast<T*>(sq);
  if (k <= 8) return launch_tile_want<T, 8>(want, sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, slab, stream);
  if (k <= 16) return launch_tile_want<T, 16>(want, sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, slab, stream);
  if (k <= 32) return launch_tile_want<T, 32>(want, sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, slab, stream);
  if (k <= 64) return launch_tile_want<T, 64>(want, sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, slab, stream);
  if constexpr (estep_tile_max_k<T>() > 64) {
    if (k <= estep_tile_max_k<T>()) return launch_tile_want<T, 128>(want, sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, slab, stream);
  } else {
    // double: KP=128 serves kChol alone
    if (want == kChol && k <= chol_tile_max_k<T>())
      return launch_tile<T, 128, kChol>(sg, sigma_stride, g, bb, rn, dob, so, mo, lo, qo, B, k, false, stream);
  }
  return cudaErrorInvalidValue;
}

// The residency of the tile's variant W at state size k on the current
// device: CTAs a multiprocessor holds, warps a CTA, samples a CTA works on
// at once (the blocked body's persistent grid; the small body's blocks from
// their shared memory and threads).
template <typename T, int W>
cudaError_t tile_occupancy(int k, int& ctas_per_sm, int& warps, int& samples) {
  auto small = [&](auto kernel, int kp) {
    warps = kSmallThreads / 32;
    samples = kSmallThreads / kp;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, kernel, kSmallThreads, 0);
  };
  auto blocked = [&](auto tag) -> cudaError_t {
    constexpr int KP = decltype(tag)::value;
    int sms = 0;
    warps = Blocked<T, KP>::NW;
    samples = 1;
    return blocked_slots<T, KP, W>(ctas_per_sm, sms);
  };
  constexpr int kMaxK = W == kChol ? chol_tile_max_k<T>() : estep_tile_max_k<T>();
  if (k < 1) return cudaErrorInvalidValue;
  if (k <= 8) return small(spd_estep_small_kernel<T, 8, W>, 8);
  if (k <= 16) return small(spd_estep_small_kernel<T, 16, W>, 16);
  if (k <= 32) return blocked(std::integral_constant<int, 32>{});
  if (k <= 64) return blocked(std::integral_constant<int, 64>{});
  if constexpr (kMaxK > 64) {
    if (k <= kMaxK) return blocked(std::integral_constant<int, 128>{});
  }
  return cudaErrorInvalidValue;
}

// The E-step's residency (measured for fullt) or, chol true, spd_chol's.
template <typename T>
cudaError_t estep_tile_occupancy(int k, bool chol, int& ctas_per_sm, int& warps, int& samples) {
  return chol ? tile_occupancy<T, kChol>(k, ctas_per_sm, warps, samples)
              : tile_occupancy<T, kFullT>(k, ctas_per_sm, warps, samples);
}

}  // namespace tile
}  // namespace ppca
