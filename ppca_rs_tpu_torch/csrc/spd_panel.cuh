// Panel design of the batched SPD E-step and Cholesky factor (sm_90a), for
// every k above the tile design's limits (estep_tile_max_k<T>(),
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
// ~6 k^2 for the others (SM, Sigma or L written whole).  Nearly all of the
// FMAs are in the products of each panel step, which run on the tensor
// cores: in float32 as 3xTF32 (three TF32 products, 495/3 = 165 TFLOP/s
// at the published peak), in float64 on FP64 MMA (67 TFLOP/s).  At those
// rates bytes would bound every variant up to k ~ 300 in float32.  What
// bounds the design on an H100 (PERF.md) is neither: it is the chain of
// each step (staging, barriers, the pivot block where the look-ahead cannot
// hide it) and the TF32 split made at each fragment load; the trailing
// triangle's reads and writes through the L2 cache cost a few percent.
//
// The design:
// * One CTA of 256 threads serves one sample at a time; a persistent grid
//   of kCtasPerSm = 2 CTAs a multiprocessor walks the batch (the launch
//   bounds' minimum: 128 registers a thread).  Each CTA takes up to 90 KB
//   of dynamic shared memory for the staged panel and ~18 KB of static, so
//   two fit a multiprocessor.
// * The working matrix lives in device memory, row-major with leading
//   dimension k, lower triangle only: in the variant's own k x k output
//   where there is one (SM for fullt/full, Sigma for infer, L for chol),
//   else in a (B, k+1, k) scratch the wrapper allocates (llk, states; its
//   last row holds the right-hand side).  The kernel allocates nothing.
// * Panel steps of NB columns (32 in float, 16 in double), the last one
//   ragged.  Step J, pivot block S = A[J][J], m active rows:
//   (a) one warp factors S = L11 L11^T in registers (lane r holds row r:
//       the column step with shuffles, as spd_estep_tile.cuh's kChol) and
//       inverts L11 into shared memory, with its transpose (lane c holds
//       column c);
//       where step J - 1's (c) has kAheadTiles tiles or more, it does so
//       during that (c), once it has updated the tile that holds S
//       (look-ahead), else after step J - 1;
//       log det S adds to log det M; the right-hand side's block x_J
//       becomes z = L11^{-1} x_J (|z|^2 adds to b^T M^{-1} b); for the
//       inverse variants the whole CTA then forms P = S^{-1} = L11^{-T}
//       L11^{-1};
//   (b) the active rows' panel entries U (m x NB, zero past nb) are staged
//       into shared memory by cp.async, once, and become V = U L11^{-T}
//       there: each warp multiplies 32-row blocks on the tensor cores;
//       x_i -= V_i . z; chol and states write V back (block column J
//       keeps L; chol writes L11 too, states L11^{-1} for its back
//       substitution), llk keeps V in shared memory only;
//   (c) the active lower triangle takes A[i][l] -= V_i . V_l: each warp owns
//       32 x 32 output tiles, loads a tile's old values into its
//       accumulators (loads first, stores last: a store through a generic
//       pointer ahead of a later load makes it wait), multiplies both
//       operands out of the one staged V, and writes the tile back; no
//       block barrier between tiles; with the look-ahead warp 0 takes only
//       the tile of the next pivot block and then factors it, the other
//       tiles go round-robin to the other seven warps;
//   (d) the inverse variants then write A[i][J] = V_i L11^{-1} = U_i P,
//       again from the staged V, and A[J][J] = -P.
//   The factor variants keep the rows below block J active: that is the
//   right-looking blocked Cholesky, and block column J keeps L.  The
//   inverse variants keep every row but block J's active: that is the
//   blocked symmetric Gauss-Jordan sweep (the register tile's algorithm, NB
//   columns at a time), which leaves -M^{-1} in the lower triangle and
//   s = M^{-1} b in the right-hand side, in k^3/2 FMAs, the cost of potrf +
//   trtri + lauum.  Rows above block J are stored as columns (A[i][J] =
//   A[J][i] for i < J), and are staged transposed.
// * Where V does not fit (more than 2 CH active rows: k above 672 in
//   float, 592 in double), it is staged in chunks of CH rows: (b) and (d)
//   chunk by chunk through device memory, (c) chunk pair by chunk pair
//   through two buffers.  This keeps any k.
// * Per step: two block barriers in (b), one at the end, and one more after
//   the pivot block without the look-ahead; in chunks two more a chunk.
// * Outputs: states back-substitutes L^T s = y by blocks, one product with
//   L11^{-1} a block; fullt writes SM = s s^T + sigma^2 M^{-1} on and below
//   the diagonal only (in place: the working matrix is SM's lower
//   triangle), full and infer write SM or Sigma whole, the 32 x 32 tiles of
//   the lower triangle and their transposes through shared memory (as many
//   of a tile row at once as the panel's buffer holds) so that both stores
//   are coalesced; chol writes zeros above the diagonal.
// * A pivot <= 0 or NaN (M not positive definite) sets a flag, and every
//   output element of that sample is written NaN (chol: on and below the
//   diagonal).  Nothing reduces across samples.
// * Offsets are size_t; k and the batch have no limit but memory.

#pragma once

#include <cuda_runtime.h>

#include "spd_common.cuh"
#include "spd_panel_mma.cuh"

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
constexpr int kIo = 8;  // elements a thread has in flight in the last write
// The next pivot block is factored during a step's trailing update when the
// update has at least this many tiles to hide it behind; with fewer, the
// look-ahead made small steps slower on an H100 (float64 llk at k=96 by
// 13%; PERF.md) and the block is factored after the step.
constexpr int kAheadTiles = 8;
constexpr double kLn2Pi = 1.8378770664093453;

template <typename T>
struct Shape {
  static constexpr int NB = sizeof(T) == 4 ? 32 : 16;  // panel width
  static constexpr int LDP = NB + 4;                   // staged row stride (see spd_panel_mma.cuh)
  static constexpr int MT = 32;                        // output tile of (c), rows a warp block
  static constexpr int V = 16 / sizeof(T);             // elements of a 16-byte copy
  static constexpr int OT = 32;                        // output tile of the final write
  // rows of a chunk where the whole panel does not fit: two chunks take
  // 2 CH LDP elements, 92 KB in float and 90 KB in double
  static constexpr int CH = sizeof(T) == 4 ? 320 : 288;
};

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// The staging plan of a launch at state size k: rows of one buffer, and
// whether the panel goes in chunks (two buffers) because the largest
// active row count, k - NB, exceeds 2 CH.
template <typename T>
struct Plan {
  int rows;
  bool chunked;
  __host__ __device__ explicit Plan(int k) {
    const int m = k > Shape<T>::NB ? k - Shape<T>::NB : 0;
    chunked = m > 2 * Shape<T>::CH;
    rows = chunked ? Shape<T>::CH : round_up(m, Shape<T>::MT);
  }
  // dynamic shared memory: the buffers, or the final write's tile
  __host__ __device__ size_t bytes() const {
    const size_t panel = static_cast<size_t>(chunked ? 2 : 1) * rows * Shape<T>::LDP;
    const size_t tile = static_cast<size_t>(Shape<T>::OT) * (Shape<T>::OT + 1);
    return (panel > tile ? panel : tile) * sizeof(T);
  }
};

template <typename T>
struct alignas(16) Smem {
  T l[Shape<T>::NB][Shape<T>::NB + 1];      // L11, pivot_block's own
  T linv[Shape<T>::NB][Shape<T>::LDP];      // L11^{-1}, read in (a) and (b)
  // L11^{-T} by step parity: (d) of step J reads its own while the pivot
  // block of step J + 1 is factored
  T linvt[2][Shape<T>::NB][Shape<T>::LDP];
  T dinv[Shape<T>::NB];                    // 1 / L11[c][c]
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
  // compressed rows below this one are stored as columns (inverse variants)
  __device__ int column_rows() const { return inverse ? J0 : 0; }
};

// The step at column J0 of the sweep at state size k (nb = 0 past the last).
template <typename T>
__device__ Active step(int J0, int k, bool inverse) {
  Active a;
  a.J0 = J0;
  a.k = k;
  a.inverse = inverse;
  a.nb = J0 < k ? min(Shape<T>::NB, k - J0) : 0;
  a.m = a.nb == 0 ? 0 : inverse ? k - a.nb : k - J0 - a.nb;
  return a;
}

// (a): warp 0 factors the pivot block, inverts L11 into s.linv and
// s.linvt[par] and turns x_J into z = L11^{-1} x_J (s.z); x_J becomes
// L11^{-T} z = P x_J (inverse variants) or z (factor variants).  P itself is formed by the
// whole CTA (pivot_inverse).  Rows past nb are padded with the identity, so
// L11^{-1} is the identity there and zero beside it.  Not inlined: one copy
// of its code serves its call sites (the first block, ahead inside
// panel_step, after a step); inlined, the kernel spilled in the trailing
// update's loop and ran up to 40% slower on an H100 (PERF.md).
template <typename T, int WANT>
__device__ __noinline__ void pivot_block(T* W, T* x, const Active act, Smem<T>& s, int par,
                                         T& logdet, T& quad) {
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
      if (WANT == kChol && row_in && c <= r) W[static_cast<size_t>(J0 + r) * k + J0 + c] = v;
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
    for (int i = 0; i < NB; ++i) {
      s.linv[i][r] = xc[i];
      s.linvt[par][r][i] = xc[i];
      // states keeps L11^{-1} in the pivot block for its back substitution
      if (WANT == kStates && r < nb && i >= r && i < nb)
        W[static_cast<size_t>(J0 + i) * k + J0 + r] = xc[i];
    }
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

// Stage the panel entries of compressed rows c0 .. c0 + rows - 1 (rows a
// multiple of MT) into buf by cp.async: zeros past the last active row and
// past nb.  Rows stored as columns are copied an element at a time along
// i, rows stored as rows 16 bytes at a time along t where every row start
// is 16-byte aligned (k a multiple of 16 bytes, the matrix aligned), else
// an element at a time.  Each thread
// waits for its own copies; the caller's block barrier publishes them.
template <typename T>
__device__ void stage(T* buf, const T* W, const Active& act, int c0, int rows) {
  constexpr int NB = Shape<T>::NB, LDP = Shape<T>::LDP, V = Shape<T>::V;
  const int tid = threadIdx.x, k = act.k, J0 = act.J0, nb = act.nb;
  const int ce = min(c0 + rows, act.m);
  const int cc = min(max(act.column_rows(), c0), ce);  // rows [c0, cc) are columns
  const int nc = cc - c0;
  for (int e = tid; e < nc * NB; e += kThreads) {
    const int t = e / nc, il = e % nc;
    T* d = buf + il * LDP + t;
    if (t < nb) cp_async_elem(d, W + static_cast<size_t>(J0 + t) * k + c0 + il);
    else *d = T(0);
  }
  const int nr = ce - cc;
  if (k % V == 0 && (reinterpret_cast<size_t>(W) & 15) == 0) {
    constexpr int Q = NB / V;
    for (int e = tid; e < nr * Q; e += kThreads) {
      const int il = e / Q, t0 = (e % Q) * V;
      T* d = buf + (cc - c0 + il) * LDP + t0;
      const int n = min(max(nb - t0, 0), V);
      if (n > 0) {
        cp_async16(d, W + static_cast<size_t>(act.real(cc + il)) * k + J0 + t0,
                   n * static_cast<int>(sizeof(T)));
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) d[v] = T(0);
      }
    }
  } else {
    for (int e = tid; e < nr * NB; e += kThreads) {
      const int il = e / NB, t = e % NB;
      T* d = buf + (cc - c0 + il) * LDP + t;
      if (t < nb) cp_async_elem(d, W + static_cast<size_t>(act.real(cc + il)) * k + J0 + t);
      else *d = T(0);
    }
  }
  for (int e = tid; e < (c0 + rows - ce) * NB; e += kThreads)
    buf[(ce - c0 + e / NB) * LDP + e % NB] = T(0);
  cp_async_wait_all();
}

// Write the staged rows c0 .. c0 + n - 1 back to their panel entries: the
// inverse of stage.
template <typename T>
__device__ void unstage(T* W, const T* buf, const Active& act, int c0, int n) {
  constexpr int NB = Shape<T>::NB, LDP = Shape<T>::LDP;
  const int tid = threadIdx.x, nb = act.nb;
  const int cc = min(max(act.column_rows(), c0), c0 + n);
  const int nc = cc - c0, nr = n - nc;
  for (int e = tid; e < nc * NB; e += kThreads) {
    const int t = e / nc, il = e % nc;
    if (t < nb) W[act.at(c0 + il, t)] = buf[il * LDP + t];
  }
  for (int e = tid; e < nr * NB; e += kThreads) {
    const int il = e / NB, t = e % NB;
    if (t < nb) W[act.at(act.real(cc + il), t)] = buf[(nc + il) * LDP + t];
  }
}

// (b) and (d) on the n staged rows c0 .. c0 + n - 1 in buf, a warp a
// 32-row block: (b) V = U L11^{-T} in place, then x_i -= V_i . z for the
// warp's own rows (x null for chol); (d) U P = V L11^{-1} into the panel
// entries in device memory (columns < nb), bt = L11^{-T} of the step.
// L11^{-1} is lower triangular with explicit zeros, so both products run
// over the whole panel width.
template <typename T, bool kSecond>
__device__ void panel_product(T* W, T* x, T* buf, const Active& act, const Smem<T>& s,
                              const T* bt, int c0, int n) {
  constexpr int NB = Shape<T>::NB, LDP = Shape<T>::LDP, MT = Shape<T>::MT, NI = NB / 8;
  using F = Mma<T>;
  using A = Acc<T, NI>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rb = warp; rb * MT < n; rb += kWarps) {
    A acc;
#pragma unroll
    for (int i = 0; i < A::MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < F::NC; ++e) acc.c[i][j][e] = T(0);
    T* rows = buf + rb * MT * LDP;
    block_product<T, NI, NB>(acc, rows, LDP, kSecond ? bt : &s.linv[0][0], LDP, false);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < A::MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < F::NC; ++e) {
          const int r = i * F::M + F::crow(e), c = j * F::N + F::ccol(e);
          if (!kSecond) rows[r * LDP + c] = acc.c[i][j][e];
          else if (rb * MT + r < n && c < act.nb)
            W[act.at(act.real(c0 + rb * MT + r), c)] = acc.c[i][j][e];
        }
    if (!kSecond && x != nullptr) {
      __syncwarp();
      const int r = rb * MT + lane;
      if (r < n) {
        T dot = T(0);
#pragma unroll 8
        for (int c = 0; c < NB; ++c) dot = fma(rows[lane * LDP + c], s.z[c], dot);
        x[act.real(c0 + r)] -= dot;
      }
    }
  }
}

// (c) on one pair of staged blocks: rows ra0 .. ra0 + na - 1 of the active
// triangle (in bufa) against columns cb0 .. cb0 + nb - 1 (in bufb; the same
// block on the diagonal, where only the lower triangle is taken), a warp a
// 32 x 32 output tile, tiles dealt round-robin to the warps; with a lead
// tile (the next pivot block's, lead >= 0) warp 0 takes that one alone and
// the others go round-robin to warps 1 .. kWarps - 1.
template <typename T>
__device__ void update_pair(T* W, const Active& act, const T* bufa, int ra0, int na,
                            const T* bufb, int cb0, int nbr, int lead) {
  constexpr int NB = Shape<T>::NB, LDP = Shape<T>::LDP, MT = Shape<T>::MT, NI = MT / 8;
  using F = Mma<T>;
  using A = Acc<T, NI>;
  const int warp = threadIdx.x >> 5, k = act.k;
  const bool diag = ra0 == cb0;
  const int tr = (na + MT - 1) / MT, tc = (nbr + MT - 1) / MT;
  int p = 0;
  for (int R = 0; R < tr; ++R) {
    for (int C = 0; C < (diag ? R + 1 : tc); ++C, ++p) {
      const int owner =
          lead < 0 ? p % kWarps : p == lead ? 0 : 1 + (p - (p > lead)) % (kWarps - 1);
      if (owner != warp) continue;
      A acc;
      // the tile's old values, loaded before the products
#pragma unroll
      for (int i = 0; i < A::MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < F::NC; ++e) {
            const int ci = ra0 + R * MT + i * F::M + F::crow(e);
            const int cl = cb0 + C * MT + j * F::N + F::ccol(e);
            acc.c[i][j][e] = ci < act.m && cl <= ci && cl < cb0 + nbr
                                 ? W[static_cast<size_t>(act.real(ci)) * k + act.real(cl)]
                                 : T(0);
          }
      block_product<T, NI, NB>(acc, bufa + R * MT * LDP, LDP, bufb + C * MT * LDP, LDP, true);
#pragma unroll
      for (int i = 0; i < A::MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < F::NC; ++e) {
            const int ci = ra0 + R * MT + i * F::M + F::crow(e);
            const int cl = cb0 + C * MT + j * F::N + F::ccol(e);
            if (ci < act.m && cl <= ci && cl < cb0 + nbr)
              W[static_cast<size_t>(act.real(ci)) * k + act.real(cl)] = acc.c[i][j][e];
          }
    }
  }
}

// One panel step after the pivot block, (b) to (d), with L11^{-T} in
// s.linvt[par].  With one chunk (the whole panel staged) V stays in buf from
// (b) through (d), the warps go from their tiles of (c) to their rows of (d)
// without a barrier, and, given a next step (next.nb > 0) and kAheadTiles
// tiles in (c), warp 0 updates the next pivot block's tile first and
// factors that block (into s.linvt[par ^ 1]) while the other warps finish
// (c).  In chunks V goes through device memory, (c) takes chunk pairs
// through buf and buf + CH rows, and the next pivot block waits for the
// step's end.  Returns whether the next pivot block was factored.
template <typename T, int WANT>
__device__ bool panel_step(T* W, T* x, const Active& act, Smem<T>& s, T* buf,
                           const Plan<T>& plan, int par, const Active& next, T& logdet,
                           T& quad) {
  constexpr int LDP = Shape<T>::LDP, MT = Shape<T>::MT;
  constexpr bool kInverse = is_inverse(WANT);
  const int m = act.m;
  const int nch = plan.chunked ? (m + Shape<T>::CH - 1) / Shape<T>::CH : 1;
  const int cr = nch == 1 ? round_up(m, MT) : Shape<T>::CH;
  const bool keep = nch == 1;
  const int tr = (m + MT - 1) / MT;
  const bool ahead = keep && next.nb > 0 && tr * (tr + 1) / 2 >= kAheadTiles;
  T* buf2 = buf + static_cast<size_t>(Shape<T>::CH) * LDP;
  // (b)
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * cr, n = min(cr, m - c0);
    stage(buf, W, act, c0, round_up(n, MT));
    __syncthreads();
    panel_product<T, false>(W, x, buf, act, s, nullptr, c0, n);
    __syncthreads();
    if (!keep || WANT == kChol || WANT == kStates) unstage(W, buf, act, c0, n);
    if (!keep) __syncthreads();
  }
  // (c); the next pivot block lies in the diagonal tile at compressed row 0
  // (factor variants) or J0 (inverse variants)
  const int lead_row = (kInverse ? act.J0 : 0) / MT;
  const int lead = ahead ? lead_row * (lead_row + 1) / 2 + lead_row : -1;
  for (int ra = 0; ra < nch; ++ra) {
    const int ra0 = ra * cr, na = min(cr, m - ra0);
    if (!keep) stage(buf, W, act, ra0, round_up(na, MT));
    for (int cb = 0; cb <= ra; ++cb) {
      const int cb0 = cb * cr, nbr = min(cr, m - cb0);
      if (!keep && cb < ra) stage(buf2, W, act, cb0, round_up(nbr, MT));
      if (!keep) __syncthreads();
      update_pair(W, act, buf, ra0, na, cb < ra ? buf2 : buf, cb0, nbr, lead);
      if (!keep) __syncthreads();
    }
  }
  if (ahead && (threadIdx.x >> 5) == 0) {
    __syncwarp();  // the tile's stores, before the warp's lanes read them back
    pivot_block<T, WANT>(W, x, next, s, par ^ 1, logdet, quad);
  }
  // (d)
  if (kInverse) {
    for (int c = 0; c < nch; ++c) {
      const int c0 = c * cr, n = min(cr, m - c0);
      if (!keep) {
        stage(buf, W, act, c0, round_up(n, MT));
        __syncthreads();
      }
      panel_product<T, true>(W, nullptr, buf, act, s, &s.linvt[par][0][0], c0, n);
      if (!keep) __syncthreads();
    }
  }
  return ahead;
}

// states: back substitution L^T s = y by blocks, from the last; y in x,
// L11^{-1} in each pivot block (pivot_block), so that each block's solve is
// one product: s_J = L11^{-T} (y_J - sum over rows i below block J of
// L[i][J]^T s_i).  `part` holds kWarps x NB partial sums.
template <typename T>
__device__ void back_substitute(const T* W, const T* x, T* s_out, int k, T* part) {
  constexpr int NB = Shape<T>::NB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = ((k - 1) / NB) * NB;
  for (int J0 = last; J0 >= 0; J0 -= NB) {
    const int nb = min(NB, k - J0);
    T acc = T(0);
    if (lane < nb) {
#pragma unroll 4
      for (int i = J0 + nb + warp; i < k; i += kWarps)
        acc = fma(W[static_cast<size_t>(i) * k + J0 + lane], s_out[i], acc);
    }
    if (lane < NB) part[warp * NB + lane] = acc;
    __syncthreads();
    if (warp == 0) {
      T r = T(0);
      if (lane < nb) {
        r = x[J0 + lane];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) r -= part[w * NB + lane];
      }
      // lane c: s_c = sum over i >= c of L11^{-1}[i][c] r_i
      T sv = T(0);
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const T ri = __shfl_sync(0xffffffffu, r, i);
        if (i < nb && i >= lane) sv = fma(W[static_cast<size_t>(J0 + i) * k + J0 + lane], ri, sv);
      }
      if (lane < nb) s_out[J0 + lane] = sv;
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
  extern __shared__ __align__(16) unsigned char dyn[];
  T* buf = reinterpret_cast<T*>(dyn);
  const Plan<T> plan(k);
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
    // before stores)
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
    Active act = step<T>(0, k, kInverse);
    if (warp == 0) pivot_block<T, WANT>(W, x, act, s, 0, logdet, quad);
    __syncthreads();
    for (int par = 0; act.nb > 0; par ^= 1) {
      const Active next = step<T>(act.J0 + NB, k, kInverse);
      if (kInverse) pivot_inverse(W, act, s);
      const bool ahead =
          act.m > 0 && panel_step<T, WANT>(W, x, act, s, buf, plan, par, next, logdet, quad);
      __syncthreads();
      if (!ahead && next.nb > 0) {
        if (warp == 0) pivot_block<T, WANT>(W, x, next, s, par ^ 1, logdet, quad);
        __syncthreads();
      }
      act = next;
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
    if (WANT == kStates) back_substitute(W, x, s_out + n * k, k, buf);

    if (kInverse) {
      // SM = s s^T - sigma^2 A (or Sigma = -sigma^2 A): the OT x OT tiles
      // (R, C) of the lower triangle, as many of a tile row at once as buf
      // holds, each written and (full, infer) its transpose (C, R) through
      // buf, so that both stores are coalesced
      constexpr int TE = OT * (OT + 1);
      const int cap = max(1, static_cast<int>(plan.bytes() / sizeof(T)) / TE);
      const T* sv = s_out + n * k;
      for (int R = 0; R < tiles; ++R) {
        for (int C0 = 0; C0 <= R; C0 += cap) {
          const int total = min(cap, R + 1 - C0) * OT * OT;
          for (int e0 = 0; e0 < total; e0 += kIo * kThreads) {
            T v[kIo];
#pragma unroll
            for (int u = 0; u < kIo; ++u) {
              const int e = e0 + tid + u * kThreads, t = e / (OT * OT);
              const int i = R * OT + e / OT % OT, c = (C0 + t) * OT + e % OT;
              v[u] = e < total && i < k && c <= i
                         ? (kSecond ? sv[i] * sv[c] : T(0)) -
                               s2 * W[static_cast<size_t>(i) * k + c]
                         : T(0);
            }
#pragma unroll
            for (int u = 0; u < kIo; ++u) {
              const int e = e0 + tid + u * kThreads, t = e / (OT * OT);
              const int rl = e / OT % OT, cl = e % OT, i = R * OT + rl, c = (C0 + t) * OT + cl;
              if (e < total && i < k && c <= i) {
                W[static_cast<size_t>(i) * k + c] = v[u] + poison;
                if (WANT != kFullT) buf[t * TE + cl * (OT + 1) + rl] = v[u] + poison;
              }
            }
          }
          if (WANT == kFullT) continue;  // fullt's SM: on and below the diagonal only
          __syncthreads();
          for (int e = tid; e < total; e += kThreads) {
            // row (C0 + t) OT + rl, column R OT + cl
            const int t = e / (OT * OT), rl = e / OT % OT, cl = e % OT;
            const int i = (C0 + t) * OT + rl, c = R * OT + cl;
            if (i < k && c < k && c > i)
              W[static_cast<size_t>(i) * k + c] = buf[t * TE + rl * (OT + 1) + cl];
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
  cudaError_t err = multiprocessors(device, sms);
  if (err != cudaSuccess) return err;
  // the dynamic shared memory of this k (with the static, above the
  // default 48 KB a block at larger k)
  const size_t bytes = Plan<T>(k).bytes();
  err = cudaFuncSetAttribute(spd_panel_kernel<T, WANT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(kCtasPerSm) * sms;
  const unsigned grid = static_cast<unsigned>(B < slots ? B : slots);
  spd_panel_kernel<T, WANT><<<grid, kThreads, bytes, stream>>>(
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
