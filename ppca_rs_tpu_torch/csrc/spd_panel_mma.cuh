// Tensor-core and asynchronous-copy pieces of the panel design
// (spd_panel.cuh): warp-level products of a 32-row block of a staged panel
// with the transpose of another staged block, on mma.sync, and cp.async
// staging from device memory into shared memory.
//
// float: mma.sync m16n8k8 with TF32 operands in the 3xTF32 split.  Each
// operand a is cut into hi = rna(a) and lo = rna(a - hi), rna the rounding
// of cvt.rna.tf32.f32 done on the bits (tf32_rna), and a product takes
// lo*hi' + hi*lo' + hi*hi' (the lo*lo' term, ~2^-22 of it, is dropped),
// which keeps float32 accuracy; one TF32 product alone keeps ~11 bits.
// The split is made as each fragment is loaded; on an H100 at k=256
// (fullt, B=8192) the trailing products took ~4.9 ms of 18.9 with the
// conversion instruction and ~2.4 ms with the rounding on the bits
// (PERF.md).  double: mma.sync m8n8k4 in float64 (FP64 MMA, DMMA),
// exact as FMAs are; the sm_90 shape m16n8k8 was no faster there.
//
// Fragments (g = lane / 4, t = lane % 4), with B given as its transpose
// Bt[n][k] so that both operands are rows of a staged row-major block:
//   float  A 16x8: (g, t) (g+8, t) (g, t+4) (g+8, t+4); Bt 8x8: (g, t) (g, t+4);
//          C 16x8: (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1)
//   double A 8x4:  (g, t);  Bt 8x4: (g, t);  C 8x8: (g, 2t) (g, 2t+1)
// Every operand load reads element (g + r0, t + c0) of a block whose row
// stride is 4 words modulo 32 (float: NB + 4 = 36; double: NB + 4 = 20
// doubles, 8 banks modulo 32 a row), so a warp's 32 loads (a half-warp's
// 16 for double) fall on distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ppca {
namespace panel {

template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int M = 16, N = 8, K = 8;
  static constexpr int NC = 4;  // accumulator elements a lane
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  // row and column of accumulator element e within the M x N tile
  __device__ static int crow(int e) { return (threadIdx.x & 31) / 4 + (e >= 2 ? 8 : 0); }
  __device__ static int ccol(int e) { return 2 * (threadIdx.x & 3) + (e & 1); }
};

template <>
struct Mma<double> {
  static constexpr int M = 8, N = 8, K = 4;
  static constexpr int NC = 2;
  struct A { double v; };
  struct B { double v; };
  __device__ static int crow(int) { return (threadIdx.x & 31) / 4; }
  __device__ static int ccol(int e) { return 2 * (threadIdx.x & 3) + e; }
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, 10 mantissa bits kept), on its bits: two integer instructions
// where the conversion instruction issues at a fraction of their rate
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// A fragment of the M x K block at p (row stride ld), negated if `neg`.
__device__ __forceinline__ void load_a(Mma<float>::A& a, const float* p, int ld, bool neg) {
  const int g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
  const float s = neg ? -1.f : 1.f;
  split(s * p[g * ld + t], a.hi[0], a.lo[0]);
  split(s * p[(g + 8) * ld + t], a.hi[1], a.lo[1]);
  split(s * p[g * ld + t + 4], a.hi[2], a.lo[2]);
  split(s * p[(g + 8) * ld + t + 4], a.hi[3], a.lo[3]);
}
__device__ __forceinline__ void load_a(Mma<double>::A& a, const double* p, int ld, bool neg) {
  const int g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
  a.v = neg ? -p[g * ld + t] : p[g * ld + t];
}

// A fragment of B = Bt^T, Bt the N x K block at p (row stride ld).
__device__ __forceinline__ void load_b(Mma<float>::B& b, const float* p, int ld) {
  const int g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
  split(p[g * ld + t], b.hi[0], b.lo[0]);
  split(p[g * ld + t + 4], b.hi[1], b.lo[1]);
}
__device__ __forceinline__ void load_b(Mma<double>::B& b, const double* p, int ld) {
  const int g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
  b.v = p[g * ld + t];
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in the 3xTF32 split (small terms first).
__device__ __forceinline__ void mma(float (&d)[4], const Mma<float>::A& a, const Mma<float>::B& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}
// d += a b in float64.
__device__ __forceinline__ void mma(double (&d)[2], const Mma<double>::A& a,
                                    const Mma<double>::B& b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a.v), "d"(b.v));
}

// The accumulators of one warp's 32 x (8 NI) output block: MI x NI tiles.
template <typename T, int NI>
struct Acc {
  static constexpr int MI = 32 / Mma<T>::M;
  T c[MI][NI][Mma<T>::NC];
};

// acc += (neg ? -1 : 1) A Bt^T over KD columns: A the 32 x KD block at a
// (row stride lda), Bt the (8 NI) x KD block at bt (row stride ldb).
template <typename T, int NI, int KD>
__device__ __forceinline__ void block_product(Acc<T, NI>& acc, const T* a, int lda, const T* bt,
                                              int ldb, bool neg) {
  using F = Mma<T>;
  constexpr int MI = Acc<T, NI>::MI;
#pragma unroll
  for (int kk = 0; kk < KD; kk += F::K) {
    typename F::A fa[MI];
    typename F::B fb[NI];
#pragma unroll
    for (int i = 0; i < MI; ++i) load_a(fa[i], a + i * F::M * lda + kk, lda, neg);
#pragma unroll
    for (int j = 0; j < NI; ++j) load_b(fb[j], bt + j * F::N * ldb + kk, ldb);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) mma(acc.c[i][j], fa[i], fb[j]);
  }
}

// cp.async from device memory into shared memory: 16 bytes of which the
// first `src_bytes` are read and the rest zero-filled (dst and src 16-byte
// aligned), or one element (4 or 8 bytes, aligned to its size).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
// Wait for this thread's copies; a block barrier then publishes them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace panel
}  // namespace ppca
