// The lane grid of the register-tile Cholesky (spd_chol_tile.cuh): the shape
// of one sample's lanes, 16-byte loads and stores of four neighbouring
// elements, and the sync of one sample's lanes.
//
// A sample's KP x KP tile belongs to NL lanes laid out as a GR x GC lane
// grid; lane (lr, lc) holds the 4P x 4Q elements at rows p*4GR + 4lr +
// (0..3) and columns q*4GC + 4lc + (0..3), so every register index is a
// compile-time constant.  Pivot j = qq*4GC + 4c + e lies in column quad qq
// of the lanes with lc == c and in row quad pp = (qq*GC)/GR of the lanes
// with lr = (qq % (GR/GC))*GC + c.

#pragma once

#include <cuda_runtime.h>

namespace ppca {
namespace tile {

// The lane grid of one sample for a tile of KP in float (F32) or double:
// GR x GC lanes, each with P row quads and Q column quads; THREADS per
// block, GROUPS samples a block.  A lane holds 16 P Q elements of the tile.
//  * float KP=64: 32 lanes x 128 elements (ptxas gives those kernels up
//    to 254 registers and no spills; capped at 168 the E-step's spilled
//    ~3 KB a thread and ran 2.75x slower on an H100).
//  * float KP=128: 128 lanes x 128 elements, the load of float KP=64 (no
//    spills).  On an H100 the E-step's `fullt` at k=128 took 1.75 ms on
//    this grid and 2.67 ms on 256 lanes x 64 elements.
//  * double: 64 elements a lane from KP=64 up (64 lanes at KP=64, 256 at
//    KP=128), 32 at KP=32 (with 64 there, ptxas spilled).
// A sample of up to 32 lanes is part of one warp; a wider one is whole
// warps, one sample a block from 128 lanes up.
template <typename T, int KP>
struct Shape {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int GR = KP == 8 ? 2 : KP == 16 ? 4 : KP == 32 ? (F32 ? 4 : 8) : KP == 64 ? 8 : 16;
  static constexpr int GC = KP == 8    ? 2
                            : KP == 16 ? 2
                            : KP == 32 ? 4
                            : KP == 64 ? (F32 ? 4 : 8)
                                       : (F32 ? 8 : 16);
  static constexpr int NL = GR * GC;
  static constexpr int P = KP / (4 * GR);
  static constexpr int Q = KP / (4 * GC);
  static constexpr int THREADS = NL == 32 ? 64 : NL < 128 ? 128 : NL;
  static constexpr int GROUPS = THREADS / NL;
  static_assert(P * 4 * GR == KP && Q * 4 * GC == KP, "the lane grid must cover KP in quads");
  static_assert(GR % GC == 0, "the rows of four consecutive pivots must lie in one lane row");
  static_assert(NL <= 32 || NL % 32 == 0, "a sample is part of one warp or whole warps");
  static_assert(NL <= 32 || GROUPS <= 15, "one named barrier per sample, 1..15");
};

__device__ __forceinline__ void load_quad(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_quad(const double* p, double (&o)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void store_quad(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store_quad(double* p, const double (&o)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(o[0], o[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(o[2], o[3]);
}
// Device memory, read or written once: streaming (evict-first) accesses.
__device__ __forceinline__ void load_quad_stream(const float* p, float (&o)[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_quad_stream(const double* p, double (&o)[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void store_quad_stream(float* p, const float (&o)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
}
__device__ __forceinline__ void store_quad_stream(double* p, const double (&o)[4]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(o[0], o[1]));
  __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(o[2], o[3]));
}

// Synchronise the NL lanes of one sample: its warp, or its whole warps by
// the named barrier 1 + group (barrier 0 is the block's; NL is a multiple
// of 32 there, as bar.sync requires).
template <int NL>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (NL <= 32) {
    __syncwarp();
  } else {
    static_assert(NL % 32 == 0, "a named barrier counts whole warps");
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(NL) : "memory");
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace tile
}  // namespace ppca
