// The M-step statistic S on Hopper's bf16 tensor cores, exact to float32
// sums (sm_90a): S[m] += mask^T (scale[m] * SM[m]) for a block of B samples.
//
// Replaces no TPU kernel: the JAX package leaves S (`ppca_rs_tpu/ops/
// masked_linalg.py`, `mix_fused.py`) to XLA's dot, and the port ran it as a
// SIMT float32 `torch.matmul` of the weighted mask and the E-step's second
// moments SM: 2 B D W operations a block (W = SM's columns, slab_width(64) =
// 2304 at k=64), the same work as the masked Gram (mask_gram.cu) and, at
// 74% of the card's 67 TFLOP/s SIMT rate, 47% of a k=64 iteration.
//
// The arithmetic, as mask_gram.cu's.  The weight goes on SM's side, so the
// mask stays an exact 0/1 operand: x = scale * SM in float32 (one rounding,
// as the mixture's SIMT route had; the masked route's FFMA of mask * w took
// the product unrounded), then hi = bf16(x), mid = bf16(x - hi),
// lo = x - hi - mid, each step exact (gram_slices' identities), so mask hi +
// mask mid + mask lo = mask x exactly.  The tensor cores (wgmma, float32
// accumulators) sum short runs and each run is promoted into a float32
// register sum with ordinary FADD: hi's products in runs of 64 samples,
// mid's and lo's together over the same 64, apart from hi's (the tensor
// cores' adder truncates, and S's diagonal, like the Gram's, sums terms
// >= 0; runs of 32 for hi read the same errors, an H100 at B = 8192).
// The sum over the block's rows rounds as float32 sums do; the sum over
// blocks is the caller's float32 S, which the epilogue adds into.
//
// Why by hand: the slices are cut on chip and never written to device
// memory (three bf16 copies of a mixture's (8, 8192, 640) SM would be 252
// MB); the mask is read as the bool bytes the Dataset holds; the product
// adds into S in place, with no per-block temporary.
//
// What bounds it on this card: 3 x 2 B D W bf16 operations (116 GFLOP at B
// = 8192, D = 1024, W = 2304: 117 us at 989 TFLOP/s); the bytes (SM's 75 MB
// and the mask's 8 MB read once, S read and written) take ~31 us at 3.35
// TB/s.  So the tensor cores are the floor.
//
// The design.  S's tile is 128 rows of D by N columns of W, N chosen by the
// host from {128, 144, 160} so that the tiles fill the card's
// multiprocessors in whole waves (D = 1024, W = 2304: 128 tiles of N = 144
// on 132 multiprocessors; the mixture's 8 x 512 x 640: 128 of N = 160).
// One CTA a multiprocessor walks the tiles (row tiles fastest, so that the
// CTAs in flight share SM's columns in L2).  Converter warps (two
// warpgroups, one at N = 160 where the accumulators leave no registers)
// turn each stage of 32 samples into the operands: one thread brings SM's
// float32 tile (32 x N) and the mask's bytes (32 x 128) into a staging ring
// by TMA (zero-filled past B, D and W); the warps scale and split SM into
// the three slices, N x 32 bf16 each, K-major in shared memory with the
// 64-byte swizzle, and widen the mask's bytes to bf16 0/1, 32 x 128,
// MN-major with the 128-byte swizzle, into an operand ring.  Two consumer
// warpgroups of 64 rows each run wgmma m64nNk16 with both operands from
// shared memory, A = the mask (as mask^T), B = a slice, and add their
// float32 sums into S at the end of a tile.  Where TMA cannot address SM
// or the mask (rows not 16-byte aligned: W not a multiple of 4, a
// model-axis block's D), the converters read them from device memory
// themselves.
//
// What holds it at ~30% of the bf16 peak (an H100 80GB HBM3 at 700 W, B =
// 8192, D = 1024, W = 2304: 0.35-0.38 ms a block): the converters.  Alone,
// without the products, they take 0.30 ms, of which the staging ring's TMA
// of SM (each float32 element read by the 8 row tiles of D, ~6.7 TB/s
// from L2) 0.11 ms; the products alone, with no conversion, 0.21 ms.
// Neither more converter warps, nor a split by truncation (no conversion
// instructions), nor deeper rings moved it by more than 10%.
#include <cuda_bf16.h>

#include "gemm_common.cuh"
#include "spd_common.cuh"

namespace ppca {
namespace gemm {

constexpr int kSRows = 128;                           // rows of D a CTA tile (the mask's columns)
constexpr int kSBK = 32;                              // samples a stage
constexpr int kSSteps = kSBK / 16;                    // wgmma k16 steps a stage
constexpr int kSConsumerWarps = 8;                    // two warpgroups of 64 rows
constexpr int kSMaskOpBytes = kSBK * kSRows * 2;      // the mask's bf16 operand, 8 KB a stage
constexpr int kSMaskStgBytes = kSBK * kSRows;         // its bytes, 4 KB a stage
constexpr int kSSmemLimit = 232448;                   // a CTA's shared memory on an H100

// The warps and registers of a CTA for N columns of S a tile.  The
// converters set the pace (an H100, B = 8192, D = 1024, W = 2304: 0.36 ms a
// block with four converter warps and no products, 0.22 ms with the
// products and no conversion), so they take two warpgroups where the
// consumers' 2 x N / 2 accumulators leave the registers: 256 x 80 + 256 x
// 176 = the 512 x 128 of the launch; at N = 160 one, 128 x 88 + 256 x 208 =
// 384 x 168 (setmaxnreg moves registers only within the launch's).
template <int N>
struct SRoles {
  static constexpr int kConverterWarps = N > 144 ? 4 : 8;
  static constexpr int kThreads = (kSConsumerWarps + kConverterWarps) * 32;
  static constexpr int kLaunchRegs = N > 144 ? 168 : 128;
  static constexpr int kConverterRegs = N > 144 ? 88 : 80;
  static constexpr int kConsumerRegs = N > 144 ? 208 : 176;
  static_assert(kConverterWarps * 32 * kConverterRegs + kSConsumerWarps * 32 * kConsumerRegs ==
                    kThreads * kLaunchRegs && kThreads * kLaunchRegs <= 65536,
                "setmaxnreg moves registers within the launch's allocation");
  static_assert(kConverterWarps % 4 == 0, "converter warps cover a stage's four octets of samples");
};

// Shared-memory layout of a CTA for N columns of S a tile: kOps operand
// stages (the mask's bf16, then hi, mid, lo: N rows of 64 bytes each), kStg
// staging stages (SM's float32 N x 32, then the mask's 32 x 128 bytes), the
// barriers.  Every buffer starts 1024-byte aligned.
template <int N>
struct SLayout {
  static constexpr int kSliceBytes = N * kSBK * 2;
  static constexpr int kOpBytes = kSMaskOpBytes + 3 * kSliceBytes;
  static constexpr int kXStgBytes = kSBK * N * 4;
  static constexpr int kStgBytes = kXStgBytes + kSMaskStgBytes;
  static constexpr int kOps = 4;
  static constexpr int kStg = 3;
  static constexpr int kBarOffset = kOps * kOpBytes + kStg * kStgBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + (2 * kOps + kStg) * 8;
  static_assert(kOpBytes % 1024 == 0 && kStgBytes % 1024 == 0, "buffers keep 1024-byte alignment");
  static_assert(kSmemBytes <= kSSmemLimit, "the rings must fit a CTA's shared memory");
};

// wgmma descriptor of the mask's operand for one warpgroup and k16 step: 64
// rows of D contiguous (MN-major), the 128-byte swizzle, the next 8 samples
// (the stride byte offset) 1 KB on; one swizzle atom along D (64 columns),
// so the leading byte offset is the next warpgroup's box.
__device__ __forceinline__ uint64_t s_mask_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((kSBK * 128) >> 4) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// wgmma descriptor of a slice's N x 16 operand: each of N rows holds the
// stage's 32 samples in 64 bytes (K-major), the 64-byte swizzle, 8 rows a
// 512-byte atom (the stride byte offset); a k16 step starts 32 bytes in.
__device__ __forceinline__ uint64_t s_slice_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(512 >> 4) << 32;
  d |= static_cast<uint64_t>(2) << 62;
  return d;
}

// d (+)= A B for one warpgroup: A 64 x 16 (the mask's operand) and B 16 x N
// (a slice) bf16 in shared memory, d float32; scale_d 0 ignores d's old
// value.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<144>(float (&d)[72], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<160>(float (&d)[80], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(scale_d));
}

// x's three bf16 slices of the pair (a, b), a in the low half of each word:
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
// difference exact (round to nearest even throughout).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  auto pack = [](float lo_half, float hi_half) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo_half, hi_half);
    return *reinterpret_cast<const uint32_t*>(&v);
  };
  hi = pack(a, b);
  const float ra = __fsub_rn(a, __uint_as_float(hi << 16));
  const float rb = __fsub_rn(b, __uint_as_float(hi & 0xFFFF0000u));
  mid = pack(ra, rb);
  lo = pack(__fsub_rn(ra, __uint_as_float(mid << 16)),
            __fsub_rn(rb, __uint_as_float(mid & 0xFFFF0000u)));
}

// Two mask bytes of `word` (picked by `sel`) as a bf16 pair: 0 -> 0, 1 -> 1.0.
__device__ __forceinline__ uint32_t s_mask_pair(uint32_t word, uint32_t sel) {
  return __byte_perm(word, 0u, sel) * 0x3F80u;
}

// (component, row tile, column tile) of a tile index, row tiles fastest.
__device__ __forceinline__ void s_tile_coords(int tile, int n_rt, int n_ct, int& m, int& rt,
                                              int& ct) {
  rt = tile % n_rt;
  ct = (tile / n_rt) % n_ct;
  m = tile / (n_rt * n_ct);
}

// The stage units (tile, stage) a CTA walks, in order.
struct SWalk {
  int tile, kt, m, rt, ct;
  __device__ SWalk(int first, int n_rt, int n_ct) : tile(first), kt(0) {
    s_tile_coords(tile, n_rt, n_ct, m, rt, ct);
  }
  __device__ void next(int n_kt, int n_rt, int n_ct) {
    if (++kt == n_kt) {
      kt = 0;
      tile += gridDim.x;
      s_tile_coords(tile, n_rt, n_ct, m, rt, ct);
    }
  }
};

// S[m] (D x W, row stride W) += mask^T (B x D bytes, row stride mask_ld)
// (scale[m] (B) * sm[m] (B x W)) for m < M.  kTma: SM and the mask come by
// TMA (the maps `xmap`, (W, B, M) float32, and `mmap`, (D, B) bytes); else
// the converters read them from device memory.
template <int N, bool kTma>
__global__ void __launch_bounds__(SRoles<N>::kThreads, 1)
    mask_s_bf16x3_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap mmap,
                         const uint8_t* __restrict__ mask, long long mask_ld,
                         const float* __restrict__ sm, const float* __restrict__ scale,
                         float* __restrict__ S, int B, int D, int W, int M, int vec_out) {
  using L = SLayout<N>;
  using Roles = SRoles<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  auto op_full = [&](int s) { return smem_u32(bars + s); };
  auto op_empty = [&](int s) { return smem_u32(bars + L::kOps + s); };
  auto stg_full = [&](int s) { return smem_u32(bars + 2 * L::kOps + s); };
  auto op_smem = [&](int s) { return smem + s * L::kOpBytes; };
  auto stg_smem = [&](int s) { return smem + L::kOps * L::kOpBytes + s * L::kStgBytes; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kOps; ++s) {
      mbar_init(op_full(s), Roles::kConverterWarps);
      mbar_init(op_empty(s), kSConsumerWarps);
    }
    for (int s = 0; s < L::kStg; ++s) mbar_init(stg_full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_rt = (D + kSRows - 1) / kSRows, n_ct = (W + N - 1) / N;
  const int n_tiles = M * n_rt * n_ct;
  const int n_kt = (B + kSBK - 1) / kSBK;

  if (warp >= kSConsumerWarps) {
    // converters: warp c scales and splits samples 8o..8o+7 (o = c % 4) of
    // each stage, in columns j of every (kConverterWarps / 4)-th group of 32
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(Roles::kConverterRegs));
    constexpr int kGroupStride = Roles::kConverterWarps / 4;
    const int cw = warp - kSConsumerWarps, o = cw % 4, g0 = cw / 4;
    const int tid = threadIdx.x - kSConsumerWarps * 32;
    auto issue = [&](const SWalk& u, int s) {
      mbar_expect_tx(stg_full(s), L::kStgBytes);
      tma_load_3d(smem_u32(stg_smem(s)), &xmap, stg_full(s), u.ct * N, u.kt * kSBK, u.m);
      tma_load_2d(smem_u32(stg_smem(s) + L::kXStgBytes), &mmap, stg_full(s), u.rt * kSRows,
                  u.kt * kSBK);
    };
    SWalk ahead(blockIdx.x, n_rt, n_ct);
    if (kTma && tid == 0) {
      for (int s = 0; s < L::kStg && ahead.tile < n_tiles; ++s) {
        issue(ahead, s);
        ahead.next(n_kt, n_rt, n_ct);
      }
    }
    // the scales of a unit's samples 8o..8o+7, loaded a unit ahead of their use
    auto load_scale = [&](const SWalk& w, float (&dst)[8]) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = w.kt * kSBK + 8 * o + i;
        dst[i] = w.tile < n_tiles && b < B ? __ldg(scale + static_cast<long long>(w.m) * B + b)
                                           : 0.f;
      }
    };
    float sc[8];
    SWalk u(blockIdx.x, n_rt, n_ct);
    load_scale(u, sc);
    for (uint32_t it = 0; u.tile < n_tiles; ++it) {
      SWalk nxt = u;
      nxt.next(n_kt, n_rt, n_ct);
      float sc_next[8];
      load_scale(nxt, sc_next);
      const int ss = it % L::kStg, os = it % L::kOps;
      if (kTma) mbar_wait(stg_full(ss), (it / L::kStg) & 1);
      mbar_wait(op_empty(os), ((it / L::kOps) & 1) ^ 1);
      const float* xs = reinterpret_cast<const float*>(stg_smem(ss));
      const uint8_t* ms = stg_smem(ss) + L::kXStgBytes;
      uint8_t* op = op_smem(os);
      const int b0 = u.kt * kSBK;
      // SM's samples 8o..8o+7 at column j, scaled and split: one 16-byte
      // chunk (chunk o of row j) of each slice
      const float* xg = sm + (static_cast<long long>(u.m) * B + b0 + 8 * o) * W + u.ct * N;
#pragma unroll
      for (int r = 0; r < (N + 32 * kGroupStride - 1) / (32 * kGroupStride); ++r) {
        const int group = g0 + kGroupStride * r;
        if (32 * group >= N) break;                   // the same for the whole warp
        const int j = lane + 32 * group;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float x;
          if (kTma) {
            x = xs[(8 * o + i) * N + j];              // past N: other staging bytes, not stored
          } else {
            const bool in = b0 + 8 * o + i < B && u.ct * N + j < W;
            x = in ? __ldg(xg + static_cast<long long>(i) * W + j) : 0.f;
          }
          v[i] = __fmul_rn(sc[i], x);
        }
        uint4 h, md, l;
        split_pair(v[0], v[1], h.x, md.x, l.x);
        split_pair(v[2], v[3], h.y, md.y, l.y);
        split_pair(v[4], v[5], h.z, md.z, l.z);
        split_pair(v[6], v[7], h.w, md.w, l.w);
        if (j < N) {
          const int off = kSMaskOpBytes + j * 64 + ((o ^ ((j >> 1) & 3)) << 4);
          *reinterpret_cast<uint4*>(op + off) = h;
          *reinterpret_cast<uint4*>(op + off + L::kSliceBytes) = md;
          *reinterpret_cast<uint4*>(op + off + 2 * L::kSliceBytes) = l;
        }
      }
      // the mask's 32 x 128 bytes widened to bf16: chunk c = 8 columns of D
      // of one sample, into box c / 8 (64 columns), swizzled
#pragma unroll
      for (int q = 0; q < kSBK * kSRows / 8 / (Roles::kConverterWarps * 32); ++q) {
        const int c = tid + Roles::kConverterWarps * 32 * q, b = c >> 4, dc = c & 15;
        uint2 bytes;
        if (kTma) {
          bytes = *reinterpret_cast<const uint2*>(ms + b * kSRows + 8 * dc);
        } else {
          uint32_t w[2] = {0u, 0u};
          const int row = b0 + b, col = u.rt * kSRows + 8 * dc;
          if (row < B) {
            const uint8_t* src = mask + static_cast<long long>(row) * mask_ld + col;
            for (int e = 0; e < 8 && col + e < D; ++e)
              w[e >> 2] |= static_cast<uint32_t>(__ldg(src + e)) << (8 * (e & 3));
          }
          bytes = make_uint2(w[0], w[1]);
        }
        const uint4 wide = make_uint4(s_mask_pair(bytes.x, 0x4140u), s_mask_pair(bytes.x, 0x4342u),
                                      s_mask_pair(bytes.y, 0x4140u), s_mask_pair(bytes.y, 0x4342u));
        *reinterpret_cast<uint4*>(op + (dc >> 3) * (kSBK * 128) + b * 128 +
                                  (((dc & 7) ^ (b & 7)) << 4)) = wide;
      }
      // the operands to the tensor cores' proxy, then the stage to the consumers
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(op_full(os));
      if (kTma) {
        // every converter has read staging stage ss: refill it
        asm volatile("bar.sync 1, %0;" ::"n"(Roles::kConverterWarps * 32) : "memory");
        if (tid == 0 && ahead.tile < n_tiles) {
          issue(ahead, ss);
          ahead.next(n_kt, n_rt, n_ct);
        }
      }
      u = nxt;
#pragma unroll
      for (int i = 0; i < 8; ++i) sc[i] = sc_next[i];
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(Roles::kConsumerRegs));
  // consumers: warp w of warpgroup wg holds tile rows wg*64 + (w%4)*16 + g
  // and + 8, columns (i/4)*8 + 2t + (i%2) of its accumulator entry i
  constexpr int R = N / 2;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int r_lo = wg * 64 + (warp % 4) * 16 + g;
  float acc[R], sum[R];
  auto a_desc = [&](int s, int st) {
    return s_mask_desc(smem_u32(op_smem(s)) + wg * (kSBK * 128) + st * 16 * 128);
  };
  auto b_desc = [&](int s, int sl, int st) {
    return s_slice_desc(smem_u32(op_smem(s)) + kSMaskOpBytes + sl * L::kSliceBytes + st * 32);
  };
  auto promote = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int i = 0; i < R; ++i) sum[i] += acc[i];
  };
  auto start = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) fence_operand(acc[i]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  };
  auto finish = [&]() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  };
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int m, rt, ct;
    s_tile_coords(tile, n_rt, n_ct, m, rt, ct);
#pragma unroll
    for (int i = 0; i < R; ++i) sum[i] = 0.f;
    for (int kt = 0; kt < n_kt; kt += 2) {
      const int np = n_kt - kt < 2 ? 1 : 2;
      // hi's products over both stages (64 samples) in one run, promoted on
      // landing
      for (int p = 0; p < np; ++p) {
        const uint32_t u = it + p;
        mbar_wait(op_full(u % L::kOps), (u / L::kOps) & 1);
      }
      start();
      for (int p = 0; p < np; ++p) {
        const int s = (it + p) % L::kOps;
#pragma unroll
        for (int st = 0; st < kSSteps; ++st)
          wgmma_ss<N>(acc, a_desc(s, st), b_desc(s, 0, st), p + st != 0);
      }
      finish();
      promote();
      // mid's and lo's products over both stages, one promotion
      start();
      for (int p = 0; p < np; ++p) {
        const int s = (it + p) % L::kOps;
#pragma unroll
        for (int st = 0; st < kSSteps; ++st) {
          wgmma_ss<N>(acc, a_desc(s, st), b_desc(s, 1, st), p + st != 0);
          wgmma_ss<N>(acc, a_desc(s, st), b_desc(s, 2, st), 1);
        }
      }
      finish();
      __syncwarp();
      if (lane == 0) {
        for (int p = 0; p < np; ++p) mbar_arrive(op_empty((it + p) % L::kOps));
      }
      promote();
      it += np;
    }
    float* base = S + static_cast<long long>(m) * D * W;
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb) {
      const int col = ct * N + nb * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rt * kSRows + r_lo + 8 * h;
        if (row >= D) continue;
        float* p = base + static_cast<long long>(row) * W + col;
        const float v0 = sum[nb * 4 + 2 * h], v1 = sum[nb * 4 + 2 * h + 1];
        if (vec_out && col + 1 < W) {
          float2 old = *reinterpret_cast<float2*>(p);
          old.x += v0;
          old.y += v1;
          *reinterpret_cast<float2*>(p) = old;
        } else {
          if (col < W) p[0] += v0;
          if (col + 1 < W) p[1] += v1;
        }
      }
    }
  }
}

template <int N, bool kTma>
cudaError_t s_configure(int device) {
  static bool done[kMaxDevices] = {};
  if (done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(mask_s_bf16x3_kernel<N, kTma>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SLayout<N>::kSmemBytes);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

template <int N, bool kTma>
cudaError_t s_launch(int device, const CUtensorMap& xmap, const CUtensorMap& mmap,
                     const uint8_t* mask, long long mask_ld, const float* sm, const float* scale,
                     float* S, int B, int D, int W, int M, int vec_out, cudaStream_t st) {
  cudaError_t err = s_configure<N, kTma>(device);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>(M) * ((D + kSRows - 1) / kSRows) * ((W + N - 1) / N);
  const int grid = static_cast<int>(tiles < sm_count(device) ? tiles : sm_count(device));
  mask_s_bf16x3_kernel<N, kTma><<<grid, SRoles<N>::kThreads, SLayout<N>::kSmemBytes, st>>>(
      xmap, mmap, mask, mask_ld, sm, scale, S, B, D, W, M, vec_out);
  return cudaGetLastError();
}

// The tile width N of S's columns for this call: of 128, 144 and 160, the
// one whose whole waves of tiles over the multiprocessors take the fewest
// columns' time (a tile's time grows with N), the narrower on a tie.
int s_tile_width(long long D, long long W, long long M, int sms) {
  const int widths[3] = {128, 144, 160};
  int best = widths[0];
  long long best_cost = -1;
  for (int n : widths) {
    const long long tiles = M * ((D + kSRows - 1) / kSRows) * ((W + n - 1) / n);
    const long long cost = (tiles + sms - 1) / sms * n;
    if (best_cost < 0 || cost < best_cost) {
      best = n;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace gemm
}  // namespace ppca

extern "C" {

// The tile width the S kernel takes for (D, W, M) on `device` (0 on a
// failed lookup): chip_smoke.py reports it beside each case.
int mask_s_tile_width(int device, long long D, long long W, long long M) {
  if (ppca::ensure_device(device) != cudaSuccess) return 0;
  return ppca::gemm::s_tile_width(D, W, M, ppca::gemm::sm_count(device));
}

// S (M, D, W) float32 += mask (B, D) bool bytes, row stride mask_ld,
// transposed times scale (M, B) float32 * sm (M, B, W) float32, on
// `stream`; sm, scale and S contiguous.  Returns a cudaError_t (0 on
// success); spd_estep_error_string names it.
int mask_s_bf16x3(int device, const void* mask, long long mask_ld, const void* sm,
                  const void* scale, void* S, long long B, long long D, long long W, long long M,
                  void* stream) {
  using namespace ppca::gemm;
  cudaError_t err = ppca::ensure_device(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || D < 0 || W < 0 || M < 0 || B > INT32_MAX || D > INT32_MAX || W > INT32_MAX ||
      M * D * ((W + 127) / 128) > INT32_MAX)
    return cudaErrorInvalidValue;
  if (B == 0 || D == 0 || W == 0 || M == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = s_tile_width(D, W, M, sm_count(device));
  // TMA reads SM's rows and the mask's where both are 16-byte aligned
  bool tma = W % 4 == 0 && mask_ld % 16 == 0 && reinterpret_cast<uintptr_t>(sm) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  CUtensorMap xmap = {}, mmap = {};
  if (tma) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(B),
                                 static_cast<cuuint64_t>(M)};
    const cuuint64_t xstrides[2] = {static_cast<cuuint64_t>(W) * 4,
                                    static_cast<cuuint64_t>(W) * 4 * B};
    const cuuint32_t xbox[3] = {static_cast<cuuint32_t>(N), kSBK, 1};
    const cuuint64_t mdims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(B)};
    const cuuint64_t mstrides[1] = {static_cast<cuuint64_t>(mask_ld)};
    const cuuint32_t mbox[2] = {kSRows, kSBK};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(sm), xdims, xstrides,
               xbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
        encode(&mmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(mask), mdims, mstrides,
               mbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  const int vec_out = W % 2 == 0 && reinterpret_cast<uintptr_t>(S) % 8 == 0;
  const uint8_t* m8 = static_cast<const uint8_t*>(mask);
  const float* x = static_cast<const float*>(sm);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(S);
  const int b = static_cast<int>(B), d = static_cast<int>(D), w = static_cast<int>(W),
            m = static_cast<int>(M);
#define PPCA_S_LAUNCH(n, t) \
  s_launch<n, t>(device, xmap, mmap, m8, mask_ld, x, sc, out, b, d, w, m, vec_out, st)
  if (N == 128) return tma ? PPCA_S_LAUNCH(128, true) : PPCA_S_LAUNCH(128, false);
  if (N == 144) return tma ? PPCA_S_LAUNCH(144, true) : PPCA_S_LAUNCH(144, false);
  return tma ? PPCA_S_LAUNCH(160, true) : PPCA_S_LAUNCH(160, false);
#undef PPCA_S_LAUNCH
}

}  // extern "C"
