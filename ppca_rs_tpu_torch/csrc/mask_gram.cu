// The masked Gram on Hopper's bf16 tensor cores, exact to float32 sums
// (sm_90a): G = mask @ CC for a block of B samples.
//
// Replaces no TPU kernel: the JAX package leaves `mask @ CC`
// (`ppca_rs_tpu/ops/masked_linalg.py`, `mix_fused.py`) to XLA's dot, and the
// port ran it as a SIMT float32 `torch.matmul`.  It is the largest operation
// of a masked EM step: 2 B D W operations a block (W = the Gram's columns,
// slab_width(64) = 2304 at k=64), 38% of a k=64 iteration and 68% of a
// readout pass as a SIMT product at 66% of the card's 67 TFLOP/s.
//
// The arithmetic.  The mask's 0 and 1 are exact in bf16.  The caller splits
// each float32 column value x of CC once per call into three bf16 slices
// (gram_split_bf16x3 below, one launch),
// hi = bf16(x), mid = bf16(x - hi), lo = x - hi - mid, each step exact (x - hi
// has at most 16 significant bits, x - hi - mid at most 8), so m hi + m mid +
// m lo = m x exactly and the products are exact, as in the SIMT FFMA.  The
// tensor cores (wgmma, float32 accumulators) sum short runs, and each run is
// added into a separate float32 register sum with ordinary FADD (promotion):
// hi's products in runs of kHiRun x 16 = 32 steps of D, mid's and lo's
// together over a stage of kBK = 64.  The tensor cores' adder truncates: one
// accumulator for all three slices over 64 steps read the Gram's diagonal (a
// sum of terms >= 0) 1.95e-7 low on average, since every mid and lo step
// cut the large hi sum under it to its last place; hi apart, in runs short
// enough that their sums are mostly exact, read it 6.8e-9 low, beside the
// SIMT product's +/-1-2e-8 (an H100 80GB HBM3 at 700 W, B = 8192, D = 1024,
// k = 64).  The long sum over D rounds as float32 sums do.
//
// Why by hand: the promotion and the split runs above; the mask is read
// once, as the bool bytes the Dataset holds (8 MB an 8192 x 1024 block,
// where a float32 copy is 32 MB and a library bf16 product would need a
// K-stacked bf16 copy of 48 MB), and turned into bf16 in registers once for
// all three slices; and a mixture's (M, B, W) Gram is written in place,
// component-major.
//
// What bounds it on this card: 3 x 2 B D W bf16 operations (116 GFLOP at B =
// 8192, D = 1024, W = 2304: 117 us at 989 TFLOP/s); the bytes (the mask
// once, G's float32 writes, the slices, which stay in L2) take ~32 us at
// 3.35 TB/s.  So the tensor cores are the floor.  The kernel reaches 50-57%
// of their rate (an H100 80GB HBM3 at 700 W); each CTA tile reads its
// slices' and mask's tiles from L2, ~1 GB a block at 128 x 128 tiles.
//
// The design.  One CTA of 384 threads holds a 128 x 128 tile of G: two
// consumer warpgroups of 64 rows each, one wgmma m64n128k16 a slice and 16
// steps of D with A (the mask) from registers and B (a slice) from shared
// memory, and a producer warpgroup, of which one warp works; it hands its
// registers to the consumers (setmaxnreg: 232 a thread, for the three 64-entry
// accumulators).  The producer fills a ring of kStages stages: the three
// slices' 64 x 128 tiles by TMA (128-byte swizzle, zero-filled past D and
// W), the mask's 128 x 64 bytes by cp.async (zero-filled past B and D).  A
// persistent grid of one CTA a multiprocessor walks the tiles, column tiles
// fastest, or row tiles where the slices outgrow L2.  The
// epilogue writes G straight into the caller's (M, B, W) float32 tensor.
// Ragged B, D and W are masked; D not a multiple of 16 (a model-axis block,
// odd k^2) takes a byte-wise mask copy.
#include <cuda_bf16.h>

#include "gemm_common.cuh"
#include "spd_common.cuh"

namespace ppca {
namespace gemm {

constexpr int kBM = 128;                              // samples (mask rows) a CTA tile
constexpr int kBN = 128;                              // Gram columns a CTA tile
constexpr int kBK = 64;                               // steps of D a stage, one promotion
constexpr int kStages = 4;
constexpr int kStepsPerStage = kBK / 16;              // wgmma k16 steps a stage
constexpr int kHiRun = 2;                             // hi's k16 steps a promotion
constexpr int kSlices = 3;
constexpr int kConsumerWarps = 8;                     // two warpgroups of 64 rows
constexpr int kThreads = (kConsumerWarps + 4) * 32;   // and a producer warpgroup
// Registers a thread after the producer warpgroup hands its own to the
// consumers (setmaxnreg): 128 x 40 + 256 x 232 = the 384 x 168 of the launch.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBoxCols = 64;                          // 128 bytes of bf16: one swizzle row
constexpr int kBoxBytes = kBK * kBoxCols * 2;         // one TMA box, 8 KB
constexpr int kBBytes = kSlices * (kBN / kBoxCols) * kBoxBytes;   // 48 KB a stage
constexpr int kMaskBytes = kBM * kBK;                 // 8 KB a stage
constexpr int kStageBytes = kBBytes + kMaskBytes;
constexpr int kFullArrivals = 1 + 32;                 // the TMA's expect_tx and 32 lanes' mask copies
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;

static_assert(kStageBytes % 1024 == 0, "stages must keep the 1024-byte swizzle alignment");

// wgmma descriptor of a slice's K16 x N128 operand in shared memory, as TMA
// laid it out: N contiguous (MN-major), 128-byte swizzle, 64 columns a
// 128-byte row and 8 K rows a 1024-byte atom; the next 64 columns (the
// leading byte offset) are the next box, 8 KB on, the next 8 K rows (the
// stride byte offset) 1 KB on.
__device__ __forceinline__ uint64_t slice_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(kBoxBytes >> 4) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// d (+)= A B for one warpgroup: A 64 x 16 bf16 in registers, B 16 x 128 bf16
// MN-major in shared memory, d float32; scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// (component, row tile, column tile) of a tile index: the column tiles
// fastest, or the row tiles.
__device__ __forceinline__ void tile_coords(long long tile, int n_rt, int n_ct, int rows_fastest,
                                            int& m, int& rt, int& ct) {
  const int fast = rows_fastest ? n_rt : n_ct, slow = rows_fastest ? n_ct : n_rt;
  const int f = static_cast<int>(tile % fast);
  const long long rest = tile / fast;
  const int q = static_cast<int>(rest % slow);
  m = static_cast<int>(rest / slow);
  rt = rows_fastest ? f : q;
  ct = rows_fastest ? q : f;
}

// Two mask bytes of `word` (picked by `sel`) as a bf16 pair: 0 -> 0, 1 -> 1.0.
__device__ __forceinline__ uint32_t mask_pair(uint32_t word, uint32_t sel) {
  return __byte_perm(word, 0u, sel) * 0x3F80u;
}

// G[m] (B x W, row stride W) = mask (B x D bytes, row stride mask_ld) @
// (hi + mid + lo)[m] for m < M; the slices are the tensor map's planes
// s * M + m.  kVec: D, mask_ld and the mask's address multiples of 16
// (cp.async of 16 bytes), else a byte-wise copy.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    mask_gram_bf16x3_kernel(const __grid_constant__ CUtensorMap slices,
                            const uint8_t* __restrict__ mask, long long mask_ld,
                            float* __restrict__ out, int B, int D, int W, int M, int vec_out,
                            int rows_fastest) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  auto full_bar = [&](int s) { return smem_u32(bars + s); };
  auto empty_bar = [&](int s) { return smem_u32(bars + kStages + s); };
  auto b_smem = [&](int s) { return smem + s * kStageBytes; };
  auto mask_smem = [&](int s) { return smem + s * kStageBytes + kBBytes; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), kFullArrivals);
      mbar_init(empty_bar(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_ct = (W + kBN - 1) / kBN, n_rt = (B + kBM - 1) / kBM;
  const long long n_tiles = static_cast<long long>(M) * n_rt * n_ct;
  const int n_kt = (D + kBK - 1) / kBK;

  if (warp >= kConsumerWarps) {
    // producer: one warp fills the ring, one stage a (tile, k-tile), in the
    // consumers' order; the warpgroup's other three only give up registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps) return;
    uint32_t it = 0;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int m, rt, ct;
      tile_coords(tile, n_rt, n_ct, rows_fastest, m, rt, ct);
      for (int kt = 0; kt < n_kt; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(empty_bar(s), ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full_bar(s), kBBytes);
          for (int sl = 0; sl < kSlices; ++sl)
            for (int h = 0; h < kBN / kBoxCols; ++h)
              tma_load_3d(smem_u32(b_smem(s) + (sl * (kBN / kBoxCols) + h) * kBoxBytes), &slices,
                          full_bar(s), ct * kBN + h * kBoxCols, kt * kBK, sl * M + m);
        }
        // the mask tile: row r's 64 bytes at r * kBK, as 4 chunks of 16
        const uint32_t dst0 = smem_u32(mask_smem(s));
#pragma unroll 4
        for (int i = 0; i < kBM * kBK / 16 / 32; ++i) {
          const int c = lane + 32 * i, r = c >> 2, q = c & 3;
          const int row = rt * kBM + r, col = kt * kBK + 16 * q;
          const bool in = row < B && col < D;
          const uint8_t* src = mask + (in ? row * mask_ld + col : 0);
          if (kVec) {
            cp_async_16(dst0 + r * kBK + 16 * q, src, in ? 16u : 0u);
          } else {
            uint32_t w[4] = {0u, 0u, 0u, 0u};
            if (in) {
              for (int b = 0; b < 16 && col + b < D; ++b)
                w[b >> 2] |= static_cast<uint32_t>(__ldg(src + b)) << (8 * (b & 3));
            }
            *reinterpret_cast<uint4*>(mask_smem(s) + r * kBK + 16 * q) =
                make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
        if (kVec)
          cp_async_arrive(full_bar(s));
        else
          mbar_arrive(full_bar(s));
      }
    }
    if (kVec) asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  // consumers: warp w of warpgroup wg holds tile rows wg*64 + (w%4)*16 + g
  // and + 8, columns (i/4)*8 + 2t + (i%2) of its accumulator entry i
  const int g = lane / 4, t = lane % 4;
  const int r_lo = (warp / 4) * 64 + (warp % 4) * 16 + g;
  const bool odd_word = t >= 2;                       // bytes 2t, 2t+1 of an 8-byte half
  const uint32_t sel = (t & 1) ? 0x4342u : 0x4140u;
  float hacc[64], acc[64], sum[64];   // hi's run, mid's and lo's stage, the sum
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = hacc[i] = 0.f;
  uint32_t it = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int m, rt, ct;
    tile_coords(tile, n_rt, n_ct, rows_fastest, m, rt, ct);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full_bar(s), (it / kStages) & 1);
      __syncwarp();
      // the A fragments of the stage's four k16 steps: rows r_lo and r_lo + 8,
      // steps 2t, 2t+1 (registers 0, 1) and 2t+8, 2t+9 (2, 3) of each
      const uint8_t* row0 = mask_smem(s) + r_lo * kBK;
      const uint32_t b0 = smem_u32(b_smem(s));
      auto desc = [&](int sl, int j) {
        return slice_desc(b0 + sl * (kBN / kBoxCols) * kBoxBytes + j * 16 * kBoxCols * 2);
      };
      uint32_t a[kStepsPerStage][4];
#pragma unroll
      for (int j = 0; j < kStepsPerStage; ++j) {
        const uint4 u = *reinterpret_cast<const uint4*>(row0 + 16 * j);
        const uint4 v = *reinterpret_cast<const uint4*>(row0 + 8 * kBK + 16 * j);
        a[j][0] = mask_pair(odd_word ? u.y : u.x, sel);
        a[j][1] = mask_pair(odd_word ? v.y : v.x, sel);
        a[j][2] = mask_pair(odd_word ? u.w : u.z, sel);
        a[j][3] = mask_pair(odd_word ? v.w : v.z, sel);
      }
      // hi's products into hacc, kHiRun k16 steps a run, each run promoted
      // as soon as it lands while mid's and lo's run on the tensor cores;
      // mid's and lo's products into acc over the whole stage
#pragma unroll
      for (int j = 0; j < kStepsPerStage; ++j) {
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(hacc[i]);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        wgmma_m64n128k16(hacc, a[j], desc(0, j), j % kHiRun != 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        wgmma_m64n128k16(acc, a[j], desc(1, j), j != 0);
        wgmma_m64n128k16(acc, a[j], desc(2, j), 1);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");   // hi's run of step j
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(hacc[i]);
        if ((j + 1) % kHiRun == 0) {
#pragma unroll
          for (int i = 0; i < 64; ++i) sum[i] += hacc[i];
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
#pragma unroll
      for (int j = 0; j < kStepsPerStage; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) fence_operand(a[j][q]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(s));
      // promotion of mid's and lo's stage sum
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
    float* base = out + static_cast<long long>(m) * B * W;
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
      const int col = ct * kBN + nb * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rt * kBM + r_lo + 8 * h;
        if (row >= B) continue;
        float* p = base + static_cast<long long>(row) * W + col;
        const float v0 = sum[nb * 4 + 2 * h], v1 = sum[nb * 4 + 2 * h + 1];
        if (vec_out && col + 1 < W) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          if (col < W) p[0] = v0;
          if (col + 1 < W) p[1] = v1;
        }
      }
    }
  }
}

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <bool kVec>
cudaError_t configure(int device) {
  static bool done[kMaxDevices] = {};
  if (done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(mask_gram_bf16x3_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

long long l2_bytes(int device) {
  static int bytes[kMaxDevices] = {};
  if (bytes[device] == 0) cudaDeviceGetAttribute(&bytes[device], cudaDevAttrL2CacheSize, device);
  return bytes[device];
}

int sm_count(int device) {
  static int count[kMaxDevices] = {};
  if (count[device] == 0) cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device);
  return count[device] > 0 ? count[device] : 1;
}

}  // namespace gemm

namespace split {

// The three bf16 slices of float32 Gram columns in one pass: for each x of
// cc (rows x W), hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
// each difference exact in float32 (no contraction: subtractions only), into
// planes 0, 1, 2 of out (3 x rows x W8), zeros in the columns W..W8-1.
__global__ void bf16x3_split_kernel(const float* __restrict__ cc, __nv_bfloat16* __restrict__ out,
                                    long long rows, int W, int W8) {
  const long long n = rows * W8;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / W8;
    const int c = static_cast<int>(i - r * W8);
    const float x = c < W ? cc[r * W + c] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float r1 = __fsub_rn(x, __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    out[i] = hi;
    out[n + i] = mid;
    out[2 * n + i] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
  }
}

}  // namespace split
}  // namespace ppca

extern "C" {

// The slices of cc (rows x W float32, contiguous) into out (3 x rows x W8
// bf16, W8 >= W), on `stream`.  Returns a cudaError_t.
int gram_split_bf16x3(int device, const void* cc, void* out, long long rows, long long W,
                      long long W8, void* stream) {
  cudaError_t err = ppca::ensure_device(device);
  if (err != cudaSuccess) return err;
  if (rows < 0 || W < 0 || W8 < W || W8 > INT32_MAX) return cudaErrorInvalidValue;
  if (rows == 0 || W8 == 0) return cudaSuccess;
  const long long n = rows * W8;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int grid = static_cast<int>(want < 32 * ppca::gemm::sm_count(device)
                                        ? want : 32 * ppca::gemm::sm_count(device));
  ppca::split::bf16x3_split_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cc), static_cast<__nv_bfloat16*>(out), rows,
      static_cast<int>(W), static_cast<int>(W8));
  return cudaGetLastError();
}


// G (M, B, W) float32 = mask (B, D) bool bytes, row stride mask_ld, @ the
// slices (3, M, D, ld_slices) bf16 (columns W..ld_slices-1 are not read)
// summed, on `stream`.  ld_slices a multiple of 8 (TMA's 16-byte strides),
// W <= ld_slices.  Returns a cudaError_t (0 on success); spd_estep_error_string
// names it.
int mask_gram_bf16x3(int device, const void* mask, long long mask_ld, const void* slices,
                     long long ld_slices, void* out, long long B, long long D, long long W,
                     long long M, void* stream) {
  using namespace ppca::gemm;
  cudaError_t err = ppca::ensure_device(device);
  if (err != cudaSuccess) return err;
  if (B < 0 || D < 0 || W < 0 || M < 0 || W > ld_slices || ld_slices % 8 != 0 ||
      B > INT32_MAX || D > INT32_MAX || W > INT32_MAX || 3 * M > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || W == 0 || M == 0) return cudaSuccess;
  if (D == 0) return cudaMemsetAsync(out, 0, static_cast<size_t>(M * B * W) * sizeof(float), st);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(3 * M)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld_slices) * 2,
                                 static_cast<cuuint64_t>(ld_slices) * 2 * D};
  const cuuint32_t box[3] = {kBoxCols, kBK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(slices), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const bool vec = D % 16 == 0 && mask_ld % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const int vec_out = W % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  // walk the row tiles fastest where the slices outgrow L2, so that each
  // column tile of them is read from device memory once while the mask block
  // stays in L2 (k=256: 402 MB of slices, a 2 MB mask: 1.54 ms a block
  // against 2.45 with the column tiles fastest on an H100); else the column
  // tiles, whose CTAs in flight share mask rows (k=64: 0.209 ms against 0.232)
  const int rows_fastest = 3 * 2 * M * D * W > l2_bytes(device);
  const long long tiles = M * ((B + kBM - 1) / kBM) * ((W + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sm_count(device) ? tiles : sm_count(device));
  const uint8_t* m8 = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  if (vec) {
    if ((err = configure<true>(device)) != cudaSuccess) return err;
    mask_gram_bf16x3_kernel<true><<<grid, kThreads, kSmemBytes, st>>>(
        map, m8, mask_ld, o, static_cast<int>(B), static_cast<int>(D), static_cast<int>(W),
        static_cast<int>(M), vec_out, rows_fastest);
  } else {
    if ((err = configure<false>(device)) != cudaSuccess) return err;
    mask_gram_bf16x3_kernel<false><<<grid, kThreads, kSmemBytes, st>>>(
        map, m8, mask_ld, o, static_cast<int>(B), static_cast<int>(D), static_cast<int>(W),
        static_cast<int>(M), vec_out, rows_fastest);
  }
  return cudaGetLastError();
}

}  // extern "C"
