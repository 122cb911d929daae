// GEMM C[M,N] = A[M,K] @ B[K,N] for Hopper (sm_90a): a ring of shared-memory
// stages fed by TMA, consumed by wgmma with fp32 accumulators (int32 for
// int8), or for fp32 operands by FFMAs on the CUDA cores.
//
// Replaces repro/kernels/matmul/kernel.py::matmul_pallas (a tiled matmul whose
// fp32 accumulator is carried across k-blocks) for bf16, fp16 and fp32 operands,
// and the e4m3 operands repro/kernels/matmul/ops.py::matmul_fp8 runs through
// it; and
// repro/kernels/matmul/kernel.py::matmul_int8_pallas (int8 x int8 -> int32
// block dots summed in fp32, dequantized in the store) for int8 operands.
//
//   bf16  A (M,K) and B (K,N) row-major. wgmma m64n256k16 bf16, A K-major and
//         B read MN-major through the descriptor's transpose bit (16-bit types
//         allow it): no transposed copy of B is made.
//   fp16  as bf16, on fp16 wgmma (m64n256k16.f32.f16.f16): the path the e4m3
//         mode's widened operands take, without the widening.
//   e4m3  A (M,K) row-major, B column-major, stored (N,K): one byte per
//         element comes from device memory, as the TMA brings it. The
//         consumers widen each B tile to fp16 in shared memory (exact:
//         e4m3's 3-bit mantissa and 2^-9..448 range lie inside fp16's; NaN
//         stays NaN), each a share of its rows, into one of two copies, and
//         load their A rows from the raw tile into registers, widened there;
//         fp16 wgmma m64n128k16 takes A from registers and B from the copy,
//         while the next k-tile is widened into the other. Each 128-deep
//         slice of K is added into separate fp32 registers (a promotion
//         every 128 of K).
//   int8  A (M,K) row-major, B stored (N,K), as e4m3 (the TMA loads the same
//         bytes): s8 wgmma m64n256k32, both operands K-major from shared
//         memory, exact int32 sums in registers; the store converts them to
//         fp32 once and scales them, (sum * a_scale[row]) * b_scale[col],
//         the TPU kernel's order. An int32 sum of K products of int8 values
//         is exact while K <= 131071 (K * 128^2 < 2^31); the TPU kernel
//         adds int32 k-block dots in fp32, so any K runs there. Here
//         split_plan cuts K into splits of at most that much (as well as
//         where the output tiles are too few); each split writes its fp32
//         sum to the workspace and splitk_reduce adds them in order and
//         scales the total.
//   fp32  A (M,K) and B (K,N) row-major. IEEE fp32 FFMAs, never TF32 (which
//         keeps about 3 decimal digits and cannot meet 2e-5), by the
//         consumer warps of gemm_f32_sm90 from the same ring: A's k-tile of
//         32 (one 128-byte row per row of A) with the 128-byte swizzle, read
//         as a float4 of 4 k per row, conflict-free; B's 32 rows of BN
//         unswizzled, read as float4 runs along N. One producer warp.
//         Prefill tile (256, 32, 128): 256 consumer threads of 16 x 8 sums
//         (rows 4 apart, columns in two float4 runs), a producer warpgroup
//         that gives its registers to them (setmaxnreg), 4 stages of 48
//         KB.
//         Decode tile (8, 32, 128): M <= 8 rows (none padded beyond 8), 8
//         k-groups of 32 threads, each summing 4 of a stage's 32 k into 8 x 4
//         sums, the groups added in shared memory in order at the end; 4
//         stages of 17 KB, 16 KB of B each, so that a few blocks per SM keep
//         the B stream at the memory rate; K split by split_plan as the
//         other modes.
//
// Why the e4m3 MMAs are fp16. Native e4m3 wgmma (m64n128k32) is compiled
// too, with a promotion into fp32 registers after every 128 of K or after
// every instruction, for the probe in chip_smoke.py. On an H100 both pass
// the per-element check (2^-16 (|A| @ |B|)) and fail the relative one (2e-5
// of the largest output) at every gpt3-175b shape, as torch._scaled_mm
// does: Hopper's tensor cores keep about 14 bits when they sum fp8 products
// (DeepSeek-V3 report, 3.3.2), which no promotion restores inside one
// instruction. So the e4m3 mode runs at the fp16 tensor-core rate: its
// floor is the bf16 bound (5.0 ms at FFN up), not the fp8 one (2.5 ms).
// Both operands need widening, and the fp16 copy of B costs shared-memory
// traffic (raw read, fp16 write, one wgmma read per consumer) that the
// bf16 mode does not pay.
//
// Structure. One producer warpgroup, of which one thread issues the TMA loads
// (cp.async.bulk.tensor, 128-byte swizzle, the layout the wgmma descriptors
// name) of A's and B's k-tiles into a ring of STAGES stages; each stage has a
// full barrier (the TMA's transaction bytes) and an empty barrier (every
// consumer thread arrives once the wgmmas that read the stage are done), so
// a stage is refilled only after its consumers release it. One or two
// consumer warpgroups of 64 rows each issue the wgmmas (wgmma.fence, commit;
// bf16 waits with one group in flight, e4m3 once per k-tile, for the
// promotion) and keep the fp32 sums in registers; with two, setmaxnreg
// moves registers from the producer (24) to them (240). A
// block walks one output tile, blocks in groups of 8 tile rows so that the
// tiles resident at one time share rows of A and columns of B in the L2.
// Edges: the TMA fills rows and columns past M, N and K with zeros; the
// epilogue masks its stores.
//
// Tiles (bm, bk, bn), bk in elements = one 128-byte row of K:
//   bf16  (64, 64, 256) decode, 5 stages of 40 KB; (128, 64, 256) prefill, 4
//         stages of 48 KB;
//   e4m3  (64, 128, 128) decode, 6 stages of 24 KB; (128, 128, 128) prefill,
//         5 stages of 32 KB; both with two fp16 copies of B (64 KB) (native:
//         8 and 6 stages, no copy).
//   int8  (64, 128, 256) decode, 5 stages of 40 KB; (128, 128, 256) prefill,
//         4 stages of 48 KB: bf16's stage bytes, twice its k per stage.
//   fp32  (8, 32, 128) decode, (256, 32, 128) prefill, as above.
//
// What routes a GEMM here (kernels/matmul/kernel.py::tma_eligible): bf16,
// e4m3, int8 or fp32 operands in the layouts above, each base 16-byte
// aligned and each row pitch a multiple of 16 bytes (a TMA descriptor needs
// both). Any other shape (K = 129 or 300 in bf16, N = 77, K or N not a
// multiple of 4 in fp32, a view at an odd offset) goes to matmul.cu (bf16,
// e4m3 on mma.sync, fp32 on its SIMT kernel) or matmul_int8.cu (int8),
// chosen before the launch.
//
// Bounds on an H100: at decode (M = 8) the GEMM reads B once and is bound by
// bytes (gpt3-175b's FFN up, 12288 x 49152 bf16: 1.2 GB, 0.36 ms at 3.35
// TB/s). The 64-row wgmma tile does 8x the useful work there (0.08 ms of
// tensor-core time at FFN up), far below the byte bound. Where the output
// tiles number fewer than twice the 132 SMs (out and FFN down: 48 tiles of
// 256 columns), K is split (kernels/matmul/kernel.py::split_plan): each
// split writes fp32 partials to a workspace, and splitk_reduce sums them in
// split order, so the result is the same from run to run. At a prefill wave
// (M = 4096) the bound is operations (4.95e12 at 989 TFLOP/s bf16: 5.0 ms;
// int8 at 1979 TOPS: 2.5 ms). The s8 wgmma tile reads A and B from shared
// memory once per 64-row consumer, as bf16 does, at twice the operations
// per byte. In fp32, B is 2.4 GB at FFN up, M = 8 (0.72 ms), and a prefill
// wave is 4.95e12 operations at 67 TFLOP/s (73.8 ms): each thread's 16 x 8
// sums take 128 FFMAs per 6 shared-memory loads of 16 bytes (explicit
// ld.shared: through a generic pointer they cost a third of the time), so
// the issue of FFMAs, not shared memory, is the limit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int MODE_BF16 = 0, MODE_E4M3 = 1, MODE_E4M3_WIDE = 2, MODE_S8 = 3, MODE_F16 = 4;
constexpr int GROUP_M = 8;  // tile rows per raster group

// the entries' mode argument: 0 bf16, 1 e4m3 (any form), 2 int8, 3 fp16
__host__ __device__ constexpr int api_mode(int mode) {
  return mode == MODE_BF16 ? 0 : mode == MODE_S8 ? 2 : mode == MODE_F16 ? 3 : 1;
}
// bf16 and fp16: the same 2-byte tiles and layouts, wgmma of their own type
__host__ __device__ constexpr bool two_byte(int mode) {
  return mode == MODE_BF16 || mode == MODE_F16;
}

template <int MODE, int CONS, int BN, int STAGES>
struct Cfg {
  static constexpr int BM = 64 * CONS;
  static constexpr int ES = two_byte(MODE) ? 2 : 1;  // bytes per element in memory
  static constexpr int BK = 128 / ES;                   // one 128-byte swizzle row of K
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BN * 128;  // bf16: BK rows of BN; e4m3: BN rows of BK
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // e4m3 widened: two fp16 copies of the B tile (k-tiles i and i + 1), each
  // two blocks of 64 columns of K by BN rows
  static constexpr int WIDE_BYTES = MODE == MODE_E4M3_WIDE ? 2 * 2 * BN * 128 : 0;
  static constexpr int THREADS = 128 * (CONS + 1);
  static constexpr int SMEM = 1024 + STAGES * STAGE + WIDE_BYTES + 2 * STAGES * 8;
  static constexpr int NACC = BN / 2;  // fp32 (s8: int32) sums per consumer thread
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(two_byte(MODE) || MODE == MODE_S8 ? BN == 256 : BN == 128, "wgmma width");
};

#define F8(i)                                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

#define WGMMA_N256_OUTS                                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                                      \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "                            \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "                            \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                            \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                            \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "                            \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "                            \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                            \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "                    \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "                 \
  "%120, %121, %122, %123, %124, %125, %126, %127"

__device__ __forceinline__ void wgmma_f16_n256(float (&d)[128], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {" WGMMA_N256_OUTS
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
        F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
        F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_f16_rs_n128(float (&d)[64], const uint32_t* a,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_e4m3_n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#define R8(i)                                                                               \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// exact int8 x int8 products summed in int32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56),
        R8(64), R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef F8
#undef R8

// two e4m3 values (low byte first) to two fp16 values, exactly
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t x) {
  uint32_t r;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(r) : "h"(static_cast<uint16_t>(x)));
  return r;
}

// a raw e4m3 tile of ROWS rows (128 bytes each, 128-byte swizzle) widened
// to fp16 in dst, in the K-major swizzled layout the fp16 wgmma reads: two
// blocks of 64 columns of K by ROWS rows of 128 bytes. Thread t0 of THREADS
// takes every THREADS-th 16-byte chunk; all its loads are issued first.
template <int ROWS, int THREADS>
__device__ __forceinline__ void widen(uint8_t* dst, const uint8_t* src, int t0) {
  constexpr int PER = ROWS * 8 / THREADS;
  uint4 v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int t = t0 + u * THREADS, r = t / 8, j = t % 8;
    v[u] = *reinterpret_cast<const uint4*>(src + r * 128 + ((j ^ (r & 7)) * 16));
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int t = t0 + u * THREADS, r = t / 8, j = t % 8;
    const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    uint32_t h[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[2 * i] = e4m3x2_to_f16x2(w[i] & 0xffffu);
      h[2 * i + 1] = e4m3x2_to_f16x2(w[i] >> 16);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = 2 * j + half, kb = q / 8, c = q % 8;  // 16-byte chunk of fp16 row
      *reinterpret_cast<uint4*>(dst + kb * ROWS * 128 + r * 128 + ((c ^ (r & 7)) * 16)) =
          make_uint4(h[4 * half], h[4 * half + 1], h[4 * half + 2], h[4 * half + 3]);
    }
  }
}

// output tile (tm, tn) of block `bid`: GROUP_M tile rows at a time, column by
// column within a group
__device__ __forceinline__ void tile_of(int bid, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = GROUP_M * tiles_n;
  const int first_m = bid / per_group * GROUP_M;
  const int rows = min(tiles_m - first_m, GROUP_M);
  const int in_group = bid % per_group;
  tm = first_m + in_group % rows;
  tn = in_group / rows;
}

// c[idx], c[idx + 1] (columns col, col + 1 of a row), fp32 (out 0), bf16
// (out 1) or fp16 (out 2), skipping columns >= N; `pair` when both may be
// written as one aligned store
__device__ __forceinline__ void store2(void* C, int out, long long idx, int col, int N,
                                       float v0, float v1, bool pair) {
  if (out == 2) {
    __half* c = static_cast<__half*>(C) + idx;
    if (pair && col + 1 < N) {
      *reinterpret_cast<__half2*>(c) = __floats2half2_rn(v0, v1);
    } else {
      if (col < N) c[0] = __float2half_rn(v0);
      if (col + 1 < N) c[1] = __float2half_rn(v1);
    }
  } else if (out == 1) {
    __nv_bfloat16* c = static_cast<__nv_bfloat16*>(C) + idx;
    if (pair && col + 1 < N) {
      *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(v0, v1);
    } else {
      if (col < N) c[0] = __float2bfloat16(v0);
      if (col + 1 < N) c[1] = __float2bfloat16(v1);
    }
  } else {
    float* c = static_cast<float*>(C) + idx;
    if (pair && col + 1 < N) {
      *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
    } else {
      if (col < N) c[0] = v0;
      if (col + 1 < N) c[1] = v1;
    }
  }
}

// MODE_E4M3: PROMOTE = wgmma k32 instructions per promotion into the fp32
// totals (4: every 128 of K, 1: every instruction). C gets the tile of split
// blockIdx.y when P is null; else the split writes fp32 to P[blockIdx.y].
// MODE_S8: C = (float(int32 sum) * sa[row]) * sb[col]; a split writes the
// unscaled fp32 sum to P, and the reduction scales the total.
template <int MODE, int CONS, int BN, int STAGES, int PROMOTE>
__global__ void __launch_bounds__(Cfg<MODE, CONS, BN, STAGES>::THREADS, 1)
gemm_sm90(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          void* __restrict__ C, float* __restrict__ P, const float* __restrict__ sa,
          const float* __restrict__ sb, int M, int N, int K, int out_kind, int kt_per_split) {
  using G = Cfg<MODE, CONS, BN, STAGES>;
  constexpr int BM = G::BM, BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* wide = smem + STAGES * G::STAGE;  // [2][2][BN][128] (e4m3 widened)
  uint64_t* full = reinterpret_cast<uint64_t*>(wide + G::WIDE_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  int tm, tn;
  tile_of(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, tm, tn);
  const int KT = (K + BK - 1) / BK;
  const int kt0 = blockIdx.y * kt_per_split, kt1 = min(KT, kt0 + kt_per_split);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if constexpr (CONS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], G::STAGE);
        uint8_t* a = smem + s * G::STAGE;
        uint8_t* b = a + G::A_BYTES;
        tma_load(a, &map_a, kt * BK, tm * BM, &full[s]);
        if constexpr (two_byte(MODE)) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)  // 64 columns of N by 64 rows of K each
            tma_load(b + j * 64 * 128, &map_b, tn * BN + j * 64, kt * BK, &full[s]);
        } else {
          tma_load(b, &map_b, kt * BK, tn * BN, &full[s]);
        }
      }
    }
    return;
  }

  if constexpr (CONS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;  // this consumer's 64 rows of the tile
  constexpr bool PROMOTES = MODE == MODE_E4M3 || MODE == MODE_E4M3_WIDE;
  using Acc = std::conditional_t<MODE == MODE_S8, int, float>;
  Acc acc[G::NACC];
  float tot[PROMOTES ? G::NACC : 1];
#pragma unroll
  for (int i = 0; i < G::NACC; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < (PROMOTES ? G::NACC : 1); ++i) tot[i] = 0.f;
  auto promote = [&]() {
    if constexpr (PROMOTES) {
#pragma unroll
      for (int i = 0; i < G::NACC; ++i) tot[i] += acc[i];
    }
  };

  if constexpr (MODE == MODE_E4M3_WIDE) {
    // k-tile i: the consumers widen B's rows to fp16 (each a share) into
    // copy i % 2 and load their A rows into registers, widened; the wgmmas
    // of tile i (A from registers, B from copy i % 2) run while tile i + 1
    // is widened into the other copy and its A rows are loaded
    const int n = kt1 - kt0, lane = tid % 32;
    const int ar = c * 64 + tid / 32 * 16 + lane / 4;  // this thread's A row (and ar + 8)
    const bool live[2] = {tm * BM + ar < M, tm * BM + ar + 8 < M};  // rows past M are 0
    uint32_t a0[32], a1[32];  // A fragments of 8 k16 steps, fp16 pairs, of two k-tiles
    auto stage_in = [&](int i, uint32_t(&a)[32]) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint8_t* raw = smem + s * G::STAGE;
      widen<BN, CONS * 128>(wide + (i & 1) * 2 * BN * 128, raw + G::A_BYTES, c * 128 + tid);
#pragma unroll
      for (int q = 0; q < 32; ++q) {  // rows ar (+8), k 16(q/4) + 2(lane%4) (+8)
        const int r = ar + (q & 1) * 8, k = q / 4 * 16 + (lane % 4) * 2 + (q & 2) * 4;
        a[q] = live[q & 1] ? e4m3x2_to_f16x2(*reinterpret_cast<const uint16_t*>(
                                 raw + r * 128 + (((k / 16) ^ (r & 7)) * 16) + k % 16))
                           : 0u;
      }
      mbar_arrive(&empty[s]);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    // tile i from `cur` while tile i + 1 is loaded into `nxt`
    auto step = [&](int i, uint32_t(&cur)[32], uint32_t(&nxt)[32]) {
      const uint32_t b = smem_addr(wide + (i & 1) * 2 * BN * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_f16_rs_n128(acc, cur + 4 * kk,
                          desc(b + kk / 4 * BN * 128 + kk % 4 * 32, 16, 1024), kk != 0);
      wgmma_commit();
      if (i + 1 < n) stage_in(i + 1, nxt);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(cur);
      promote();  // every 128 of K
      bar_sync(1, CONS * 128);  // tile i + 1 widened by all; copy i % 2 free
    };
    if (n > 0) {
      stage_in(0, a0);
      bar_sync(1, CONS * 128);
    }
    for (int i = 0; i < n; i += 2) {
      step(i, a0, a1);
      if (i + 1 < n) step(i + 1, a1, a0);
    }
  } else {
    int prev = -1;
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint32_t a = smem_addr(smem + s * G::STAGE) + c * 64 * 128;
      const uint32_t b = smem_addr(smem + s * G::STAGE + G::A_BYTES);
      if constexpr (two_byte(MODE)) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // k16 steps: 32 bytes along A's rows, 16 rows of B
          if constexpr (MODE == MODE_F16)
            wgmma_f16_n256(acc, desc(a + kk * 32, 16, 1024), desc(b + kk * 2048, 64 * 128, 1024),
                           1);
          else
            wgmma_bf16_n256(acc, desc(a + kk * 32, 16, 1024),
                            desc(b + kk * 2048, 64 * 128, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-tile's wgmmas are done: release its stage
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = s;
      } else if constexpr (MODE == MODE_E4M3) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // k32 steps: 32 bytes along both operands' rows
          if (kk % PROMOTE == 0) wgmma_fence();
          wgmma_e4m3_n128(acc, desc(a + kk * 32, 16, 1024), desc(b + kk * 32, 16, 1024),
                          kk % PROMOTE != 0);
          if ((kk + 1) % PROMOTE == 0) {
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            promote();
          }
        }
        mbar_arrive(&empty[s]);
      } else if constexpr (MODE == MODE_S8) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // k32 steps: 32 bytes along both operands' rows
          wgmma_s8_n256(acc, desc(a + kk * 32, 16, 1024), desc(b + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-tile's wgmmas are done: release its stage
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // sums: thread (warp w, lane l) holds rows 16w + l/4 (+8) of its 64, and
  // columns 8j + 2(l%4) (+1): register 4j + 2h + e
  auto sum = [&](int i) {
    if constexpr (PROMOTES) return tot[i];
    else return static_cast<float>(acc[i]);
  };
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = tm * BM + c * 64 + warp * 16 + lane / 4;
  const bool pair = (N & 1) == 0;
  void* out = P ? static_cast<void*>(P + static_cast<long long>(blockIdx.y) * M * N) : C;
  const int kind = P ? 0 : out_kind;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = tn * BN + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      float v0 = sum(4 * j + 2 * h), v1 = sum(4 * j + 2 * h + 1);
      if (MODE == MODE_S8 && P == nullptr) {  // (acc * a_scale) * b_scale
        const float s_row = sa[row];
        v0 = v0 * s_row * sb[col];
        v1 = col + 1 < N ? v1 * s_row * sb[col + 1] : 0.f;
      }
      store2(out, kind, static_cast<long long>(row) * N + col, col, N, v0, v1, pair);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: IEEE FFMAs on the CUDA cores, fed by the same TMA ring
// ---------------------------------------------------------------------------

// Tile (BM, 32, BN): a stage holds A's BM rows of 32 k (128 bytes each, the
// 128-byte swizzle, so that the four rows a warp reads at one k land in four
// bank groups) and B's 32 rows of BN (unswizzled: a warp reads a row's
// contiguous floats). CONSUMERS threads in KG groups, each group summing its
// own 32 / KG k of every stage; a thread of a group holds TM x TN sums, its
// rows WROWS apart and its columns in float4 runs. KG > 1 (decode, where
// M <= 8 leaves few outputs per block) adds the groups' sums in shared
// memory, in group order, at the end.
template <int BM, int BN, int TM, int TN, int KG, int STAGES, int WG>
struct F32 {
  static constexpr int BK = 32;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BK * BN * 4;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int GROUP = (BM / TM) * (BN / TN);    // threads of a k-group
  static constexpr int CONSUMERS = KG * GROUP;
  // and one producer warp, or with WG a producer warpgroup that hands its
  // registers to the consumers (setmaxnreg), for thread tiles of 128 sums
  static constexpr int THREADS = CONSUMERS + (WG ? 128 : 32);
  static constexpr int WROWS = BM / TM < 4 ? BM / TM : 4;  // thread rows of a warp
  static constexpr int WCOLS = 32 / WROWS;
  static constexpr int WX = BN / TN / WCOLS;              // warps across N
  static constexpr int WPG = GROUP / 32;                  // warps of a k-group
  static constexpr int KPT = BK / KG;                     // k of a stage per group
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = KG > 1 ? KG * BM * BN * 4 : 0;
  static constexpr int BODY = RING > RED ? RING : RED;
  static constexpr int SMEM = 1024 + BODY + 2 * STAGES * 8;
  static_assert(GROUP % 32 == 0 && KPT % 4 == 0 && TN % 4 == 0 && WX * WCOLS * TN == BN &&
                    STAGE % 1024 == 0,
                "fp32 tile: whole warps, float4 runs, 1024-byte aligned stages");
  static_assert(SMEM <= 232448, "shared memory");
};

// 16 bytes of shared memory at a shared-space address (an explicit ld.shared:
// a pointer rounded up through an integer has lost its address space)
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float2 lds64(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// C (or split blockIdx.y's fp32 partial in P) = A (M,K) @ B (K,N), fp32
template <int BM, int BN, int TM, int TN, int KG, int STAGES, int WG>
__global__ void __launch_bounds__(F32<BM, BN, TM, TN, KG, STAGES, WG>::THREADS, 1)
gemm_f32_sm90(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              void* __restrict__ C, float* __restrict__ P, int M, int N, int K, int out_kind,
              int kt_per_split) {
  using G = F32<BM, BN, TM, TN, KG, STAGES, WG>;
  constexpr int BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BODY);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int tm, tn;
  tile_of(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, tm, tn);
  const int KT = (K + BK - 1) / BK;
  const int kt0 = blockIdx.y * kt_per_split, kt1 = min(KT, kt0 + kt_per_split);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G::CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= G::CONSUMERS / 32) {  // producer
    if constexpr (WG) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == G::CONSUMERS) {
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], G::STAGE);
        uint8_t* a = smem + s * G::STAGE;
        tma_load(a, &map_a, kt * BK, tm * BM, &full[s]);
        tma_load(a + G::A_BYTES, &map_b, tn * BN, kt * BK, &full[s]);
      }
    }
    return;
  }
  if constexpr (WG) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int kg = warp / G::WPG, wi = warp % G::WPG, wy = wi / G::WX, wx = wi % G::WX;
  const int ly = lane / G::WCOLS, lx = lane % G::WCOLS;
  const int r0 = wy * G::WROWS * TM + ly;      // row r0 + i WROWS of the tile, i < TM
  const int c0 = wx * G::WCOLS * TN + lx * 4;  // columns c0 + j 4 WCOLS + (0..3), j < TN/4
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t as = smem_addr(smem + s * G::STAGE);
    const uint32_t bs = as + G::A_BYTES + c0 * 4;
#pragma unroll
    for (int q = 0; q < G::KPT / 4; ++q) {
      const int k4 = kg * G::KPT + 4 * q;  // 4 k: one float4 of each A row
      float4 a[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int row = r0 + r * G::WROWS;
        a[r] = lds128(as + row * 128 + (((k4 / 4) ^ (row & 7)) * 16));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) {
          const float4 x = lds128(bs + ((k4 + kk) * BN + j * 4 * G::WCOLS) * 4);
          b[4 * j] = x.x;
          b[4 * j + 1] = x.y;
          b[4 * j + 2] = x.z;
          b[4 * j + 3] = x.w;
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float x = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(x, b[j], acc[r][j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  void* out = P ? static_cast<void*>(P + static_cast<long long>(blockIdx.y) * M * N) : C;
  const int kind = P ? 0 : out_kind;
  const bool pair = (N & 1) == 0;
  if constexpr (KG == 1) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = tm * BM + r0 + r * G::WROWS;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const int col = tn * BN + c0 + j * 4 * G::WCOLS;
        const long long idx = static_cast<long long>(row) * N + col;
        store2(out, kind, idx, col, N, acc[r][4 * j], acc[r][4 * j + 1], pair);
        store2(out, kind, idx + 2, col + 2, N, acc[r][4 * j + 2], acc[r][4 * j + 3], pair);
      }
    }
  } else {
    // the groups' sums through shared memory (the ring is drained: every
    // stage the producer filled has been waited on), added in group order
    const uint32_t red = smem_addr(smem);  // [KG][BM][BN] fp32
    bar_sync(1, G::CONSUMERS);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < TN / 4; ++j)
        sts128(red + ((kg * BM + r0 + r * G::WROWS) * BN + c0 + j * 4 * G::WCOLS) * 4,
               make_float4(acc[r][4 * j], acc[r][4 * j + 1], acc[r][4 * j + 2],
                           acc[r][4 * j + 3]));
    bar_sync(1, G::CONSUMERS);
    for (int e = 2 * threadIdx.x; e < BM * BN; e += 2 * G::CONSUMERS) {
      const int r = e / BN, c = e % BN;
      const int row = tm * BM + r, col = tn * BN + c;
      float2 v = lds64(red + (r * BN + c) * 4);
      float v0 = v.x, v1 = v.y;
#pragma unroll
      for (int g = 1; g < KG; ++g) {
        v = lds64(red + ((g * BM + r) * BN + c) * 4);
        v0 += v.x;
        v1 += v.y;
      }
      if (row < M) store2(out, kind, static_cast<long long>(row) * N + col, col, N, v0, v1, pair);
    }
  }
}

// C = sum over the splits of P[s] (M*N fp32 each), in split order; with
// scales, times sa[row] and then sb[col] (row-major C of N columns)
__global__ void splitk_reduce(const float* __restrict__ P, void* __restrict__ C, long long MN,
                              int splits, int out_kind, const float* __restrict__ sa,
                              const float* __restrict__ sb, int N) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= MN) return;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  const int n = MN - i < 4 ? static_cast<int>(MN - i) : 4;
  if (n == 4 && MN % 4 == 0) {
    for (int s = 0; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(P + s * MN + i);
      v[0] += p.x;
      v[1] += p.y;
      v[2] += p.z;
      v[3] += p.w;
    }
  } else {
    for (int s = 0; s < splits; ++s)
      for (int e = 0; e < n; ++e) v[e] += P[s * MN + i + e];
  }
  for (int e = 0; e < n; ++e) {
    if (sa != nullptr) v[e] = v[e] * sa[(i + e) / N] * sb[(i + e) % N];
    if (out_kind == 2)
      static_cast<__half*>(C)[i + e] = __float2half_rn(v[e]);
    else if (out_kind == 1)
      static_cast<__nv_bfloat16*>(C)[i + e] = __float2bfloat16(v[e]);
    else
      static_cast<float*>(C)[i + e] = v[e];
  }
}

// a row-major (rows, cols) array of `es`-byte elements of type `type`, read
// in boxes of box_cols x box_rows with the given swizzle; false if refused
bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int es,
              long long rows, long long cols, int box_cols, int box_rows,
              CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(cols * es)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, pitch, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the bf16, fp16, e4m3 and int8 tiles: the 128-byte swizzle the wgmma
// descriptors name (a 2-byte map is described as bf16 for fp16 too: the copy
// moves bits, and nothing out of bounds is filled with a NaN)
bool make_map_mma(CUtensorMap* map, const void* base, int es, long long rows, long long cols,
                  int box_cols, int box_rows) {
  return make_map(map, base,
                  es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, es,
                  rows, cols, box_cols, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int MODE, int CONS, int BN, int STAGES, int PROMOTE>
int launch(const void* a, const void* b, void* c, float* p, const float* sa, const float* sb,
           int M, int N, int K, int out_kind, int kt_per_split, int splits, cudaStream_t stream) {
  using G = Cfg<MODE, CONS, BN, STAGES>;
  CUtensorMap map_a, map_b;
  bool ok = make_map_mma(&map_a, a, G::ES, M, K, G::BK, G::BM);
  if constexpr (two_byte(MODE))
    ok = ok && make_map_mma(&map_b, b, 2, K, N, 64, G::BK);  // (K,N): 64 of N by BK of K
  else
    ok = ok && make_map_mma(&map_b, b, 1, N, K, G::BK, BN);  // (N,K): BK of K by BN of N
  if (!ok) return -2;
  auto kernel = gemm_sm90<MODE, CONS, BN, STAGES, PROMOTE>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  const dim3 grid(((M + G::BM - 1) / G::BM) * ((N + BN - 1) / BN), splits);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(map_a, map_b, c, p, sa, sb, M, N, K, out_kind,
                                                kt_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int TM, int TN, int KG, int STAGES, int WG>
int launch_f32(const void* a, const void* b, void* c, float* p, int M, int N, int K,
               int out_kind, int kt_per_split, int splits, cudaStream_t stream) {
  using G = F32<BM, BN, TM, TN, KG, STAGES, WG>;
  CUtensorMap map_a, map_b;
  // A (M,K): 32 of K (128 bytes, swizzled) by BM rows; B (K,N): BN of N by 32 of K
  const bool ok = make_map(&map_a, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K, G::BK, BM,
                           CU_TENSOR_MAP_SWIZZLE_128B) &&
                  make_map(&map_b, b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K, N, BN, G::BK,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return -2;
  auto kernel = gemm_f32_sm90<BM, BN, TM, TN, KG, STAGES, WG>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  const dim3 grid(((M + BM - 1) / BM) * ((N + BN - 1) / BN), splits);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(map_a, map_b, c, p, M, N, K, out_kind,
                                                kt_per_split);
  return static_cast<int>(cudaGetLastError());
}

// the compiled tiles: mode, e4m3 form, bm, bk, bn, stages, k32 instructions
// per promotion (native e4m3)
#define TILES_SM90                              \
  TILE(MODE_BF16, 0, 64, 64, 256, 5, 1)         \
  TILE(MODE_BF16, 0, 128, 64, 256, 4, 1)        \
  TILE(MODE_F16, 0, 64, 64, 256, 5, 1)          \
  TILE(MODE_F16, 0, 128, 64, 256, 4, 1)         \
  TILE(MODE_E4M3_WIDE, 0, 64, 128, 128, 6, 1)   \
  TILE(MODE_E4M3_WIDE, 0, 128, 128, 128, 5, 1)  \
  TILE(MODE_E4M3, 1, 64, 128, 128, 8, 4)        \
  TILE(MODE_E4M3, 1, 128, 128, 128, 6, 4)       \
  TILE(MODE_E4M3, 2, 64, 128, 128, 8, 1)        \
  TILE(MODE_E4M3, 2, 128, 128, 128, 6, 1)       \
  TILE(MODE_S8, 0, 64, 128, 256, 5, 1)          \
  TILE(MODE_S8, 0, 128, 128, 256, 4, 1)

// the compiled fp32 tiles: bm, bn, thread rows, thread columns, k-groups,
// stages, producer warpgroup (bk = 32)
#define F32_TILES_SM90              \
  F32_TILE(8, 128, 8, 4, 8, 4, 0)   \
  F32_TILE(256, 128, 16, 8, 1, 4, 1)

}  // namespace

// mode 0 bf16, 1 e4m3 (B stored (N,K)), 3 fp16; out_kind 0 fp32, 1 bf16, 2
// fp16; e4m3_form 0 widened to fp16, 1
// native with a promotion every 128 of K, 2 native with one every 32.
// (bm, bk, bn) must be a compiled tile (kernels/matmul/kernel.py::TILES) and
// the operands TMA-describable (kernel.py::tma_eligible). p null: C gets the
// product, splits must be 1; else split s of the K range [s, s + 1) *
// kt_per_split k-tiles writes fp32 to p + s M N, summed by matmul_sm90_reduce.
// Returns -1 for a tile not compiled, -2 if a TMA descriptor is refused, else
// cudaGetLastError() after the launch.
extern "C" int matmul_sm90_fwd(const void* a, const void* b, void* c, float* p, int mode,
                               int e4m3_form, int M, int N, int K, int bm, int bk, int bn,
                               int kt_per_split, int splits, int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TILE(MODE_, FORM, BM, BK, BN, STAGES, PROMOTE)                                  \
  if (MODE_ != MODE_S8 && mode == api_mode(MODE_) &&                                     \
      (two_byte(MODE_) || e4m3_form == FORM) && bm == BM && bk == BK && bn == BN)         \
    return launch<MODE_, BM / 64, BN, STAGES, PROMOTE>(a, b, c, p, nullptr, nullptr, M, N, \
                                                       K, out_kind, kt_per_split, splits, s);
  TILES_SM90
#undef TILE
  return -1;
}

// int8: a (M,K) row-major, b stored (N,K), sa (M) and sb (N) fp32, c (M,N)
// fp32 = (a @ b) * sa[row] * sb[col]. p null: one split; else split s
// writes its unscaled fp32 sum to p + s M N, and matmul_sm90_reduce with the
// scales gives c. Each split must span at most 131071 of K, so that its
// int32 sums are exact. Returns as matmul_sm90_fwd.
extern "C" int matmul_sm90_s8_fwd(const void* a, const void* b, const float* sa,
                                  const float* sb, float* c, float* p, int M, int N, int K,
                                  int bm, int bk, int bn, int kt_per_split, int splits,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TILE(MODE_, FORM, BM, BK, BN, STAGES, PROMOTE)                                  \
  if (MODE_ == MODE_S8 && bm == BM && bk == BK && bn == BN)                              \
    return launch<MODE_, BM / 64, BN, STAGES, PROMOTE>(a, b, c, p, sa, sb, M, N, K, 0,     \
                                                       kt_per_split, splits, s);
  TILES_SM90
#undef TILE
  return -1;
}

// fp32: a (M,K) and b (K,N) row-major, TMA-describable (K and N multiples of
// 4, 16-byte aligned bases); (bm, bk, bn) a compiled fp32 tile; p and splits
// as matmul_sm90_fwd's. Returns as matmul_sm90_fwd.
extern "C" int matmul_sm90_f32_fwd(const void* a, const void* b, void* c, float* p, int M,
                                   int N, int K, int bm, int bk, int bn, int kt_per_split,
                                   int splits, int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F32_TILE(BM, BN, TM, TN, KG, STAGES, WG)                                  \
  if (bm == BM && bk == 32 && bn == BN)                                           \
    return launch_f32<BM, BN, TM, TN, KG, STAGES, WG>(a, b, c, p, M, N, K, out_kind, \
                                                      kt_per_split, splits, s);
  F32_TILES_SM90
#undef F32_TILE
  return -1;
}

// dynamic shared memory (bytes) of a compiled tile's kernel, -1 if none;
// mode 0 bf16, 1 e4m3, 2 int8, 3 fp16, 4 fp32
extern "C" int matmul_sm90_smem(int mode, int e4m3_form, int bm, int bk, int bn) {
#define F32_TILE(BM, BN, TM, TN, KG, STAGES, WG) \
  if (mode == 4 && bm == BM && bk == 32 && bn == BN) return F32<BM, BN, TM, TN, KG, STAGES, WG>::SMEM;
  F32_TILES_SM90
#undef F32_TILE
#define TILE(MODE_, FORM, BM, BK, BN, STAGES, PROMOTE)                                  \
  if (mode == api_mode(MODE_) && ((MODE_ != MODE_E4M3 && MODE_ != MODE_E4M3_WIDE) ||     \
                                  e4m3_form == FORM) &&                                  \
      bm == BM && bk == BK && bn == BN)                                                  \
    return Cfg<MODE_, BM / 64, BN, STAGES>::SMEM;
  TILES_SM90
#undef TILE
  return -1;
}

// c (M*N, fp32 or bf16) = the sum of `splits` fp32 partials p[s] in order;
// with scales (sa, sb not null; c row-major of N columns), times sa[row]
// and then sb[col]
extern "C" int matmul_sm90_reduce(const float* p, void* c, long long MN, int splits,
                                  int out_kind, const float* sa, const float* sb, int N,
                                  void* stream) {
  const long long threads = (MN + 3) / 4;
  splitk_reduce<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(p, c, MN, splits, out_kind, sa, sb, N);
  return static_cast<int>(cudaGetLastError());
}
