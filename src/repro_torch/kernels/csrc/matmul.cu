// Tiled GEMM C[M,N] = A[M,K] @ B[K,N] for Hopper (sm_90a), in three input
// modes, always accumulating in fp32.
//
// Replaces repro/kernels/matmul/kernel.py::matmul_pallas (a tiled matmul whose
// fp32 accumulator is carried across k-blocks) for fp32 operands, and for
// the bf16 and e4m3 operands the TMA kernel of matmul_sm90.cu cannot take:
// a base that is not 16-byte aligned or a row pitch that is not a multiple
// of 16 bytes (K = 129 or 300 in bf16, N = 77, a view at an odd offset),
// chosen before the launch by kernels/matmul/kernel.py::tma_eligible. That
// file's note accounts for the bf16 and e4m3 GEMMs at the served widths.
//
//   bf16  A (M,K) and B (K,N) row-major. mma.sync m16n8k16 bf16 with fp32
//         accumulation; operands fetched from shared memory with ldmatrix,
//         B transposed on the way (.trans).
//   e4m3  A (M,K) row-major, B (K,N) column-major, i.e. stored (N,K). One
//         byte per element is read; each value is widened to fp16 as its
//         tile is stored in shared memory (exact) and multiplied by fp16
//         mma.sync m16n8k16; each 128-deep slice of K is added into separate
//         fp32 registers (a promotion every 128 of K; see matmul_sm90.cu for
//         why the e4m3 MMAs are not native).
//   fp32  A (M,K) and B (K,N) row-major. IEEE fp32 FMAs on the CUDA cores,
//         never TF32 (which keeps about 3 decimal digits and cannot meet
//         2e-5): 256 threads, each an 8x8 / 4x4 / 2x2 register block.
//
// Every mode stages tiles of A and B through registers into a double buffer
// in shared memory: the loads of tile k+1 are issued before the MMAs of tile
// k, one barrier per tile. Edges are masked, not padded: loads outside the
// matrix read zero and stores outside it are skipped. A 16-byte vector load
// serves a chunk when its operand's base and row pitch are 16-byte aligned;
// otherwise each element is loaded on its own. Blocks walk the output tiles
// in groups of 8 tile rows, so that the tiles resident at one time share
// rows of A and columns of B in the L2.
//
// Bound on an H100: at decode (M = 8) the fp32 mode reads B once and is
// bound by bytes (gpt3-175b's FFN up, 12288 x 49152: 2.4 GB, 0.72 ms at 3.35
// TB/s); at a prefill wave (M = 4096) by operations (4.95e12 at 67 TFLOP/s:
// 73.8 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MODE_BF16 = 0, MODE_E4M3 = 1, MODE_F32 = 2;
constexpr int GROUP_M = 8;  // tile rows per raster group

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 fp32) += a (16x16, row-major) * b (16x8, column-major), bf16 or fp16
template <int MODE>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (MODE == MODE_BF16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two e4m3 values (low byte first) to two fp16 values, exactly
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t x) {
  uint32_t r;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(r) : "h"(static_cast<uint16_t>(x)));
  return r;
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

// 16 bytes at element (r, c) of a row-major (rows, cols) array of ES-byte
// elements with row pitch ld elements; elements outside the array read 0
template <int ES>
__device__ __forceinline__ uint4 load16(const uint8_t* base, long long ld, int rows, int cols,
                                        int r, int c, bool vec) {
  constexpr int CE = 16 / ES;
  if (r >= rows) return make_uint4(0, 0, 0, 0);
  const uint8_t* p = base + ((long long)r * ld + c) * ES;
  if (vec && c + CE <= cols) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c + i / ES < cols) w[i / 4] |= static_cast<uint32_t>(p[i]) << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// store a loaded chunk at dst (16-bit elements): as it is, or widened from e4m3
template <int MODE>
__device__ __forceinline__ void stage16(uint16_t* dst, const uint4 v) {
  if constexpr (MODE == MODE_BF16) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[2 * i] = e4m3x2_to_f16x2(w[i] & 0xffffu);
      h[2 * i + 1] = e4m3x2_to_f16x2(w[i] >> 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(dst + 8) = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// c[idx], c[idx + 1] (columns col, col + 1 of a row), fp32 or bf16, skipping
// columns >= N; `pair` when both may be written as one aligned store
__device__ __forceinline__ void store2(void* C, int out_bf16, long long idx, int col, int N,
                                       float v0, float v1, bool pair) {
  if (out_bf16) {
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

// ---------------------------------------------------------------------------
// bf16 and e4m3: tensor-core tiles
// ---------------------------------------------------------------------------

template <int MODE, int BM, int BN, int BK, int WM, int WN>
struct Tc {
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr bool B_KN = MODE == MODE_BF16;  // B staged [BK][BN], else [BN][BK]
  static constexpr int LDA = BK + 8;               // 16-bit elements; 16-byte pad
  static constexpr int LDB = B_KN ? BN + 8 : BK + 8;
  static constexpr int A_STAGE = BM * LDA;
  static constexpr int B_STAGE = (B_KN ? BK : BN) * LDB;
  static constexpr int SMEM = 2 * (A_STAGE + B_STAGE) * 2;  // bytes
  static constexpr int ES = MODE == MODE_BF16 ? 2 : 1;      // bytes per element in memory
  static constexpr int CE = 16 / ES;                        // elements per 16-byte chunk
  static constexpr int A_CH = BM * BK / CE, B_CH = BK * BN / CE;
  static constexpr int A_PT = (A_CH + THREADS - 1) / THREADS;
  static constexpr int B_PT = (B_CH + THREADS - 1) / THREADS;
  static constexpr int PROMOTE = 128 / BK;  // e4m3: k-tiles per promotion
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 16 == 0, "tile");
  static_assert(BK % 16 == 0 && 128 % BK == 0, "k tile");
};

template <int MODE, int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(Tc<MODE, BM, BN, BK, WM, WN>::THREADS)
gemm_tc(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B, void* __restrict__ C,
        int M, int N, int K, int out_bf16, int vec_a, int vec_b) {
  using T = Tc<MODE, BM, BN, BK, WM, WN>;
  constexpr int ES = T::ES, CE = T::CE;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* As = smem;                   // [2][BM][LDA]
  uint16_t* Bs = smem + 2 * T::A_STAGE;  // [2][BK][LDB] (bf16) or [2][BN][LDB] (e4m3)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = warp / T::WARPS_N * WM, wn0 = warp % T::WARPS_N * WN;
  int tm, tn;
  tile_of(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;

  uint4 ra[T::A_PT], rb[T::B_PT];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < T::A_PT; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::A_CH) {
        const int r = c / (BK / CE), col = c % (BK / CE) * CE;
        ra[i] = load16<ES>(A, K, M, K, m0 + r, k0 + col, vec_a);
      }
    }
#pragma unroll
    for (int i = 0; i < T::B_PT; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::B_CH) {
        if constexpr (T::B_KN) {
          const int r = c / (BN / CE), col = c % (BN / CE) * CE;
          rb[i] = load16<ES>(B, N, K, N, k0 + r, n0 + col, vec_b);
        } else {
          const int r = c / (BK / CE), col = c % (BK / CE) * CE;
          rb[i] = load16<ES>(B, K, N, K, n0 + r, k0 + col, vec_b);
        }
      }
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int i = 0; i < T::A_PT; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::A_CH) {
        const int r = c / (BK / CE), col = c % (BK / CE) * CE;
        stage16<MODE>(As + s * T::A_STAGE + r * T::LDA + col, ra[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < T::B_PT; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::B_CH) {
        constexpr int PER_ROW = (T::B_KN ? BN : BK) / CE;
        const int r = c / PER_ROW, col = c % PER_ROW * CE;
        stage16<MODE>(Bs + s * T::B_STAGE + r * T::LDB + col, rb[i]);
      }
    }
  };

  float acc[T::MI][T::NI][4];
  float tot[MODE == MODE_E4M3 ? T::MI : 1][MODE == MODE_E4M3 ? T::NI : 1][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  if constexpr (MODE == MODE_E4M3) {
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[mi][ni][e] = 0.f;
  }

  const int KT = (K + BK - 1) / BK;
  if (KT > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load((kt + 1) * BK);  // in flight during this tile's MMAs
    const uint16_t* as = As + cur * T::A_STAGE;
    const uint16_t* bs = Bs + cur * T::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
        ldsm_x4(af[mi], as + (wm0 + mi * 16 + (lane & 15)) * T::LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < T::NI / 2; ++nj) {
        uint32_t bf[4];  // b0, b1 of n-blocks 2nj and 2nj + 1
        if constexpr (T::B_KN)
          ldsm_x4_trans(bf, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * T::LDB + wn0 +
                                nj * 16 + (lane >> 4) * 8);
        else
          ldsm_x4(bf, bs + (wn0 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * T::LDB + kk +
                          ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) {
          mma16816<MODE>(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma16816<MODE>(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    if constexpr (MODE == MODE_E4M3) {
      if ((kt + 1) % T::PROMOTE == 0 || kt + 1 == KT) {
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[mi][ni][e] += acc[mi][ni][e];
              acc[mi][ni][e] = 0.f;
            }
      }
    }
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

  // accumulator layout: lane holds rows lane/4 and lane/4 + 8, columns
  // 2 (lane % 4) + {0, 1} of each 16x8 block
  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + mi * 16 + (lane >> 2) + 8 * h;
        const int col = n0 + wn0 + ni * 8 + (lane & 3) * 2;
        if (row >= M) continue;
        float v0, v1;
        if constexpr (MODE == MODE_E4M3) {
          v0 = tot[mi][ni][2 * h];
          v1 = tot[mi][ni][2 * h + 1];
        } else {
          v0 = acc[mi][ni][2 * h];
          v1 = acc[mi][ni][2 * h + 1];
        }
        store2(C, out_bf16, (long long)row * N + col, col, N, v0, v1, pair);
      }
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs on the CUDA cores
// ---------------------------------------------------------------------------

// 4 floats at (r, c) of a row-major (rows, cols) array; zeros outside it
__device__ __forceinline__ float4 load4(const float* base, long long ld, int rows, int cols, int r,
                                        int c, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= rows) return v;
  const float* p = base + (long long)r * ld + c;
  if (vec && c + 4 <= cols) return __ldg(reinterpret_cast<const float4*>(p));
  if (c < cols) v.x = p[0];
  if (c + 1 < cols) v.y = p[1];
  if (c + 2 < cols) v.z = p[2];
  if (c + 3 < cols) v.w = p[3];
  return v;
}

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(256)
gemm_f32(const float* __restrict__ A, const float* __restrict__ B, void* __restrict__ C, int M,
         int N, int K, int out_bf16, int vec_a, int vec_b) {
  constexpr int TX = BN / TN, THREADS = 256;
  static_assert((BM / TM) * TX == THREADS && TN % 2 == 0, "thread tile");
  constexpr int LDA = BM + 4, LDB = BN + 4;  // As [BK][BM] (transposed), Bs [BK][BN]
  constexpr int A_CH = BM * BK / 4, B_CH = BK * BN / 4;
  constexpr int A_PT = (A_CH + THREADS - 1) / THREADS, B_PT = (B_CH + THREADS - 1) / THREADS;
  __shared__ __align__(16) float As[2][BK][LDA];
  __shared__ __align__(16) float Bs[2][BK][LDB];
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  int tm, tn;
  tile_of(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;

  float4 ra[A_PT], rb[B_PT];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PT; ++i) {
      const int c = tid + i * THREADS;
      if (c < A_CH) ra[i] = load4(A, K, M, K, m0 + c / (BK / 4), k0 + c % (BK / 4) * 4, vec_a);
    }
#pragma unroll
    for (int i = 0; i < B_PT; ++i) {
      const int c = tid + i * THREADS;
      if (c < B_CH) rb[i] = load4(B, N, K, N, k0 + c / (BN / 4), n0 + c % (BN / 4) * 4, vec_b);
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int i = 0; i < A_PT; ++i) {
      const int c = tid + i * THREADS;
      if (c < A_CH) {
        const int r = c / (BK / 4), k = c % (BK / 4) * 4;
        As[s][k][r] = ra[i].x;
        As[s][k + 1][r] = ra[i].y;
        As[s][k + 2][r] = ra[i].z;
        As[s][k + 3][r] = ra[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < B_PT; ++i) {
      const int c = tid + i * THREADS;
      if (c < B_CH) *reinterpret_cast<float4*>(&Bs[s][c / (BN / 4)][c % (BN / 4) * 4]) = rb[i];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int KT = (K + BK - 1) / BK;
  if (KT > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load((kt + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 2) {
        const float2 v = *reinterpret_cast<const float2*>(&As[cur][k][ty * TM + i]);
        a[i] = v.x;
        if (i + 1 < TM) a[i + 1] = v.y;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 2) {
        const float2 v = *reinterpret_cast<const float2*>(&Bs[cur][k][tx * TN + j]);
        b[j] = v.x;
        b[j + 1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; j += 2) {
      const int col = n0 + tx * TN + j;
      store2(C, out_bf16, (long long)row * N + col, col, N, acc[i][j], acc[i][j + 1], pair);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int MODE, int BM, int BN, int BK, int WM, int WN>
int launch_tc(const void* a, const void* b, void* c, int M, int N, int K, int out_bf16,
              cudaStream_t stream) {
  using T = Tc<MODE, BM, BN, BK, WM, WN>;
  auto kernel = gemm_tc<MODE, BM, BN, BK, WM, WN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  const long long ld_b = T::B_KN ? N : K;
  const int vec_a = aligned16(a) && ((long long)K * T::ES) % 16 == 0;
  const int vec_b = aligned16(b) && (ld_b * T::ES) % 16 == 0;
  const int blocks = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  kernel<<<blocks, T::THREADS, T::SMEM, stream>>>(static_cast<const uint8_t*>(a),
                                                  static_cast<const uint8_t*>(b), c, M, N, K,
                                                  out_bf16, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, int TM, int TN>
int launch_f32(const void* a, const void* b, void* c, int M, int N, int K, int out_bf16,
               cudaStream_t stream) {
  const int vec_a = aligned16(a) && K % 4 == 0;
  const int vec_b = aligned16(b) && N % 4 == 0;
  const int blocks = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  gemm_f32<BM, BN, BK, TM, TN><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), c, M, N, K, out_bf16, vec_a,
      vec_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 bf16, 1 e4m3 (B stored (N,K)), 2 fp32. (bm, bk, bn) must be one of
// the compiled tiles (kernels/matmul/kernel.py::TILES); returns -1 otherwise,
// else cudaGetLastError() after the launch.
extern "C" int matmul_fwd(const void* a, const void* b, void* c, int mode, int M, int N, int K,
                          int bm, int bk, int bn, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TC_TILE(MODE, BM, BK, BN, WM, WN)            \
  if (mode == MODE && bm == BM && bk == BK && bn == BN) \
    return launch_tc<MODE, BM, BN, BK, WM, WN>(a, b, c, M, N, K, out_bf16, s);
#define F32_TILE(BM, BK, BN, TM, TN)                      \
  if (mode == MODE_F32 && bm == BM && bk == BK && bn == BN) \
    return launch_f32<BM, BN, BK, TM, TN>(a, b, c, M, N, K, out_bf16, s);
  TC_TILE(MODE_BF16, 16, 64, 128, 16, 32)
  TC_TILE(MODE_BF16, 64, 32, 64, 32, 32)
  TC_TILE(MODE_BF16, 64, 64, 128, 32, 32)
  TC_TILE(MODE_BF16, 128, 32, 128, 64, 32)
  TC_TILE(MODE_E4M3, 16, 64, 128, 16, 32)
  TC_TILE(MODE_E4M3, 64, 32, 64, 32, 32)
  TC_TILE(MODE_E4M3, 64, 64, 128, 32, 32)
  TC_TILE(MODE_E4M3, 128, 32, 128, 64, 32)
  F32_TILE(16, 32, 64, 2, 2)
  F32_TILE(64, 16, 64, 4, 4)
  F32_TILE(128, 8, 128, 8, 8)
#undef TC_TILE
#undef F32_TILE
  return -1;
}
