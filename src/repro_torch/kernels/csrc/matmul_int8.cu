// int8 x int8 GEMM with the dequantization fused into the store, for Hopper
// (sm_90a):
//
//   C[M,N] = (A_q[M,K] @ B_q[K,N]) * a_scale[M,1] * b_scale[1,N]
//
// Replaces repro/kernels/matmul/kernel.py::matmul_int8_pallas, the integer
// GEMM of symmetric per-row (A) / per-column (B) int8 quantization that the
// precision model prices at 1-byte traffic and twice the fp16 MAC rate.
//
// Which shapes. Since the int8 mode of matmul_sm90.cu (TMA ring, s8 wgmma)
// took every int8 GEMM a TMA descriptor can describe, this kernel takes
// only the rest (kernels/matmul/kernel.py::int8_gemm_cuda decides before
// the launch): a K that is no multiple of 16 or an operand base off 16
// bytes. No served or benchmarked shape reaches it.
//
// Design. mma.sync m16n8k32 .s8.s8.s32: exact integer products summed in
// int32 registers. An int32 sum of K products of any int8 values (-128
// included) is exact while K * 128^2 < 2^31 (K <= 131071): the k-loop sums
// chunks of at most that many in int32 and adds each chunk's sum, converted
// once, into fp32 registers, in order, as the TPU kernel adds its int32
// k-block dots in fp32; so any K runs (gpt3-175b's largest K, 49152, is one
// chunk, converted once, in the epilogue). The store scales by a_scale of
// its row and b_scale of its column: (acc * a_scale) * b_scale, the TPU
// kernel's order, in fp32 as the TPU kernel stores it. B comes
// column-major, stored as (N,K) (the layout the op writes the quantized B
// in, nn.Linear's weight layout): the B fragment of an 8-bit mma is
// K-contiguous per column and ldmatrix has no transposing form for 8-bit
// elements, so both operands are staged K-contiguous and fetched with
// plain ldmatrix. Tiles go through registers into a double buffer in shared
// memory (one barrier per k-tile); edges are masked (zeros in, stores
// skipped), with 16-byte loads where the operand's base and row pitch allow
// and byte loads otherwise.
//
// Bound on an H100: at decode (M = 8) reading B (1 byte an element) bounds
// it; at a prefill wave (M = 4096) the operations (1979 TOPS int8 dense).
// Synchronous staging through registers and mma.sync reach neither (19.6 ms
// at gpt3's FFN up, M = 4096, 12.8% of the bound); the shapes that need
// speed take the wgmma kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GROUP_M = 8;  // tile rows per raster group
constexpr int INT8_MAX_K = 131071;  // K * 128^2 < 2^31: an int32 sum of K products is exact

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 int32) += a (16x32 s8, row-major) * b (32x8 s8, column-major)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void tile_of(int bid, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = GROUP_M * tiles_n;
  const int first_m = bid / per_group * GROUP_M;
  const int rows = min(tiles_m - first_m, GROUP_M);
  const int in_group = bid % per_group;
  tm = first_m + in_group % rows;
  tn = in_group / rows;
}

// 16 bytes at (r, c) of a row-major (rows, cols) byte array of row pitch ld;
// bytes outside it read 0
__device__ __forceinline__ uint4 load16(const int8_t* base, long long ld, int rows, int cols,
                                        int r, int c, bool vec) {
  if (r >= rows) return make_uint4(0, 0, 0, 0);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(base) + (long long)r * ld + c;
  if (vec && c + 16 <= cols) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c + i < cols) w[i / 4] |= static_cast<uint32_t>(p[i]) << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BM, int BN, int BK, int WM, int WN>  // BK in bytes (int8 elements)
struct S8 {
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int LD = BK + 16;  // bytes; 16-byte pad against bank conflicts
  static constexpr int A_STAGE = BM * LD, B_STAGE = BN * LD;
  static constexpr int SMEM = 2 * (A_STAGE + B_STAGE);
  static constexpr int A_CH = BM * BK / 16, B_CH = BN * BK / 16;
  static constexpr int A_PT = (A_CH + THREADS - 1) / THREADS;
  static constexpr int B_PT = (B_CH + THREADS - 1) / THREADS;
  static constexpr int CHUNK_KT = INT8_MAX_K / BK;  // k-tiles summed in int32 at a time
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 16 == 0, "tile");
  static_assert(BK % 32 == 0, "k tile");
};

// CHUNKED: K spans more than one chunk of INT8_MAX_K, and the chunks' sums
// are added in fp32 registers; else the int32 sums convert once, at the
// store (and the kernel keeps no second set of sums)
template <int BM, int BN, int BK, int WM, int WN, bool CHUNKED>
__global__ void __launch_bounds__(S8<BM, BN, BK, WM, WN>::THREADS)
gemm_s8(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
        const float* __restrict__ sa, const float* __restrict__ sb, float* __restrict__ C, int M,
        int N, int K, int vec_a, int vec_b) {
  using T = S8<BM, BN, BK, WM, WN>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* As = smem;                   // [2][BM][LD]
  uint8_t* Bs = smem + 2 * T::A_STAGE;  // [2][BN][LD]
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
      if (c < T::A_CH)
        ra[i] = load16(A, K, M, K, m0 + c / (BK / 16), k0 + c % (BK / 16) * 16, vec_a);
    }
#pragma unroll
    for (int i = 0; i < T::B_PT; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::B_CH)
        rb[i] = load16(B, K, N, K, n0 + c / (BK / 16), k0 + c % (BK / 16) * 16, vec_b);
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int i = 0; i < T::A_PT; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::A_CH)
        *reinterpret_cast<uint4*>(As + s * T::A_STAGE + c / (BK / 16) * T::LD +
                                  c % (BK / 16) * 16) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < T::B_PT; ++i) {
      const int c = tid + i * T::THREADS;
      if (c < T::B_CH)
        *reinterpret_cast<uint4*>(Bs + s * T::B_STAGE + c / (BK / 16) * T::LD +
                                  c % (BK / 16) * 16) = rb[i];
    }
  };

  int acc[T::MI][T::NI][4];
  float tot[CHUNKED ? T::MI : 1][CHUNKED ? T::NI : 1][4];  // chunks' sums, added in order
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0;
        if constexpr (CHUNKED) tot[mi][ni][e] = 0.f;
      }
  auto promote = [&]() {
    if constexpr (CHUNKED) {
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[mi][ni][e] += static_cast<float>(acc[mi][ni][e]);
            acc[mi][ni][e] = 0;
          }
    }
  };
  auto sum = [&](int mi, int ni, int e) {
    if constexpr (CHUNKED) return tot[mi][ni][e];
    else return static_cast<float>(acc[mi][ni][e]);
  };

  const int KT = (K + BK - 1) / BK;
  if (KT > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load((kt + 1) * BK);
    const uint8_t* as = As + cur * T::A_STAGE;
    const uint8_t* bs = Bs + cur * T::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
        ldsm_x4(af[mi], as + (wm0 + mi * 16 + (lane & 15)) * T::LD + kk + (lane >> 4) * 16);
#pragma unroll
      for (int nj = 0; nj < T::NI / 2; ++nj) {
        uint32_t bf[4];  // b0, b1 of n-blocks 2nj and 2nj + 1
        ldsm_x4(bf, bs + (wn0 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * T::LD + kk +
                        ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi) {
          mma_s8(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_s8(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    if (kt + 1 < KT) store(cur ^ 1);
    if (CHUNKED && ((kt + 1) % T::CHUNK_KT == 0 || kt + 1 == KT)) promote();
    __syncthreads();
  }

  // lane holds rows lane/4 and lane/4 + 8, columns 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + mi * 16 + (lane >> 2) + 8 * h;
      if (row >= M) continue;
      const float s_row = sa[row];
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int col = n0 + wn0 + ni * 8 + (lane & 3) * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= N) continue;
          C[(long long)row * N + col + e] = sum(mi, ni, 2 * h + e) * s_row * sb[col + e];
        }
      }
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int BM, int BN, int BK, int WM, int WN, bool CHUNKED>
int launch(const void* a, const void* b, const float* sa, const float* sb, float* c, int M, int N,
           int K, cudaStream_t stream) {
  using T = S8<BM, BN, BK, WM, WN>;
  auto kernel = gemm_s8<BM, BN, BK, WM, WN, CHUNKED>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  const int vec_a = aligned16(a) && K % 16 == 0;
  const int vec_b = aligned16(b) && K % 16 == 0;
  const int blocks = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  kernel<<<blocks, T::THREADS, T::SMEM, stream>>>(static_cast<const int8_t*>(a),
                                                  static_cast<const int8_t*>(b), sa, sb, c, M, N,
                                                  K, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M,K) int8 row-major, b (K,N) int8 column-major (stored (N,K)), sa (M)
// and sb (N) fp32, c (M,N) fp32. (bm, bk, bn) must be one of the compiled
// tiles (kernels/matmul/kernel.py::TILES); returns -1 otherwise, else
// cudaGetLastError() after the launch.
extern "C" int matmul_int8_fwd(const void* a, const void* b, const void* sa, const void* sb,
                               void* c, int M, int N, int K, int bm, int bk, int bn,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(sa);
  const float* fb = static_cast<const float*>(sb);
  float* fc = static_cast<float*>(c);
#define S8_TILE(BM, BK, BN, WM, WN)          \
  if (bm == BM && bk == BK && bn == BN) \
    return K > S8<BM, BN, BK, WM, WN>::CHUNK_KT * BK                            \
               ? launch<BM, BN, BK, WM, WN, true>(a, b, fa, fb, fc, M, N, K, s) \
               : launch<BM, BN, BK, WM, WN, false>(a, b, fa, fb, fc, M, N, K, s);
  S8_TILE(16, 128, 128, 16, 32)
  S8_TILE(64, 64, 64, 32, 32)
  S8_TILE(64, 128, 128, 32, 32)
  S8_TILE(128, 64, 128, 64, 32)
#undef S8_TILE
  return -1;
}
