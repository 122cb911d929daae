// Fused causal/windowed attention with an online softmax, for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// for the calls the TMA + wgmma kernel (flash_attention_sm90.cu) does not
// take (kernels/flash_attention/kernel.py::wgmma_eligible decides before the
// launch): fp32 inputs, bf16 at D = 32, and bf16 whose bases or strides a
// TMA descriptor cannot describe; D = 32, 64, 128 or 256. No served prefill
// reaches it.
//
// Computes, per (batch b, query head h, query row i):
//   s_j = softcap(q_i . k_j / sqrt(D)) over keys j of kv-head h / G that pass
//         the masks (j < Sk; causal: j <= i; window: j > i - window),
//   o_i = sum_j softmax(s)_j v_j,
// with an fp32 online softmax (m, l, acc) whatever the input type. A row
// whose keys are all masked gives 0, as the TPU kernel's guard does.
//
// Design. The TPU kernel walks k-blocks on a sequential grid axis and keeps
// (m, l, acc) in VMEM scratch between grid steps. Here a block owns a tile of
// query rows of one (b, h) and loops over k-tiles itself, from the window's
// left edge up to the causal diagonal, so masked tiles are never read. Each
// tile of keys and values is staged once in shared memory and shared by the
// block's rows.
//
//   bf16: four warps own 16 query rows each (64 per
//   block); tiles of 64 keys. S = Q K^T and O += P V are mma.sync m16n8k16
//   bf16 products with fp32 accumulation, their operands fetched from shared
//   memory with ldmatrix (V transposed on the way). S, P and O stay in
//   registers: an S accumulator pair is already the A operand of the P V
//   product, and the online softmax needs only a max and a sum across the
//   four lanes that share a row. P is rounded to bf16 for the second product.
//   fp32: scalar fp32 FMAs (no TF32), so fp32 inputs meet a 2e-5 relative
//   tolerance: 32 rows per block, four threads per row splitting D
//   (interleaved by float4 for conflict-free shared-memory reads) and
//   combining partial dot products with warp shuffles.
//   D = 256: the fp32 kernel stages 16 keys a tile (32 KB of K and V, inside
//   the 48 KB of static shared memory), and the bf16 one reads its Q
//   fragments from shared memory at each tile instead of keeping them in 64
//   registers a thread beside the 128 of O.
//
// Bound on an H100: at the model's prefill shapes the bytes (q, k, v read
// once, o written once) take longer at 3.35 TB/s than the bf16 operations at
// 989 TFLOP/s. This kernel reads K/V once per 64-row query tile, not once per
// kv-head, and loads each tile synchronously (no cp.async/TMA double buffer,
// no wgmma), so load latency bounds it well before either limit: 0.148 ms at
// qwen3's prefill shape against a 0.015 ms bound. The bf16 shapes that need
// speed run on flash_attention_sm90.cu, which has the TMA ring and wgmma.
//
// Inputs take explicit element strides for (batch, head, seq); the last axis
// is contiguous. So the model passes its (B, S, H, D) tensors as transposed
// (B, H, S, D) views without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ROWS = 32;              // query rows per block
constexpr int TPR = 4;                // threads per query row
constexpr int BK = 32;                // keys per shared-memory tile
constexpr int THREADS = ROWS * TPR;

struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// fp32 kernel: scalar FMAs, (m, l, acc) in registers
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int G, Strides qs, Strides ks, Strides vs,
          Strides os, int causal, int window, float softcap, float scale) {
  constexpr int DPT = D / TPR;  // dimensions owned by one thread
  constexpr int NV = DPT / 4;   // float4 chunks per thread
  constexpr int BKT = D == 256 ? 16 : BK;  // keys per tile: 2 BKT D floats of K and V
  __shared__ __align__(16) float Ks[BKT][D];
  __shared__ __align__(16) float Vs[BKT][D];

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / G;
  const int q0 = blockIdx.x * ROWS;
  const int qp = q0 + row;
  const bool row_ok = qp < Sq;

  // thread `part` owns dimensions 16*c + 4*part + e, c < NV, e < 4
  float qr[DPT], acc[DPT];
  const float* qrow = q + b * qs.b + h * qs.h + (long long)(row_ok ? qp : 0) * qs.s;
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * c + e] = qrow[16 * c + 4 * part + e];
      acc[4 * c + e] = 0.f;
    }

  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + ROWS);  // last key any row of the block sees
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / BKT * BKT;

  const float* kbase = k + b * ks.b + hk * ks.h;
  const float* vbase = v + b * vs.b + hk * vs.h;
  float m = NEG_INF, l = 0.f;
  for (int kt = k_begin; kt < k_end; kt += BKT) {
    for (int idx = tid; idx < BKT * D; idx += THREADS) {
      const int j = idx / D, d = idx % D;
      const int kp = kt + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk) {
        kx = kbase[kp * ks.s + d];
        vx = vbase[kp * vs.s + d];
      }
      Ks[j][d] = kx;
      Vs[j][d] = vx;
    }
    __syncthreads();

    float s[BKT];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKT; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][16 * c + 4 * part]);
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      float sc = dot * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      const int kp = kt + j;
      bool live = kp < Sk;
      if (causal) live = live && qp >= kp;
      if (window > 0) live = live && kp > qp - window;
      s[j] = live ? sc : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BKT; ++j) {
      const float p = s[j] > 0.5f * NEG_INF ? expf(s[j] - m_new) : 0.f;
      s[j] = p;
      psum += p;
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < BKT; ++j) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][16 * c + 4 * part]);
        acc[4 * c] = fmaf(s[j], vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(s[j], vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(s[j], vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(s[j], vv.w, acc[4 * c + 3]);
      }
    }
    __syncthreads();
  }

  if (!row_ok) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* orow = o + b * os.b + h * os.h + (long long)qp * os.s;
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) orow[16 * c + 4 * part + e] = acc[4 * c + e] * inv;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel: mma.sync m16n8k16, S and O in registers
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = TC_WARPS * 16;  // query rows per block, 16 per warp
constexpr int TC_BK = 64;               // keys per tile
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int PADH = 8;  // bf16 row padding: 16 bytes, so ldmatrix rows spread over banks

template <int D>
struct TcSmem {
  __nv_bfloat16 q[TC_ROWS][D + PADH];
  __nv_bfloat16 k[TC_BK][D + PADH];
  __nv_bfloat16 v[TC_BK][D + PADH];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two 8x8 b16 matrices (lanes 0-15 give the row addresses), optionally transposed
template <bool TRANS>
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1)
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1)
                 : "r"(smem_addr(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + R) of one (b, h) slice into smem[R][D + PADH]; zeros past n
template <int D, int R>
__device__ __forceinline__ void load_rows(__nv_bfloat16 (*dst)[D + PADH],
                                          const __nv_bfloat16* src, long long stride,
                                          int r0, int n, bool vec) {
  if (vec) {  // 16-byte loads: base and strides are multiples of 8 elements
    constexpr int CH = D / 8;
    for (int c = threadIdx.x; c < R * CH; c += TC_THREADS) {
      const int r = c / CH, d = (c % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + d);
      *reinterpret_cast<uint4*>(&dst[r][d]) = val;
    }
  } else {
    for (int c = threadIdx.x; c < R * D; c += TC_THREADS) {
      const int r = c / D, d = c % D;
      dst[r][d] = r0 + r < n ? src[(r0 + r) * stride + d] : __float2bfloat16(0.f);
    }
  }
}

// Register layout of an m16n8 fp32 accumulator: lane holds (row lane/4,
// columns 2*(lane%4) + {0,1}) in c[0], c[1] and the same columns of row
// lane/4 + 8 in c[2], c[3]. Two n8 blocks of S side by side are exactly the
// A operand of the next m16n8k16 product, so P never leaves registers.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
               int Sk, int G, Strides qs, Strides ks, Strides vs, Strides os, int causal,
               int window, float softcap, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  TcSmem<D>& sm = *reinterpret_cast<TcSmem<D>*>(smem_raw);
  constexpr int KD = D / 16;     // k-steps of Q K^T
  constexpr int ND = D / 8;      // n8 blocks of O
  constexpr int NK = TC_BK / 8;  // n8 blocks of S

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / G;
  const int q0 = blockIdx.x * TC_ROWS;
  const int row_lo = q0 + warp * 16 + lane / 4, row_hi = row_lo + 8;
  const int col = 2 * (lane % 4);

  load_rows<D, TC_ROWS>(sm.q, q + b * qs.b + h * qs.h, qs.s, q0, Sq, vec);
  __syncthreads();
  // Q's A fragments: in registers up to D = 128, read again at each tile at 256
  constexpr bool Q_REGS = D <= 128;
  uint32_t qa[Q_REGS ? KD : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qa[kk], &sm.q[warp * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // m per row; l per thread (the quad's partial sums, added up at the end)
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + TC_ROWS);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / TC_BK * TC_BK;

  const __nv_bfloat16* kbase = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + hk * vs.h;
  for (int kt = k_begin; kt < k_end; kt += TC_BK) {
    load_rows<D, TC_BK>(sm.k, kbase, ks.s, kt, Sk, vec);
    load_rows<D, TC_BK>(sm.v, vbase, vs.s, kt, Sk, vec);
    __syncthreads();

    // S = Q K^T: K rows are the column-major B operand as stored
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qf[4];
      if constexpr (Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[e] = qa[kk][e];
      } else {
        ldsm_x4(qf, &sm.q[warp * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t b0, b1;
        ldsm_x2<false>(b0, b1, &sm.k[j * 8 + lane % 8][kk * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(s[j], qf, b0, b1);
      }
    }

    // scale, cap and mask; row maxima over the quad of lanes sharing a row
    float mt_lo = NEG_INF, mt_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? row_lo : row_hi;
        const int kp = kt + j * 8 + col + (e & 1);
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool live = kp < Sk && r < Sq;
        if (causal) live = live && r >= kp;
        if (window > 0) live = live && kp > r - window;
        s[j][e] = live ? x : NEG_INF;
        if (e < 2)
          mt_lo = fmaxf(mt_lo, s[j][e]);
        else
          mt_hi = fmaxf(mt_hi, s[j][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mt_lo = fmaxf(mt_lo, __shfl_xor_sync(0xffffffffu, mt_lo, off));
      mt_hi = fmaxf(mt_hi, __shfl_xor_sync(0xffffffffu, mt_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mt_lo), mn_hi = fmaxf(m_hi, mt_hi);
    const float corr_lo = expf(m_lo - mn_lo), corr_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn_lo : mn_hi;
        const float p = s[j][e] > 0.5f * NEG_INF ? expf(s[j][e] - mn) : 0.f;
        s[j][e] = p;
        if (e < 2)
          ps_lo += p;
        else
          ps_hi += p;
      }
    l_lo = l_lo * corr_lo + ps_lo;
    l_hi = l_hi * corr_hi + ps_hi;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr_lo;
      acc[n][1] *= corr_lo;
      acc[n][2] *= corr_hi;
      acc[n][3] *= corr_hi;
    }

    // O += P V: P from registers (rounded to bf16), V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        ldsm_x2<true>(b0, b1, &sm.v[kk * 16 + lane % 8 + ((lane / 8) % 2) * 8][n * 8]);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this tile's K and V
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* obase = o + b * os.b + h * os.h + col;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (row_lo < Sq) {
      __nv_bfloat16* out = obase + (long long)row_lo * os.s + n * 8;
      out[0] = __float2bfloat16(acc[n][0] * inv_lo);
      out[1] = __float2bfloat16(acc[n][1] * inv_lo);
    }
    if (row_hi < Sq) {
      __nv_bfloat16* out = obase + (long long)row_hi * os.s + n * 8;
      out[0] = __float2bfloat16(acc[n][2] * inv_hi);
      out[1] = __float2bfloat16(acc[n][3] * inv_hi);
    }
  }
}

template <int D>
cudaError_t launch_bf16(dim3 grid, cudaStream_t st, const void* q, const void* k,
                        const void* v, void* o, int Sq, int Sk, int G, Strides qs,
                        Strides ks, Strides vs, Strides os, int causal, int window,
                        float softcap, float scale, int vec) {
  const int bytes = sizeof(TcSmem<D>);
  // set on every launch: the limit belongs to the device current at the call
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  flash_fwd_bf16<D><<<grid, TC_THREADS, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, Sq, Sk, G, qs, ks, vs, os, causal, window, softcap, scale, vec);
  return cudaGetLastError();
}

cudaError_t launch_f32(int D, dim3 grid, cudaStream_t st, const void* q, const void* k,
                       const void* v, void* o, int Sq, int Sk, int G, Strides qs,
                       Strides ks, Strides vs, Strides os, int causal, int window,
                       float softcap, float scale) {
#define FLASH_CASE(DD)                                                                 \
  case DD:                                                                             \
    flash_fwd_f32<DD><<<grid, THREADS, 0, st>>>(                                    \
        (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk, G, qs, ks, \
        vs, os, causal, window, softcap, scale);                                       \
    break;
  switch (D) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
  return cudaGetLastError();
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o (B, Hq, Sq, D), each with its own
// (batch, head, seq) element strides and a contiguous last axis.
// is_bf16: 1 for bfloat16 tensors, 0 for float32. Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int is_bf16, int B, int Hq, int Hkv, int Sq, int Sk,
                                   int D, long long qsb, long long qsh, long long qss,
                                   long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss,
                                   long long osb, long long osh, long long oss, int causal,
                                   int window, float softcap, float scale, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return static_cast<int>(launch_f32(D, dim3((Sq + ROWS - 1) / ROWS, Hq, B), st, q, k, v,
                                       o, Sq, Sk, G, qs, ks, vs, os, causal, window,
                                       softcap, scale));
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = a16(q) && a16(k) && a16(v) && qsb % 8 == 0 && qsh % 8 == 0 &&
                  qss % 8 == 0 && ksb % 8 == 0 && ksh % 8 == 0 && kss % 8 == 0 &&
                  vsb % 8 == 0 && vsh % 8 == 0 && vss % 8 == 0;
  const dim3 grid((Sq + TC_ROWS - 1) / TC_ROWS, Hq, B);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch_bf16<32>(grid, st, q, k, v, o, Sq, Sk, G, qs, ks, vs, os, causal, window,
                            softcap, scale, vec);
      break;
    case 64:
      err = launch_bf16<64>(grid, st, q, k, v, o, Sq, Sk, G, qs, ks, vs, os, causal, window,
                            softcap, scale, vec);
      break;
    case 128:
      err = launch_bf16<128>(grid, st, q, k, v, o, Sq, Sk, G, qs, ks, vs, os, causal,
                             window, softcap, scale, vec);
      break;
    case 256:
      err = launch_bf16<256>(grid, st, q, k, v, o, Sq, Sk, G, qs, ks, vs, os, causal,
                             window, softcap, scale, vec);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
