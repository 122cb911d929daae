// Backward of causal, windowed or full attention, with or without a logit
// softcap, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no backward kernel, since
// jax.grad differentiates its jnp model in XLA. A train step on the card
// needs one for each forward kernel it launches, and this is flash
// attention's (src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas forward, here flash_attention_sm90.cu and
// flash_attention.cu).
//
// Computes, for q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), the forward
// output o and its gradient dO, per (batch, query head h, kv-head h / G):
//   z    = q k^T / sqrt(D), capped to cap tanh(z / cap) under a softcap (t
//          the tanh),
//   P    = softmax(z) over the live keys (key < Sk; causal: key <= query;
//          window: key > query - window: flash_attention.cu's masks),
//   dV   = sum over the G query heads of P^T dO,
//   dP   = dO V^T,   delta_i = sum_d dO_id O_id,
//   dS   = P * (dP - delta), times 1 - t^2 under a softcap,
//   dQ   = dS K / sqrt(D),   dK = sum over the G heads of dS^T Q / sqrt(D).
// bf16 inputs and outputs, D = 64 or 128 (D = 256 only on the wgmma kernel,
// flash_attention_bwd_sm90.cu: the wrapper refuses it here); every product
// on mma.sync m16n8k16 bf16 with fp32 accumulation, P and dS rounded to bf16
// as its A operand (the forward rounds P the same way). The window's masks
// are per element: a key tile wholly outside a row's window is computed and
// masked, not skipped (this kernel takes the strides TMA cannot describe,
// which no model path gives).
//
// Design: the forward kernels keep no row log-sum-exp, so this file makes
// its own and leaves the served forward untouched. Three launches, none
// with atomics, so the result is the same from run to run:
//   1. prep: per 64-row query tile, S = Q K^T over the live key tiles with an
//      online max and sum, giving L = m + log(l) per row (in the scaled
//      domain), and delta = rowsum(dO * O);
//   2. dkdv: one block per 64-key tile of a kv-head, four warps of 16 keys.
//      It walks the G query heads of that kv-head and, for each, the query
//      tiles from the key tile's diagonal on (causal) or all of them, and
//      keeps dK and dV for its keys in registers throughout: S^T = K Q^T,
//      P^T = exp(S^T - L), dV += P^T dO, dP^T = V dO^T,
//      dS^T = P^T (dP^T - delta), dK += dS^T Q. So the G heads' sums happen
//      in registers, and each key's dK and dV are written once;
//   3. dq: one block per 64-row query tile of a query head, four warps of
//      16 rows, walking the key tiles up to the diagonal: S, P, dP = dO V^T,
//      dS, dQ += dS K.
// Every tile is staged in shared memory (rows padded by 16 bytes, so that
// ldmatrix rows spread over the banks) and read by the warps through
// ldmatrix; accumulators, P and dS stay in registers (an accumulator pair
// of S is already the A operand of the next product). The query tile of
// dkdv is 64 rows at D = 64 and 32 at D = 128, which keeps dK, dV, S and dP
// of a warp within the register file.
//
// Bound on an H100: at qwen3-1.7b's training shape (8, 16, 512, 128) causal
// the bytes (q, k, v, o, dO read once, dq, dk, dv written once) take about
// as long at 3.35 TB/s as the five causal-halved products at 989 TFLOP/s.
// This first version recomputes S in all three launches and dP in two
// (eight products, not five), loads each tile synchronously (no cp.async or
// TMA ring) and runs on mma.sync, not wgmma: correct first, fast later.
//
// Inputs and outputs take explicit element strides for (batch, head, seq)
// with a contiguous last axis, so the model's (B, S, H, D) tensors pass as
// transposed (B, H, S, D) views without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BR = WARPS * 16;  // a block's own rows: queries (prep, dq) or keys (dkdv)
constexpr int BKV = 64;         // keys a tile in prep and dq
constexpr int PADH = 8;         // bf16 row padding: 16 bytes

struct Strides {
  long long b, h, s;
};

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

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

// rows [r0, r0 + R) of one (b, h) slice into dst[R][D + PADH]; zeros past n
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16 (*dst)[D + PADH], const bf16* src,
                                          long long stride, int r0, int n, bool vec) {
  if (vec) {  // 16-byte loads: base and strides are multiples of 8 elements
    constexpr int CH = D / 8;
    for (int c = threadIdx.x; c < R * CH; c += THREADS) {
      const int r = c / CH, d = (c % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + d);
      *reinterpret_cast<uint4*>(&dst[r][d]) = val;
    }
  } else {
    for (int c = threadIdx.x; c < R * D; c += THREADS) {
      const int r = c / D, d = c % D;
      dst[r][d] = r0 + r < n ? src[(r0 + r) * stride + d] : __float2bfloat16(0.f);
    }
  }
}

// s[NB][4] = A B^T: A the warp's 16 rows of `a` from row a0, B rows
// [0, 8 NB) of `b`, both (rows x D) in shared memory. Accumulator layout of
// an m16n8 block: lane holds (row lane/4, columns 2 (lane%4) + {0, 1}) in
// s[j][0..1] and row lane/4 + 8 in s[j][2..3].
template <int D, int NB>
__device__ __forceinline__ void rows_dot_rows(float (&s)[NB][4], const bf16 (*a)[D + PADH],
                                              int a0, const bf16 (*b)[D + PADH]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, &a[a0 + lane % 16][kk * 16 + (lane / 16) * 8]);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint32_t b0, b1;
      ldsm_x2<false>(b0, b1, &b[j * 8 + lane % 8][kk * 16 + ((lane / 8) % 2) * 8]);
      mma_bf16(s[j], af, b0, b1);
    }
  }
}

// acc[D/8][4] += P B: P (16 x 8 NB) in registers, rounded to bf16, B rows
// [0, 8 NB) of `b` (8 NB x D) in shared memory, read transposed.
template <int D, int NB>
__device__ __forceinline__ void regs_times_rows(float (&acc)[D / 8][4], const float (&p)[NB][4],
                                                const bf16 (*b)[D + PADH]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b0, b1;
      ldsm_x2<true>(b0, b1, &b[kk * 16 + lane % 8 + ((lane / 8) % 2) * 8][n * 8]);
      mma_bf16(acc[n], pa, b0, b1);
    }
  }
}

// a warp's 16 rows of an m16n8 accumulator, times `scale`, into bf16 rows
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long stride, int row_lo, int n,
                                           const float (&acc)[D / 8][4], float scale) {
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row_lo < n) {
      bf16* out = base + (long long)row_lo * stride + j * 8 + col;
      out[0] = __float2bfloat16(acc[j][0] * scale);
      out[1] = __float2bfloat16(acc[j][1] * scale);
    }
    if (row_lo + 8 < n) {
      bf16* out = base + (long long)(row_lo + 8) * stride + j * 8 + col;
      out[0] = __float2bfloat16(acc[j][2] * scale);
      out[1] = __float2bfloat16(acc[j][3] * scale);
    }
  }
}

// The masks and the softcap: whether (query, key) is live, and a scaled
// logit z capped (t: its tanh, 0 without a softcap). CAP, whether a softcap
// is on, is each kernel's template argument, so that its loops have no
// branch on it.
struct Mask {
  int causal, window, Sq, Sk;
  float softcap;
  __device__ __forceinline__ bool live(int query, int key) const {
    return key < Sk && query < Sq && (!causal || key <= query) &&
           (window <= 0 || key > query - window);
  }
  template <bool CAP>
  __device__ __forceinline__ float cap(float z, float& t) const {
    if (!CAP) {
      t = 0.f;
      return z;
    }
    t = tanhf(z / softcap);
    return softcap * t;
  }
};

// ---------------------------------------------------------------------------
// 1. prep: L (the row log-sum-exp of the scaled logits) and delta
// ---------------------------------------------------------------------------

template <int D>
struct PrepSmem {
  bf16 q[BR][D + PADH];
  bf16 k[BKV][D + PADH];
};

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
bwd_prep(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ o,
         const bf16* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
         int Hq, int Sq, int Sk, int G, Strides qs, Strides ks, Strides os, Strides ds,
         Mask mask, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  PrepSmem<D>& sm = *reinterpret_cast<PrepSmem<D>*>(smem_raw);
  constexpr int NK = BKV / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / G;
  const int q0 = blockIdx.x * BR;
  const long long row_base = ((long long)b * Hq + h) * Sq;

  // delta: each warp its 16 rows, lanes across D
  for (int rr = 0; rr < 16; ++rr) {
    const int r = q0 + warp * 16 + rr;
    if (r >= Sq) break;
    const bf16* orow = o + b * os.b + h * os.h + (long long)r * os.s;
    const bf16* drow = dout + b * ds.b + h * ds.h + (long long)r * ds.s;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc += __bfloat162float(orow[d]) * __bfloat162float(drow[d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[row_base + r] = acc;
  }

  load_rows<D, BR>(sm.q, q + b * qs.b + h * qs.h, qs.s, q0, Sq, vec);
  const int row_lo = q0 + warp * 16 + lane / 4, row_hi = row_lo + 8;
  const int col = 2 * (lane % 4);
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  const int k_end = mask.causal ? min(Sk, q0 + BR) : Sk;
  const bf16* kbase = k + b * ks.b + hk * ks.h;
  for (int kt = 0; kt < k_end; kt += BKV) {
    __syncthreads();  // the previous tile's K is read by every warp
    load_rows<D, BKV>(sm.k, kbase, ks.s, kt, Sk, vec);
    __syncthreads();
    float s[NK][4];
    rows_dot_rows<D, NK>(s, sm.q, warp * 16, sm.k);
    float mt_lo = NEG_INF, mt_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? row_lo : row_hi;
        const int kp = kt + j * 8 + col + (e & 1);
        float t;
        s[j][e] = mask.live(r, kp) ? mask.cap<CAP>(s[j][e] * scale, t) : NEG_INF;
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
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn_lo : mn_hi;
        const float p = s[j][e] > 0.5f * NEG_INF ? expf(s[j][e] - mn) : 0.f;
        if (e < 2)
          ps_lo += p;
        else
          ps_hi += p;
      }
    l_lo = l_lo * expf(m_lo - mn_lo) + ps_lo;
    l_hi = l_hi * expf(m_hi - mn_hi) + ps_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  // a row with no live key gets +inf: every P of it is then exp(-inf) = 0
  const float inf = __int_as_float(0x7f800000);
  if (lane % 4 == 0) {
    if (row_lo < Sq) lse[row_base + row_lo] = l_lo > 0.f ? m_lo + logf(l_lo) : inf;
    if (row_hi < Sq) lse[row_base + row_hi] = l_hi > 0.f ? m_hi + logf(l_hi) : inf;
  }
}

// ---------------------------------------------------------------------------
// 2. dkdv: a 64-key tile of a kv-head, over its G query heads
// ---------------------------------------------------------------------------

template <int D, int BQ>
struct DkdvSmem {
  bf16 k[BR][D + PADH];
  bf16 v[BR][D + PADH];
  bf16 q[BQ][D + PADH];
  bf16 dout[BQ][D + PADH];
  float lse[BQ];
  float dlt[BQ];
};

template <int D, int BQ, bool CAP>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const bf16* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
         int Hq, int Sq, int Sk, int G, Strides qs, Strides ks, Strides vs, Strides ds,
         Strides dks, Strides dvs, Mask mask, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkdvSmem<D, BQ>& sm = *reinterpret_cast<DkdvSmem<D, BQ>*>(smem_raw);
  constexpr int NQ = BQ / 8;
  constexpr int ND = D / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * BR;
  const int key_lo = k0 + warp * 16 + lane / 4, key_hi = key_lo + 8;
  const int col = 2 * (lane % 4);

  load_rows<D, BR>(sm.k, k + b * ks.b + hk * ks.h, ks.s, k0, Sk, vec);
  load_rows<D, BR>(sm.v, v + b * vs.b + hk * vs.h, vs.s, k0, Sk, vec);

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int q_begin = mask.causal ? k0 / BQ * BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long row_base = ((long long)b * Hq + h) * Sq;
    for (int qt = q_begin; qt < Sq; qt += BQ) {
      __syncthreads();  // every warp is done with the previous query tile
      load_rows<D, BQ>(sm.q, q + b * qs.b + h * qs.h, qs.s, qt, Sq, vec);
      load_rows<D, BQ>(sm.dout, dout + b * ds.b + h * ds.h, ds.s, qt, Sq, vec);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool ok = qt + i < Sq;
        sm.lse[i] = ok ? lse[row_base + qt + i] : 0.f;
        sm.dlt[i] = ok ? delta[row_base + qt + i] : 0.f;
      }
      __syncthreads();

      // P^T = exp(z - L) over the live (key, query) pairs; dcap: 1 - t^2
      float p[NQ][4], dcap[NQ][4];
      rows_dot_rows<D, NQ>(p, sm.k, warp * 16, sm.q);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key_lo : key_hi;
          const int qi = j * 8 + col + (e & 1);
          float t;
          const float z = mask.cap<CAP>(p[j][e] * scale, t);
          p[j][e] = mask.live(qt + qi, key) ? expf(z - sm.lse[qi]) : 0.f;
          dcap[j][e] = 1.f - t * t;
        }
      regs_times_rows<D, NQ>(dv_acc, p, sm.dout);  // dV += P^T dO

      // dS^T = P^T (V dO^T - delta)
      float dp[NQ][4];
      rows_dot_rows<D, NQ>(dp, sm.v, warp * 16, sm.dout);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + col + (e & 1);
          dp[j][e] = p[j][e] * (dp[j][e] - sm.dlt[qi]) * dcap[j][e];
        }
      regs_times_rows<D, NQ>(dk_acc, dp, sm.q);  // dK += dS^T Q
    }
  }
  store_rows<D>(dk + b * dks.b + hk * dks.h, dks.s, key_lo, Sk, dk_acc, scale);
  store_rows<D>(dv + b * dvs.b + hk * dvs.h, dvs.s, key_lo, Sk, dv_acc, 1.f);
}

// ---------------------------------------------------------------------------
// 3. dq: a 64-row query tile of a query head
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  bf16 q[BR][D + PADH];
  bf16 dout[BR][D + PADH];
  bf16 k[BKV][D + PADH];
  bf16 v[BKV][D + PADH];
};

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const bf16* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, bf16* __restrict__ dq, int Hq, int Sq, int Sk, int G,
       Strides qs, Strides ks, Strides vs, Strides ds, Strides dqs, Mask mask, float scale,
       int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);
  constexpr int NK = BKV / 8;
  constexpr int ND = D / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / G;
  const int q0 = blockIdx.x * BR;
  const int row_lo = q0 + warp * 16 + lane / 4, row_hi = row_lo + 8;
  const int col = 2 * (lane % 4);
  const long long row_base = ((long long)b * Hq + h) * Sq;
  const float l_lo = row_lo < Sq ? lse[row_base + row_lo] : 0.f;
  const float l_hi = row_hi < Sq ? lse[row_base + row_hi] : 0.f;
  const float d_lo = row_lo < Sq ? delta[row_base + row_lo] : 0.f;
  const float d_hi = row_hi < Sq ? delta[row_base + row_hi] : 0.f;

  load_rows<D, BR>(sm.q, q + b * qs.b + h * qs.h, qs.s, q0, Sq, vec);
  load_rows<D, BR>(sm.dout, dout + b * ds.b + h * ds.h, ds.s, q0, Sq, vec);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int k_end = mask.causal ? min(Sk, q0 + BR) : Sk;
  const bf16* kbase = k + b * ks.b + hk * ks.h;
  const bf16* vbase = v + b * vs.b + hk * vs.h;
  for (int kt = 0; kt < k_end; kt += BKV) {
    __syncthreads();  // every warp is done with the previous key tile
    load_rows<D, BKV>(sm.k, kbase, ks.s, kt, Sk, vec);
    load_rows<D, BKV>(sm.v, vbase, vs.s, kt, Sk, vec);
    __syncthreads();

    float p[NK][4], dcap[NK][4];
    rows_dot_rows<D, NK>(p, sm.q, warp * 16, sm.k);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? row_lo : row_hi;
        const int kp = kt + j * 8 + col + (e & 1);
        float t;
        const float z = mask.cap<CAP>(p[j][e] * scale, t);
        p[j][e] = mask.live(r, kp) ? expf(z - (e < 2 ? l_lo : l_hi)) : 0.f;
        dcap[j][e] = 1.f - t * t;
      }
    float dp[NK][4];
    rows_dot_rows<D, NK>(dp, sm.dout, warp * 16, sm.v);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = p[j][e] * (dp[j][e] - (e < 2 ? d_lo : d_hi)) * dcap[j][e];
    regs_times_rows<D, NK>(acc, dp, sm.k);  // dQ += dS K
  }
  store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.s, row_lo, Sq, acc, scale);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  // set on every launch: the limit belongs to the device current at the call
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, int BQ, bool CAP>
cudaError_t launch(cudaStream_t st, const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                   const bf16* dout, bf16* dq, bf16* dk, bf16* dv, float* lse, float* delta,
                   int B, int Hq, int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                   Strides os, Strides ds, Strides dqs, Strides dks, Strides dvs, int causal,
                   int window, float softcap, float scale, int vec) {
  const int G = Hq / Hkv;
  const Mask mask{causal, window, Sq, Sk, softcap};
  cudaError_t err = allow_smem(bwd_prep<D, CAP>, sizeof(PrepSmem<D>));
  if (err != cudaSuccess) return err;
  bwd_prep<D, CAP><<<dim3((Sq + BR - 1) / BR, Hq, B), THREADS, sizeof(PrepSmem<D>), st>>>(
      q, k, o, dout, lse, delta, Hq, Sq, Sk, G, qs, ks, os, ds, mask, scale, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(bwd_dkdv<D, BQ, CAP>, sizeof(DkdvSmem<D, BQ>))) != cudaSuccess)
    return err;
  bwd_dkdv<D, BQ, CAP><<<dim3((Sk + BR - 1) / BR, Hkv, B), THREADS, sizeof(DkdvSmem<D, BQ>), st>>>(
      q, k, v, dout, lse, delta, dk, dv, Hq, Sq, Sk, G, qs, ks, vs, ds, dks, dvs, mask, scale,
      vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(bwd_dq<D, CAP>, sizeof(DqSmem<D>))) != cudaSuccess) return err;
  bwd_dq<D, CAP><<<dim3((Sq + BR - 1) / BR, Hq, B), THREADS, sizeof(DqSmem<D>), st>>>(
      q, k, v, dout, lse, delta, dq, Hq, Sq, Sk, G, qs, ks, vs, ds, dqs, mask, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Sk, D); bf16, each
// with its own (batch, head, seq) element strides and a contiguous last
// axis. lse and delta: (B, Hq, Sq) fp32 scratch, contiguous. D: 64 or 128.
// window: 0 for none; softcap: 0 for none. Returns cudaGetLastError() of the
// first launch that fails, or cudaErrorInvalidValue for another D.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, void* lse, void* delta, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh, long long oss,
    long long dsb, long long dsh, long long dss, long long dqsb, long long dqsh,
    long long dqss, long long dksb, long long dksh, long long dkss, long long dvsb,
    long long dvsh, long long dvss, int causal, int window, float softcap, float scale,
    void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss},
      ds{dsb, dsh, dss}, dqs{dqsb, dqsh, dqss}, dks{dksb, dksh, dkss}, dvs{dvsb, dvsh, dvss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const auto s8 = [](const Strides& s) { return s.b % 8 == 0 && s.h % 8 == 0 && s.s % 8 == 0; };
  const int vec = a16(q) && a16(k) && a16(v) && a16(dout) && s8(qs) && s8(ks) && s8(vs) &&
                  s8(ds);
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v,
             *op = (const bf16*)o, *dp = (const bf16*)dout;
  bf16 *dqp = (bf16*)dq, *dkp = (bf16*)dk, *dvp = (bf16*)dv;
  float *lp = (float*)lse, *dl = (float*)delta;
  cudaError_t err;
#define BWD_LAUNCH(DD, BQ, CAP)                                                              \
  launch<DD, BQ, CAP>(st, qp, kp, vp, op, dp, dqp, dkp, dvp, lp, dl, B, Hq, Hkv, Sq, Sk, qs, \
                      ks, vs, os, ds, dqs, dks, dvs, causal, window, softcap, scale, vec)
  if (D == 64)
    err = softcap > 0.f ? BWD_LAUNCH(64, 64, true) : BWD_LAUNCH(64, 64, false);
  else if (D == 128)
    err = softcap > 0.f ? BWD_LAUNCH(128, 32, true) : BWD_LAUNCH(128, 32, false);
  else
    err = cudaErrorInvalidValue;
#undef BWD_LAUNCH
  return static_cast<int>(err);
}
