// Backward of causal or full attention for Hopper (sm_90a): Q, K, V, dO
// tiles fed by TMA into rings of shared-memory stages, every product on
// wgmma, the row log-sum-exp taken from the forward.
//
// Replaces no TPU kernel: the JAX package has no backward kernel, since
// jax.grad differentiates its jnp model in XLA. It is the gradient of
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas as the
// port's forward computes it (flash_attention_sm90.cu), and computes what
// flash_attention_bwd.cu computes, per (batch b, query head h, kv-head h/G):
//   P    = exp(s - L) over the live keys (causal: key <= query; none past Sk),
//          s = q k^T / sqrt(D), L the row log-sum-exp the forward wrote,
//   dV   = sum over the G query heads of P^T dO,
//   dP   = dO V^T,   delta_i = sum_d dO_id O_id,   dS = P * (dP - delta),
//   dQ   = dS K / sqrt(D),   dK = sum over the G heads of dS^T Q / sqrt(D).
// bf16 q, k, v, o, dO at D = 64 or 128 whose strides a TMA descriptor can
// describe (kernels/flash_attention/kernel.py::bwd_wgmma_eligible); fp32
// sums; P and dS rounded to bf16 as a product's register operand. Window and
// softcap are refused by the wrapper. L is the natural log over the scaled
// logits (flash_attention_sm90.cu's note), +inf for a row with no live key;
// the kernels take L log2(e), so that P is one FFMA and one ex2.
//
// Two launches, no atomics on the results, so dq, dk and dv are the same
// bits from run to run; seven products (S and dP in both launches):
//   1. dq: a work tile is 128 query rows of one (b, h), two consumers of 64
//      rows. It loads Q and dO once (TMA), reads its rows of O once (16-byte
//      loads), computes delta, and writes (L log2(e), delta) of its rows to a
//      (B, Hq, Sq_pad) scratch of pairs (+inf and 0 past Sq). Then it walks
//      the key tiles of 64 up to the diagonal, K and V in a ring:
//        S = Q K^T and dP = dO V^T, SS wgmma m64n64k16, K-major operands;
//        P = ex2(S scale log2(e) - L log2(e)); dS = P (dP - delta) -> bf16;
//        dQ += dS K, RS wgmma m64nDk16, K read MN-major through the
//        descriptor's transpose bit (as the forward reads V).
//      dQ of one tile runs while S and dP of the next are issued.
//   2. dkdv: a work tile is 128 keys of one (b, kv-head), two consumers of 64
//      keys; K and V are loaded once. It walks the G query heads and, for
//      each, the query tiles of 64 from the diagonal on (causal) or all of
//      them; Q, dO and the tile's (L log2(e), delta) pairs (a 512-byte bulk
//      copy from the scratch) come through a ring:
//        S^T = K Q^T and dP^T = V dO^T, SS m64n64k16;
//        P^T = ex2(S^T scale log2(e) - L log2(e)) by query column;
//        dS^T = P^T (dP^T - delta);
//        dV += P^T dO and dK += dS^T Q, RS m64nDk16, dO and Q MN-major.
//      dK and dV stay in registers across the G heads and are written once.
//      At D = 128 a consumer thread holds dK and dV (64 + 64 fp32), S^T and
//      dP^T (32 + 32) and the two bf16 operands (16 + 16): some 230
//      registers with the addresses. ptxas gives a kernel of 384 threads at
//      most 168 a thread whatever setmaxnreg asks later (dk/dv spilled over
//      500 bytes so), and a block of 288 (a producer warp beside two consumer
//      warpgroups, 224 each) was refused at launch: registers go by
//      warpgroup. So this launch has the two consumer warpgroups alone, at
//      up to 255 registers, and their first thread issues the loads: after
//      each query tile it refills, in order, the stages both consumers are
//      done with, and waits only for the one its own warpgroup reads next.
//      One block a work tile, in the order of the longest first. Where the
//      work tiles are fewer than half the SMs (qwen2-0.5b: 64 at 8 x 512,
//      G = 7 on 2 kv-heads), a tile's G heads are split over as many blocks
//      as fill the card; each writes its partial dK and dV (fp32), and the
//      last of them (a counter a tile) adds them in a fixed order and
//      stores dk and dv, so the bits do not depend on which finished last.
// The dq launch follows the forward: persistent blocks, one per SM, taking
// work tiles from an atomic counter, the longest causal tiles first and the
// (b, head) pairs in groups whose shared operands stay in the L2; one
// producer warpgroup of which one thread issues the loads (setmaxnreg 24),
// two consumer warpgroups (240); full and empty mbarriers per stage. A
// consumer skips the products of a tile its rows see no key of (the last
// key tile of dq's first consumer, the first query tile of dk/dv's second);
// masks are computed only on the tiles the diagonal or Sk cuts. The TMA
// fills rows past Sq and Sk with zeros, whose P the +inf L makes 0.
//
// ptxas (-O3, sm_90a): dq 168 registers at D = 64 and 128, no spill;
// dk/dv 226 at D = 64, no spill, and 255 at D = 128 with 16 bytes spilled.
// A dq of 256 threads that issued S and dP of the next key tile before the
// math of the current one (two register sets) gave the same bits but ran
// slower: ptxas serialized its wgmma (its warning C7515).
//
// Bound on an H100: at qwen3-1.7b's training shape (8, 16, 512, 128) causal
// the bytes (q, k, v, o, dO, L read once, dq, dk, dv written once: 100.9 MB,
// 30 us at 3.35 TB/s) take longer than the five causal-halved products at
// 989 TFLOP/s (21.6 GFLOP, 22 us); this design does seven.

#include <cuda_bf16.h>

#include <algorithm>

#include "flash_sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 384;       // dq: a producer warpgroup and two consumers
constexpr int DKDV_THREADS = 256;  // dk/dv: two consumer warpgroups
constexpr int TM = 128;       // rows of a work tile: queries (dq) or keys (dkdv)
constexpr int TN = 64;        // rows of a ring tile: keys (dq) or queries (dkdv)

typedef __nv_bfloat16 bf16;

template <int D>
struct BwdCfg {
  static constexpr int DB = D / 64;           // 64-wide blocks of D: 128-byte swizzle rows
  static constexpr int STAGES = D == 64 ? 6 : 4;
  static constexpr int ROWS_BYTES = TM * D * 2;  // Q or dO (dq), K or V (dkdv) of a work tile
  static constexpr int RING_BYTES = TN * D * 2;  // one stage of K or V (dq), Q or dO (dkdv)
  static constexpr int STAT_BYTES = TN * 8;      // one stage of (L log2 e, delta) pairs (dkdv)
  static constexpr int BARS = (2 + 4 * STAGES) * 8 + 8;
  static constexpr int DQ_SMEM = 1024 + 2 * ROWS_BYTES + 2 * STAGES * RING_BYTES +
                                 2 * TM * 8 + BARS;
  static constexpr int DKDV_SMEM = 1024 + 2 * ROWS_BYTES + STAGES * (2 * RING_BYTES + STAT_BYTES) +
                                   BARS;
  static_assert(D == 64 || D == 128, "head dim");
  static_assert(DQ_SMEM <= 232448 && DKDV_SMEM <= 232448, "shared memory");
};

struct Strides {
  long long b, h, s;
};

struct Tile {
  int r0, head, b;  // first row (query in dq, key in dkdv), head, batch
};

// Work tile w of nt x B H: (b, head) pairs in groups of `group` (whose shared
// operands stay in the L2 while the group runs), within a group the tiles
// from the last (dq: the causal query tiles that see the most keys) or from
// the first (dkdv: the key tiles that the most queries see)
__device__ __forceinline__ Tile tile_of(int w, int nt, int B, int H, int group, bool from_end) {
  const int bh = B * H, per_group = nt * group;
  const int g0 = w / per_group * group, rows = min(bh - g0, group), r = w % per_group;
  const int pair = g0 + r % rows, i = r / rows;
  return Tile{(from_end ? nt - 1 - i : i) * TM, pair % H, pair / H};
}

// the next work tile not yet taken (counter[0] counts those handed out past
// the first gridDim.x); the last block to run out resets both counters to 0
__device__ __forceinline__ int next_tile(int* counter) {
  return gridDim.x + atomicAdd(counter, 1);
}
__device__ __forceinline__ void release_counters(int* counter) {
  __threadfence();  // this block's last take is seen before its count below
  if (atomicAdd(counter + 1, 1) == gridDim.x - 1) {
    counter[0] = 0;
    counter[1] = 0;
  }
}

// whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool bar_done(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// mbar_wait that traps (a launch error) after some 10 s instead of spinning
// for good
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000ll) __trap();
  }
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    s = fmaf(fx.x, fy.x, fmaf(fx.y, fy.y, s));
  }
  return s;
}

// 64 x D rows of an m64nD accumulator (thread: rows row_lo, row_lo + 8),
// times `scale`, into bf16 rows of `base`; rows at or past n are not written
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long stride, int row_lo, int n,
                                           const float (&acc)[D / 2], float scale) {
  const int col = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    if (row >= n) continue;
    bf16* out = base + static_cast<long long>(row) * stride + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// 1. dq (and delta, and the scratch of (L log2 e, delta) pairs)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_sm90(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
            const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
            const bf16* __restrict__ o, Strides os, const float* __restrict__ lse,
            float2* __restrict__ stats, int sq_pad, bf16* __restrict__ dq, Strides dqs,
            int* __restrict__ counter, int B, int Hq, int Sq, int Sk, int G, int group,
            int causal, float scale) {
  using F = BwdCfg<D>;
  constexpr int STAGES = F::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;                       // [DB][TM][128 bytes]
  uint8_t* dos = qs + F::ROWS_BYTES;        // [DB][TM][128 bytes]
  uint8_t* ks = dos + F::ROWS_BYTES;        // [STAGES][DB][TN][128 bytes]
  uint8_t* vs = ks + STAGES * F::RING_BYTES;
  float2* stat = reinterpret_cast<float2*>(vs + STAGES * F::RING_BYTES);  // [2][TM], by tile parity
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stat + 2 * TM);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;
  volatile int* work = reinterpret_cast<volatile int*>(v_empty + STAGES);
  const int nqt = (Sq + TM - 1) / TM, total = nqt * B * Hq;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 2 * 128);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      int it = 0;  // key tiles loaded so far: the ring position
      for (int w = blockIdx.x, wi = 0;; ++wi) {
        bar_wait(q_empty, (wi & 1) ^ 1);  // the consumers are done with the last Q and dO
        *work = w;
        if (w >= total) {
          mbar_arrive(q_full);
          break;
        }
        const Tile t = tile_of(w, nqt, B, Hq, group, true);
        const int hk = t.head / G;
        mbar_expect_tx(q_full, 2 * F::ROWS_BYTES);
#pragma unroll
        for (int j = 0; j < F::DB; ++j) {
          tma_load_4d(qs + j * TM * 128, &map_q, 64 * j, t.r0, t.head, t.b, q_full);
          tma_load_4d(dos + j * TM * 128, &map_do, 64 * j, t.r0, t.head, t.b, q_full);
        }
        const int k_end = causal ? min(Sk, t.r0 + TM) : Sk;
        for (int kt = 0; kt < k_end; kt += TN, ++it) {
          const int s = it % STAGES;
          const uint32_t par = ((it / STAGES) & 1) ^ 1;
          bar_wait(&k_empty[s], par);
          mbar_expect_tx(&k_full[s], F::RING_BYTES);
#pragma unroll
          for (int j = 0; j < F::DB; ++j)
            tma_load_4d(ks + s * F::RING_BYTES + j * TN * 128, &map_k, 64 * j, kt, hk, t.b,
                        &k_full[s]);
          bar_wait(&v_empty[s], par);
          mbar_expect_tx(&v_full[s], F::RING_BYTES);
#pragma unroll
          for (int j = 0; j < F::DB; ++j)
            tma_load_4d(vs + s * F::RING_BYTES + j * TN * 128, &map_v, 64 * j, kt, hk, t.b,
                        &v_full[s]);
        }
        w = next_tile(counter);
      }
      release_counters(counter);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;  // this consumer's 64 rows of each work tile
  const int warp = tid / 32, lane = tid % 32;
  const int col = 2 * (lane % 4);  // this thread's first key (of 8) in each n8 block
  const float scale2 = scale * LOG2E;
  const uint32_t qa = smem_addr(qs) + c * 64 * 128, da = smem_addr(dos) + c * 64 * 128;
  const float inf = __int_as_float(0x7f800000);

  float acc[D / 2], s[TN / 2], dp[TN / 2];
  uint32_t p[TN / 4];
  int it = 0;  // key tiles consumed so far: the ring position
  for (int wi = 0;; ++wi) {
    bar_wait(q_full, wi & 1);
    const int w = *work;
    if (w >= total) break;
    const Tile t = tile_of(w, nqt, B, Hq, group, true);
    const int r0 = t.r0 + 64 * c;                  // this consumer's first row
    const int row_lo = r0 + 16 * warp + lane / 4;  // this thread's rows: row_lo, row_lo + 8
    const long long bh = static_cast<long long>(t.b) * Hq + t.head;

    // delta and L log2(e) of the consumer's rows, two threads a row
    {
      const int r = tid / 2, half = tid % 2, rr = 64 * c + r, row = r0 + r;
      float sum = 0.f;
      if (row < Sq) {
        const bf16* orow = o + t.b * os.b + t.head * os.h + row * os.s + half * (D / 2);
#pragma unroll
        for (int ch = 0; ch < D / 16; ++ch) {  // 8-element chunks of this half of the row
          const int d0 = half * (D / 2) + 8 * ch, cc = (d0 % 64) / 8;
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * ch);
          const uint4 dv = *reinterpret_cast<const uint4*>(dos + (d0 / 64) * TM * 128 + rr * 128 +
                                                           ((cc ^ (rr % 8)) * 16));
          sum += dot8(ov, dv);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        const float2 st = row < Sq ? make_float2(lse[bh * Sq + row] * LOG2E, sum)
                                   : make_float2(inf, 0.f);
        stat[(wi & 1) * TM + rr] = st;
        stats[bh * sq_pad + row] = st;
      }
    }
    bar_sync(1 + c, 128);
    const float2 st_lo = stat[(wi & 1) * TM + 64 * c + 16 * warp + lane / 4];
    const float2 st_hi = stat[(wi & 1) * TM + 64 * c + 16 * warp + lane / 4 + 8];
    const float lg[2] = {st_lo.x, st_hi.x}, dl[2] = {st_lo.y, st_hi.y};

#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const int k_end = causal ? min(Sk, t.r0 + TM) : Sk;
    const int n = (k_end + TN - 1) / TN;
    if (n == 0) mbar_arrive(q_empty);
    int prev = -1;  // the stage of the tile whose dQ product is in flight
    for (int i = 0; i < n; ++i, ++it) {
      const int st = it % STAGES, kt = i * TN;
      const uint32_t ph = (it / STAGES) & 1;
      bar_wait(&k_full[st], ph);
      bar_wait(&v_full[st], ph);
      if (causal && kt > r0 + 63) {  // every key right of this consumer's rows
        mbar_arrive(&k_empty[st]);
        mbar_arrive(&v_empty[st]);
        if (i == n - 1) mbar_arrive(q_empty);
        continue;
      }
      const uint32_t kb = smem_addr(ks + st * F::RING_BYTES);
      const uint32_t vb = smem_addr(vs + st * F::RING_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // k16 steps along D: 32 bytes of a 128-byte row
        wgmma_qk(s, desc(qa + kk / 4 * TM * 128 + kk % 4 * 32, 16, 1024),
                 desc(kb + kk / 4 * TN * 128 + kk % 4 * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_qk(dp, desc(da + kk / 4 * TM * 128 + kk % 4 * 32, 16, 1024),
                 desc(vb + kk / 4 * TN * 128 + kk % 4 * 32, 16, 1024), kk > 0);
      wgmma_commit();
      if (prev >= 0) {  // dQ of the previous tile is done: its K stage is free
        wgmma_wait<1>();
        fence_regs(acc);
        fence_regs(p);
        mbar_arrive(&k_empty[prev]);
      }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      mbar_arrive(&v_empty[st]);
      if (i == n - 1) mbar_arrive(q_empty);

      const bool masked = (causal && kt + TN - 1 > r0) || kt + TN > Sk;
#pragma unroll
      for (int idx = 0; idx < TN / 2; ++idx) {
        const int h = (idx >> 1) & 1;
        float pv = ex2(fmaf(s[idx], scale2, -lg[h]));
        if (masked) {
          const int key = kt + 8 * (idx >> 2) + col + (idx & 1);
          if (key >= Sk || (causal && key > row_lo + 8 * h)) pv = 0.f;
        }
        s[idx] = pv * (dp[idx] - dl[h]);  // dS
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) p[q] = pack_bf16(s[2 * q], s[2 * q + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk)  // k16 steps along the keys: 16 rows of K
        wgmma_pv(acc, p + 4 * kk, desc(kb + kk * 2048, TN * 128, 1024));
      wgmma_commit();
      prev = st;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    if (prev >= 0) mbar_arrive(&k_empty[prev]);
    store_rows<D>(dq + t.b * dqs.b + t.head * dqs.h, dqs.s, row_lo, Sq, acc, scale);
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
bwd_dkdv_sm90(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
              const float2* __restrict__ stats, int sq_pad, bf16* __restrict__ dk, Strides dks,
              bf16* __restrict__ dv, Strides dvs, float* __restrict__ part, int* __restrict__ done,
              int splits, int B, int Hkv, int Sq, int Sk, int G, int group, int causal,
              float scale) {
  using F = BwdCfg<D>;
  constexpr int STAGES = F::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* ks = smem;                        // [DB][TM][128 bytes]
  uint8_t* vs = ks + F::ROWS_BYTES;          // [DB][TM][128 bytes]
  uint8_t* qs = vs + F::ROWS_BYTES;          // [STAGES][DB][TN][128 bytes]
  uint8_t* dos = qs + STAGES * F::RING_BYTES;
  float2* sts = reinterpret_cast<float2*>(dos + STAGES * F::RING_BYTES);  // [STAGES][TN]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sts + STAGES * TN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const int Hq = Hkv * G;
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const Tile t = tile_of(tile, (Sk + TM - 1) / TM, B, Hkv, group, false);
  const int q_begin = causal ? t.r0 : 0;
  const int nq = Sq > q_begin ? (Sq - q_begin + TN - 1) / TN : 0;
  const int per = (G + splits - 1) / splits, g0 = split * per;  // this block's heads
  const int n = max(0, min(G, g0 + per) - g0) * nq;  // their query tiles, head by head

  // Q, dO and the (L log2 e, delta) pairs of iteration i into stage i % STAGES
  auto load = [&](int i) {
    const int s = i % STAGES, h = t.head * G + g0 + i / nq, qt = q_begin + (i % nq) * TN;
    mbar_expect_tx(&full[s], 2 * F::RING_BYTES + F::STAT_BYTES);
#pragma unroll
    for (int j = 0; j < F::DB; ++j) {
      tma_load_4d(qs + s * F::RING_BYTES + j * TN * 128, &map_q, 64 * j, qt, h, t.b, &full[s]);
      tma_load_4d(dos + s * F::RING_BYTES + j * TN * 128, &map_do, 64 * j, qt, h, t.b,
                  &full[s]);
    }
    bulk_load(sts + s * TN, stats + (static_cast<long long>(t.b) * Hq + h) * sq_pad + qt,
              F::STAT_BYTES, &full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DKDV_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kv_full, 2 * F::ROWS_BYTES);
#pragma unroll
    for (int j = 0; j < F::DB; ++j) {
      tma_load_4d(ks + j * TM * 128, &map_k, 64 * j, t.r0, t.head, t.b, kv_full);
      tma_load_4d(vs + j * TM * 128, &map_v, 64 * j, t.r0, t.head, t.b, kv_full);
    }
    for (int i = 0; i < min(n, STAGES); ++i) load(i);
  }
  __syncthreads();

  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;  // consumer c: keys 64c..64c+63
  const int warp = tid / 32, lane = tid % 32;
  const int col = 2 * (lane % 4);  // this thread's first query (of 8) in each n8 block
  const float scale2 = scale * LOG2E;
  const uint32_t ka = smem_addr(ks) + c * 64 * 128, va = smem_addr(vs) + c * 64 * 128;
  const int k0 = t.r0 + 64 * c;                  // this consumer's first key
  const int key_lo = k0 + 16 * warp + lane / 4;  // this thread's keys: key_lo, key_lo + 8

  float dk_acc[D / 2], dv_acc[D / 2], s[TN / 2], dp[TN / 2];
  uint32_t p[TN / 4], ds[TN / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  int next = STAGES;  // thread 0: the next iteration whose loads are to be issued
  bar_wait(kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES, qt = q_begin + (i % nq) * TN;
    bar_wait(&full[st], (i / STAGES) & 1);
    if (!causal || qt + TN - 1 >= k0) {  // else every query is left of this consumer's keys
      const uint32_t qb = smem_addr(qs + st * F::RING_BYTES);
      const uint32_t db = smem_addr(dos + st * F::RING_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // k16 steps along D: 32 bytes of a 128-byte row
        wgmma_qk(s, desc(ka + kk / 4 * TM * 128 + kk % 4 * 32, 16, 1024),
                 desc(qb + kk / 4 * TN * 128 + kk % 4 * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_qk(dp, desc(va + kk / 4 * TM * 128 + kk % 4 * 32, 16, 1024),
                 desc(db + kk / 4 * TN * 128 + kk % 4 * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const float2* sp = sts + st * TN;
      const bool masked = causal && qt < k0 + 63;
#pragma unroll
      for (int idx = 0; idx < TN / 2; ++idx) {
        const int qi = 8 * (idx >> 2) + col + (idx & 1);  // this entry's query in the tile
        const float2 ld = sp[qi];
        float pv = ex2(fmaf(s[idx], scale2, -ld.x));
        if (masked && key_lo + 8 * ((idx >> 1) & 1) > qt + qi) pv = 0.f;
        s[idx] = pv;
        dp[idx] = pv * (dp[idx] - ld.y);  // dS^T
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        p[q] = pack_bf16(s[2 * q], s[2 * q + 1]);
        ds[q] = pack_bf16(dp[2 * q], dp[2 * q + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk)  // k16 steps along the queries: 16 rows of dO, Q
        wgmma_pv(dv_acc, p + 4 * kk, desc(db + kk * 2048, TN * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk)
        wgmma_pv(dk_acc, ds + 4 * kk, desc(qb + kk * 2048, TN * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(p);
      fence_regs(ds);
    }
    mbar_arrive(&empty[st]);
    if (threadIdx.x == 0) {
      // refill, in order, each stage both consumers are done with; wait
      // only for the one this warpgroup reads next
      for (; next < n && next <= i + STAGES; ++next) {
        const uint32_t par = ((next - STAGES) / STAGES) & 1;
        if (!bar_done(&empty[next % STAGES], par)) {
          if (next > i + 1) break;
          bar_wait(&empty[next % STAGES], par);
        }
        load(next);
      }
    }
  }
  if (splits > 1) {
    // the heads' partial sums of this tile: each block writes its own, the
    // last to finish adds them all in split order (the same bits whichever
    // block is last) and stores dk and dv
    float* mine = part + (static_cast<long long>(tile) * splits + split) * DKDV_THREADS * D;
    float4* out = reinterpret_cast<float4*>(mine + threadIdx.x * D);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      out[i] = make_float4(dk_acc[4 * i], dk_acc[4 * i + 1], dk_acc[4 * i + 2], dk_acc[4 * i + 3]);
      out[D / 8 + i] =
          make_float4(dv_acc[4 * i], dv_acc[4 * i + 1], dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
    }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (threadIdx.x == 0) {
      last = atomicAdd(done + tile, 1) == splits - 1;
      if (last) done[tile] = 0;  // for the next launch
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    for (int j = 0; j < splits; ++j) {
      const volatile float* in = part + ((static_cast<long long>(tile) * splits + j) *
                                             DKDV_THREADS + threadIdx.x) * D;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dk_acc[i] += in[i];
        dv_acc[i] += in[D / 2 + i];
      }
    }
  }
  store_rows<D>(dk + t.b * dks.b + t.head * dks.h, dks.s, key_lo, Sk, dk_acc, scale);
  store_rows<D>(dv + t.b * dvs.b + t.head * dvs.h, dvs.s, key_lo, Sk, dv_acc, 1.f);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  // set on every launch: the limit belongs to the device current at the call
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// (b, head) pairs a group: their shared operands (`bytes_per_pair`) within
// 4 MiB of the L2, as the forward groups them
int group_of(long long pairs, long long bytes_per_pair) {
  return static_cast<int>(std::max(1ll, std::min(pairs, (4ll << 20) / bytes_per_pair)));
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float2* stats, int* counter,
           float* part, int* done, int splits, int B, int Hq, int Hkv, int Sq, int Sk,
           const long long* st, int causal, float scale, int phases, cudaStream_t stream) {
  using F = BwdCfg<D>;
  const int G = Hq / Hkv, sq_pad = (Sq + TM - 1) / TM * TM;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Strides os{st[9], st[10], st[11]}, dqs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
  cudaError_t err;
  if (phases & 1) {
    CUtensorMap mq, mdo, mk, mv;
    if (!make_map(&mq, q, D, Sq, Hq, B, st[0], st[1], st[2], TM) ||
        !make_map(&mdo, dout, D, Sq, Hq, B, st[12], st[13], st[14], TM) ||
        !make_map(&mk, k, D, Sk, Hkv, B, st[3], st[4], st[5], TN) ||
        !make_map(&mv, v, D, Sk, Hkv, B, st[6], st[7], st[8], TN))
      return -2;
    if ((err = allow_smem(bwd_dq_sm90<D>, F::DQ_SMEM)) != cudaSuccess) return err;
    const long long total = static_cast<long long>(sq_pad / TM) * B * Hq;
    bwd_dq_sm90<D><<<static_cast<unsigned>(std::min<long long>(total, sms)), THREADS,
                     F::DQ_SMEM, stream>>>(
        mq, mdo, mk, mv, static_cast<const bf16*>(o), os, lse, stats, sq_pad,
        static_cast<bf16*>(dq), dqs, counter, B, Hq, Sq, Sk, G,
        group_of(static_cast<long long>(B) * Hq, 4ll * Sk * D / G), causal, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phases & 2) {
    CUtensorMap mk, mv, mq, mdo;
    if (!make_map(&mk, k, D, Sk, Hkv, B, st[3], st[4], st[5], TM) ||
        !make_map(&mv, v, D, Sk, Hkv, B, st[6], st[7], st[8], TM) ||
        !make_map(&mq, q, D, Sq, Hq, B, st[0], st[1], st[2], TN) ||
        !make_map(&mdo, dout, D, Sq, Hq, B, st[12], st[13], st[14], TN))
      return -2;
    if ((err = allow_smem(bwd_dkdv_sm90<D>, F::DKDV_SMEM)) != cudaSuccess) return err;
    const long long total = static_cast<long long>((Sk + TM - 1) / TM) * B * Hkv;
    bwd_dkdv_sm90<D><<<static_cast<unsigned>(total * splits), DKDV_THREADS, F::DKDV_SMEM,
                       stream>>>(
        mk, mv, mq, mdo, stats, sq_pad, static_cast<bf16*>(dk), dks, static_cast<bf16*>(dv),
        dvs, part, done, splits, B, Hkv, Sq, Sk, G,
        group_of(static_cast<long long>(B) * Hkv, 4ll * Sq * D * G), causal, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// q, o, dout, dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Sk, D); bf16, each
// with its own (batch, head, seq) element strides (TMA-describable: bases
// 16-byte aligned, strides multiples of 8 elements) and a unit stride along
// D; Sq, Sk > 0. lse: the forward's fp32 (B, Hq, Sq), contiguous. stats:
// fp32 scratch of (B, Hq, Sq_pad, 2), Sq_pad = Sq rounded up to 128,
// contiguous, 16-byte aligned. counter: two ints, 0 before the launch and 0
// again after it (the dq launch resets them), not shared with a launch that
// may run at the same time. splits: the query-head groups a dk/dv work tile
// of 128 keys of a (b, kv-head) splits into (a block each; 1 where the work
// tiles fill the card); with splits > 1, part: fp32 scratch of
// tiles x splits x 256 x D, and done: one int a work tile, 0 before the
// launch and 0 again after it.
// phases: 3 runs both launches; 1 only dq (which writes stats), 2 only dk
// and dv (which read them), for timing the two apart. Returns -1 for a D
// not compiled (64, 128), -2 if a TMA descriptor is refused, else
// cudaGetLastError() of the first launch that fails, or 0.
extern "C" int flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* stats, int* counter, void* part,
    int* done, int splits, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, long long dsb, long long dsh, long long dss, long long dqsb,
    long long dqsh, long long dqss, long long dksb, long long dksh, long long dkss,
    long long dvsb, long long dvsh, long long dvss, int causal, float scale, int phases,
    void* stream) {
  const long long st[24] = {qsb, qsh,  qss,  ksb,  ksh,  kss,  vsb,  vsh,
                            vss, osb,  osh,  oss,  dsb,  dsh,  dss,  dqsb,
                            dqsh, dqss, dksb, dksh, dkss, dvsb, dvsh, dvss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float2* sp = static_cast<float2*>(stats);
  float* pp = static_cast<float*>(part);
  if (D == 64)
    return launch<64>(q, k, v, o, dout, l, dq, dk, dv, sp, counter, pp, done, splits, B, Hq,
                      Hkv, Sq, Sk, st, causal, scale, phases, s);
  if (D == 128)
    return launch<128>(q, k, v, o, dout, l, dq, dk, dv, sp, counter, pp, done, splits, B, Hq,
                       Hkv, Sq, Sk, st, causal, scale, phases, s);
  return -1;
}

// dynamic shared memory (bytes) of the dq (kernel 0) or the dk/dv (kernel 1)
// launch at head dim D, -1 if none
extern "C" int flash_attention_bwd_sm90_smem(int D, int kernel) {
  if (D == 64) return kernel == 0 ? BwdCfg<64>::DQ_SMEM : BwdCfg<64>::DKDV_SMEM;
  if (D == 128) return kernel == 0 ? BwdCfg<128>::DQ_SMEM : BwdCfg<128>::DKDV_SMEM;
  return -1;
}
