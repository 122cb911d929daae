// Backward of causal, windowed or full attention, with or without a logit
// softcap, for Hopper (sm_90a): Q, K, V, dO tiles fed by TMA into rings of
// shared-memory stages, every product on wgmma, the row log-sum-exp taken
// from the forward.
//
// Replaces no TPU kernel: the JAX package has no backward kernel, since
// jax.grad differentiates its jnp model in XLA. It is the gradient of
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas as the
// port's forward computes it (flash_attention_sm90.cu), and computes what
// flash_attention_bwd.cu computes, per (batch b, query head h, kv-head h/G):
//   c    = s, or (cap / scale) tanh(s scale / cap) under a softcap: the
//          forward's logits in raw units, s = q k^T, t the tanh;
//   P    = exp(c scale - L) over the live keys (key < Sk; causal: key <=
//          query; window: key > query - window), L the row log-sum-exp the
//          forward wrote,
//   dV   = sum over the G query heads of P^T dO,
//   dP   = dO V^T,   delta_i = sum_d dO_id O_id,
//   dS   = P (dP - delta), times 1 - t^2 under a softcap,
//   dQ   = dS K scale,   dK = sum over the G heads of dS^T Q scale.
// bf16 q, k, v, o, dO at D = 64, 128 or 256 whose strides a TMA descriptor
// can describe (kernels/flash_attention/kernel.py::bwd_wgmma_eligible); fp32
// sums; P and dS rounded to bf16 as a product's register operand. L is the
// natural log over the scaled (and capped) logits (flash_attention_sm90.cu's
// note), +inf for a row with no live key; the kernels take L log2(e), so
// that P is one FFMA and one ex2 (with one tanh before it under a softcap,
// rebuilding the forward's capped logit with its own arithmetic).
//
// Two launches, no atomics on the results, so dq, dk and dv are the same
// bits from run to run; seven products (S and dP in both launches):
//   1. dq: a work tile is 128 query rows of one (b, h), two consumers of 64
//      rows (64 rows at D = 256, below). It loads Q and dO once (TMA), reads
//      its rows of O once (16-byte loads), computes delta, and writes
//      (L log2(e), delta) of its rows to a (B, Hq, Sq_pad) scratch of pairs
//      (+inf and 0 past Sq). Then it walks
//      the key tiles of 64 its rows see (from the tile holding key
//      q0 - window + 1 under a window, up to the diagonal if causal), K and
//      V in a ring:
//        S = Q K^T and dP = dO V^T, SS wgmma m64n64k16, K-major operands;
//        P = ex2(c scale log2(e) - L log2(e)); dS -> bf16;
//        dQ += dS K, RS wgmma m64nDHk16, K read MN-major through the
//        descriptor's transpose bit (as the forward reads V).
//      dQ of one tile runs while S and dP of the next are issued. A consumer
//      that sees no key of a loaded tile (right of its rows, or left of its
//      window) skips its products, and first lets go of the tile whose dQ
//      product it still holds, so that the ring never waits on it.
//   2. dkdv: a work tile is KT keys of one (b, kv-head); K and V are loaded
//      once. It walks the G query heads and, for each, the query tiles of
//      64 that see its keys (from the diagonal on if causal, up to key
//      k0 + KT - 1 + window - 1 under a window); Q, dO and the tile's
//      (L log2 e, delta) pairs (a 512-byte bulk copy from the scratch) come
//      through a ring:
//        S^T = K Q^T and dP^T = V dO^T, SS m64n64k16;
//        P^T = ex2(c^T scale log2(e) - L log2(e)) by query column;
//        dS^T = P^T (dP^T - delta) (times 1 - t^2);
//        dV += P^T dO and dK += dS^T Q, RS m64nDHk16, dO and Q MN-major.
//      dK and dV stay in registers across the G heads and are written once.
//      At D = 64 and 128 a work tile is 128 keys, two consumers of 64 keys
//      with all of D each. At D = 128 a consumer thread holds dK and dV
//      (64 + 64 fp32), S^T and dP^T (32 + 32) and the two bf16 operands
//      (16 + 16): some 230 registers with the addresses. ptxas gives a
//      kernel of 384 threads at most 168 a thread whatever setmaxnreg asks
//      later (dk/dv spilled over 500 bytes so), and a block of 288 (a
//      producer warp beside two consumer warpgroups, 224 each) was refused
//      at launch: registers go by warpgroup. So this launch has the two
//      consumer warpgroups alone, at up to 255 registers, and their first
//      thread issues the loads: after each query tile it refills, in order,
//      the stages both consumers are done with, and waits only for the one
//      its own warpgroup reads next. One block a work tile, in the order of
//      the longest first. Where the work tiles are fewer than half the SMs
//      (qwen2-0.5b: 64 at 8 x 512, G = 7 on 2 kv-heads; recurrentgemma: 64
//      at 8 x 512 on 1 kv-head), a tile's G heads are split over as many
//      blocks as fill the card; each writes its partial dK and dV (fp32),
//      and the last of them (a counter a tile) adds them in a fixed order
//      and stores dk and dv, so the bits do not depend on which finished
//      last.
//
// D = 256 (recurrentgemma-2b). dK and dV of 64 keys at all of D would be
// 128 + 128 fp32 a consumer thread, and K and V of a 128-key tile 128 KB of
// shared memory beside a ring whose (Q, dO) stage of 64 rows is another 64
// KB. So both launches take work tiles of 64 rows (keys in dk/dv, queries
// in dq), and their two consumers take D's two halves of the same rows:
// each computes S and dP (S^T and dP^T) over all of D (those two products
// are done twice) and keeps its 128 columns of dK and dV (64 + 64 fp32 a
// thread, as at D = 128) or of dQ (64). The dq launch at 128 rows and all
// of D (dQ 128 fp32 a thread beside S, dP and P) spilled 460 bytes under
// the 168 registers ptxas gives a block of 384 threads. Shared memory: K
// and V (dk/dv) or Q and dO (dq) 64 KB, two ring stages of 64 rows 128 KB.
// recurrentgemma's 8 x 512 keys on 1 kv-head give 64 dk/dv work tiles, so
// G = 10 splits in two: 128 blocks.
//
// The window's tiles are skipped, never loaded, in both launches; masks are
// computed only on the tiles the diagonal, the window's edge or Sk cuts.
// Causal attention under a window always has the diagonal key live, so no
// row is empty; rows past Sq have L = +inf, whose P is 0. The TMA fills rows
// past Sq and Sk with zeros. Under a softcap each launch computes one tanh a
// logit again: at grok-1-314b's train shape (8, 48, 512, 128) that is 2 x
// 50 M tanh (the causal half), against 7 x 12.9 GFLOP of products.
//
// The dq launch follows the forward: persistent blocks, one per SM, taking
// work tiles from an atomic counter, the longest causal tiles first and the
// (b, head) pairs in groups whose shared operands stay in the L2; one
// producer warpgroup of which one thread issues the loads (setmaxnreg 24),
// two consumer warpgroups (240); full and empty mbarriers per stage.
//
// ptxas (-O3, sm_90a; chip_smoke.py's build phase prints each instance's
// registers, spills and shared memory): dq 168 registers in every
// instance, with no spill except under a softcap at D = 128 (40 bytes, 60
// with a window too); dk/dv 164-226 at D = 64 and 253-255 at D = 128 and
// 256, no spill. Shared memory: dq 134360, 199832 and 198744 bytes at D = 64, 128
// and 256, dk/dv 135280, 199760 and 198704. A dq of
// 256 threads that issued S and dP of the next key tile before the math of
// the current one (two register sets) gave the same bits but ran slower:
// ptxas serialized its wgmma (its warning C7515).
//
// Bound on an H100: at qwen3-1.7b's training shape (8, 16, 512, 128) causal
// the bytes (q, k, v, o, dO, L read once, dq, dk, dv written once: 100.9 MB,
// 30 us at 3.35 TB/s) take longer than the five causal-halved products at
// 989 TFLOP/s (21.6 GFLOP, 22 us); this design does seven (eleven at D =
// 256, where each launch computes S and dP twice).

#include <cuda_bf16.h>

#include <algorithm>

#include "flash_sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 384;       // dq: a producer warpgroup and two consumers
constexpr int DKDV_THREADS = 256;  // dk/dv: two consumer warpgroups
constexpr int TN = 64;             // rows of a ring tile: keys (dq) or queries (dk/dv)

typedef __nv_bfloat16 bf16;

template <int D>
struct BwdCfg {
  static constexpr int DB = D / 64;  // 64-wide blocks of D: 128-byte swizzle rows
  // SPLIT_D: a work tile's two consumers take D's halves of the same 64 rows
  // (queries in dq, keys in dk/dv), each keeping DH columns of dQ, or of dK
  // and dV; else each takes 64 rows of a 128-row tile with all of D
  static constexpr bool SPLIT_D = D == 256;
  static constexpr int DH = SPLIT_D ? D / 2 : D;
  static constexpr int ROWS = SPLIT_D ? 64 : 128;  // rows of a work tile
  static constexpr int STAGES = D == 64 ? 6 : D == 128 ? 4 : 2;
  static constexpr int PART = DH;                  // partial fp32 a thread: dK's and dV's
  static constexpr int TILE_BYTES = ROWS * D * 2;  // Q or dO (dq), K or V (dk/dv) of a work tile
  static constexpr int RING_BYTES = TN * D * 2;    // one stage of K or V (dq), Q or dO (dk/dv)
  static constexpr int STAT_BYTES = TN * 8;        // one stage of (L log2 e, delta) pairs
  static constexpr int DQ_BARS = (2 + 4 * STAGES) * 8 + 8;
  static constexpr int KV_BARS = (1 + 2 * STAGES) * 8 + 8;
  static constexpr int DQ_SMEM = 1024 + 2 * TILE_BYTES + 2 * STAGES * RING_BYTES + 2 * ROWS * 8 +
                                 DQ_BARS;
  static constexpr int DKDV_SMEM = 1024 + 2 * TILE_BYTES + STAGES * (2 * RING_BYTES + STAT_BYTES) +
                                   KV_BARS;
  static_assert(D == 64 || D == 128 || D == 256, "head dim");
  static_assert(DQ_SMEM <= 232448 && DKDV_SMEM <= 232448, "shared memory");
};

struct Strides {
  long long b, h, s;
};

struct Tile {
  int r0, head, b;  // first row (query in dq, key in dkdv), head, batch
};

// Work tile w of nt x B H (tiles of `rows` rows): (b, head) pairs in groups
// of `group` (whose shared operands stay in the L2 while the group runs),
// within a group the tiles from the last (dq: the causal query tiles that
// see the most keys) or from the first (dkdv: the key tiles that the most
// queries see)
__device__ __forceinline__ Tile tile_of(int w, int nt, int rows, int B, int H, int group,
                                        bool from_end) {
  const int bh = B * H, per_group = nt * group;
  const int g0 = w / per_group * group, n = min(bh - g0, group), r = w % per_group;
  const int pair = g0 + r % n, i = r / n;
  return Tile{(from_end ? nt - 1 - i : i) * rows, pair % H, pair / H};
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

// whether key `key` is live for query `query` under the causal mask and
// the window (0: none)
__device__ __forceinline__ bool live(int query, int key, int causal, int window) {
  return (!causal || key <= query) && (window <= 0 || key > query - window);
}

// The softcap in the forward's raw units: c = cap_raw tanh(s cap_in), with
// cap_in = scale / cap, cap_raw = cap / scale (both 0 without one)
struct Cap {
  float in, raw;
  __device__ __forceinline__ Cap(float softcap, float scale)
      : in(softcap > 0.f ? scale / softcap : 0.f), raw(softcap / scale) {}
};

// (P, dS) of a logit s (raw units) whose row has (L log2 e, delta) = (lg,
// dl), dp its dP entry: P = ex2(c scale2 - lg), dS = P (dp - dl) (1 - t^2).
// CAP (a softcap is on) and WIN (a window is) are each kernel's template
// arguments, so that a launch with neither carries none of their arithmetic
// or registers: with the window a runtime value the backward took 0.181 ms
// against 0.155 at qwen3-1.7b's shape and 0.133 against 0.105 at
// qwen2-0.5b's, the same bits (paired runs on an H100); templated, 0.156 and
// 0.105.
template <bool CAP>
__device__ __forceinline__ float2 p_ds(float s, float dp, float lg, float dl, float scale2,
                                       const Cap& cap) {
  if (CAP) {
    const float t = tanhf(s * cap.in);
    const float p = ex2(fmaf(cap.raw * t, scale2, -lg));
    return make_float2(p, p * (dp - dl) * (1.f - t * t));
  }
  const float p = ex2(fmaf(s, scale2, -lg));
  return make_float2(p, p * (dp - dl));
}

// 64 x N rows of an m64nN accumulator (thread: rows row_lo, row_lo + 8),
// times `scale`, into bf16 rows of `base`; rows at or past n are not written
template <int N>
__device__ __forceinline__ void store_rows(bf16* base, long long stride, int row_lo, int n,
                                           const float (&acc)[N / 2], float scale) {
  const int col = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    if (row >= n) continue;
    bf16* out = base + static_cast<long long>(row) * stride + col;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// 1. dq (and delta, and the scratch of (L log2 e, delta) pairs)
// ---------------------------------------------------------------------------

template <int D, bool CAP, bool WIN>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_sm90(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
            const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
            const bf16* __restrict__ o, Strides os, const float* __restrict__ lse,
            float2* __restrict__ stats, int sq_pad, bf16* __restrict__ dq, Strides dqs,
            int* __restrict__ counter, int B, int Hq, int Sq, int Sk, int G, int group,
            int causal, int window_arg, float softcap, float scale) {
  const int window = WIN ? window_arg : 0;  // 0 at compile time without one
  using F = BwdCfg<D>;
  constexpr int STAGES = F::STAGES, QT = F::ROWS, DH = F::DH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;                       // [DB][QT][128 bytes]
  uint8_t* dos = qs + F::TILE_BYTES;        // [DB][QT][128 bytes]
  uint8_t* ks = dos + F::TILE_BYTES;        // [STAGES][DB][TN][128 bytes]
  uint8_t* vs = ks + STAGES * F::RING_BYTES;
  float2* stat = reinterpret_cast<float2*>(vs + STAGES * F::RING_BYTES);  // [2][QT], by parity
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stat + 2 * QT);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;
  volatile int* work = reinterpret_cast<volatile int*>(v_empty + STAGES);
  const int nqt = (Sq + QT - 1) / QT, total = nqt * B * Hq;
  // the key tiles a work tile from query q0 loads: [k_begin, k_end)
  auto k_range = [&](int q0, int& k_begin, int& k_end) {
    k_end = causal ? min(Sk, q0 + QT) : Sk;
    k_begin = window > 0 ? max(0, q0 - window + 1) / TN * TN : 0;
  };

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
        const Tile t = tile_of(w, nqt, QT, B, Hq, group, true);
        const int hk = t.head / G;
        mbar_expect_tx(q_full, 2 * F::TILE_BYTES);
#pragma unroll
        for (int j = 0; j < F::DB; ++j) {
          tma_load_4d(qs + j * QT * 128, &map_q, 64 * j, t.r0, t.head, t.b, q_full);
          tma_load_4d(dos + j * QT * 128, &map_do, 64 * j, t.r0, t.head, t.b, q_full);
        }
        int k_begin, k_end;
        k_range(t.r0, k_begin, k_end);
        for (int kt = k_begin; kt < k_end; kt += TN, ++it) {
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
  // consumer c: rows 64c..64c+63 of the tile with all of D, or (SPLIT_D)
  // all 64 rows with columns DH c..DH c + DH - 1 of dQ
  const int c = wg - 1;
  const int ro = F::SPLIT_D ? 0 : 64 * c, dc = F::SPLIT_D ? DH * c : 0;
  const int warp = tid / 32, lane = tid % 32;
  const int col = 2 * (lane % 4);  // this thread's first key (of 8) in each n8 block
  const float scale2 = scale * LOG2E;
  const Cap cap(CAP ? softcap : 0.f, scale);
  const uint32_t qa = smem_addr(qs) + ro * 128, da = smem_addr(dos) + ro * 128;
  const float inf = __int_as_float(0x7f800000);

  float acc[DH / 2], s[TN / 2], dp[TN / 2];
  uint32_t p[TN / 4];
  int it = 0;  // key tiles consumed so far: the ring position
  for (int wi = 0;; ++wi) {
    bar_wait(q_full, wi & 1);
    const int w = *work;
    if (w >= total) break;
    const Tile t = tile_of(w, nqt, QT, B, Hq, group, true);
    const int r0 = t.r0 + ro;                      // this consumer's first row
    const int row_lo = r0 + 16 * warp + lane / 4;  // this thread's rows: row_lo, row_lo + 8
    const long long bh = static_cast<long long>(t.b) * Hq + t.head;

    // delta and L log2(e) of the consumer's rows, two threads a row (under
    // SPLIT_D both consumers compute those of the same rows, alike)
    {
      const int r = tid / 2, half = tid % 2, rr = ro + r, row = r0 + r;
      float sum = 0.f;
      if (row < Sq) {
        const bf16* orow = o + t.b * os.b + t.head * os.h + row * os.s + half * (D / 2);
#pragma unroll
        for (int ch = 0; ch < D / 16; ++ch) {  // 8-element chunks of this half of the row
          const int d0 = half * (D / 2) + 8 * ch, cc = (d0 % 64) / 8;
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * ch);
          const uint4 dv = *reinterpret_cast<const uint4*>(dos + (d0 / 64) * QT * 128 + rr * 128 +
                                                           ((cc ^ (rr % 8)) * 16));
          sum += dot8(ov, dv);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        const float2 st = row < Sq ? make_float2(lse[bh * Sq + row] * LOG2E, sum)
                                   : make_float2(inf, 0.f);
        stat[(wi & 1) * QT + rr] = st;
        if (c == 0 || !F::SPLIT_D) stats[bh * sq_pad + row] = st;
      }
    }
    bar_sync(1 + c, 128);
    const float2 st_lo = stat[(wi & 1) * QT + ro + 16 * warp + lane / 4];
    const float2 st_hi = stat[(wi & 1) * QT + ro + 16 * warp + lane / 4 + 8];
    const float lg[2] = {st_lo.x, st_hi.x}, dl[2] = {st_lo.y, st_hi.y};

#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    int k_begin, k_end;
    k_range(t.r0, k_begin, k_end);
    const int n = k_end > k_begin ? (k_end - k_begin + TN - 1) / TN : 0;
    if (n == 0) mbar_arrive(q_empty);
    int prev = -1;  // the stage of the tile whose dQ product is in flight
    for (int i = 0; i < n; ++i, ++it) {
      const int st = it % STAGES, kt = k_begin + i * TN;
      const uint32_t ph = (it / STAGES) & 1;
      bar_wait(&k_full[st], ph);
      bar_wait(&v_full[st], ph);
      // every key right of this consumer's rows, or left of its window
      if ((causal && kt > r0 + 63) || (window > 0 && kt + TN - 1 <= r0 - window)) {
        if (prev >= 0) {  // let go of the tile whose dQ is in flight first
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(p);
          mbar_arrive(&k_empty[prev]);
          prev = -1;
        }
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
        wgmma_qk(s, desc(qa + kk / 4 * QT * 128 + kk % 4 * 32, 16, 1024),
                 desc(kb + kk / 4 * TN * 128 + kk % 4 * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_qk(dp, desc(da + kk / 4 * QT * 128 + kk % 4 * 32, 16, 1024),
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

      const bool masked = (causal && kt + TN - 1 > r0) || kt + TN > Sk ||
                          (window > 0 && kt <= r0 + 63 - window);
#pragma unroll
      for (int idx = 0; idx < TN / 2; ++idx) {
        const int h = (idx >> 1) & 1;
        float2 pd = p_ds<CAP>(s[idx], dp[idx], lg[h], dl[h], scale2, cap);
        if (masked) {
          const int key = kt + 8 * (idx >> 2) + col + (idx & 1);
          if (key >= Sk || !live(row_lo + 8 * h, key, causal, window)) pd.y = 0.f;
        }
        s[idx] = pd.y;  // dS
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) p[q] = pack_bf16(s[2 * q], s[2 * q + 1]);
      // this consumer's DH columns of K: 64-wide blocks dc / 64 on
      const uint32_t kcol = kb + dc / 64 * TN * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk)  // k16 steps along the keys: 16 rows of K
        wgmma_pv(acc, p + 4 * kk, desc(kcol + kk * 2048, TN * 128, 1024));
      wgmma_commit();
      prev = st;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    if (prev >= 0) mbar_arrive(&k_empty[prev]);
    store_rows<DH>(dq + t.b * dqs.b + t.head * dqs.h + dc, dqs.s, row_lo, Sq, acc, scale);
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv
// ---------------------------------------------------------------------------

template <int D, bool CAP, bool WIN>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
bwd_dkdv_sm90(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
              const float2* __restrict__ stats, int sq_pad, bf16* __restrict__ dk, Strides dks,
              bf16* __restrict__ dv, Strides dvs, float* __restrict__ part, int* __restrict__ done,
              int splits, int B, int Hkv, int Sq, int Sk, int G, int group, int causal,
              int window_arg, float softcap, float scale) {
  const int window = WIN ? window_arg : 0;  // 0 at compile time without one
  using F = BwdCfg<D>;
  constexpr int STAGES = F::STAGES, KT = F::ROWS, DH = F::DH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* ks = smem;                        // [DB][KT][128 bytes]
  uint8_t* vs = ks + F::TILE_BYTES;          // [DB][KT][128 bytes]
  uint8_t* qs = vs + F::TILE_BYTES;          // [STAGES][DB][TN][128 bytes]
  uint8_t* dos = qs + STAGES * F::RING_BYTES;
  float2* sts = reinterpret_cast<float2*>(dos + STAGES * F::RING_BYTES);  // [STAGES][TN]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sts + STAGES * TN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const int Hq = Hkv * G;
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const Tile t = tile_of(tile, (Sk + KT - 1) / KT, KT, B, Hkv, group, false);
  // the query tiles that see this tile's keys: from the diagonal (causal),
  // up to the last query the window lets see its last key
  const int q_begin = causal ? t.r0 / TN * TN : 0;
  const int q_end = window > 0 ? min(Sq, t.r0 + KT - 1 + window) : Sq;
  const int nq = q_end > q_begin ? (q_end - q_begin + TN - 1) / TN : 0;
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
    mbar_expect_tx(kv_full, 2 * F::TILE_BYTES);
#pragma unroll
    for (int j = 0; j < F::DB; ++j) {
      tma_load_4d(ks + j * KT * 128, &map_k, 64 * j, t.r0, t.head, t.b, kv_full);
      tma_load_4d(vs + j * KT * 128, &map_v, 64 * j, t.r0, t.head, t.b, kv_full);
    }
    for (int i = 0; i < min(n, STAGES); ++i) load(i);
  }
  __syncthreads();

  // consumer c: keys 64c..64c+63 of the tile with all of D, or (SPLIT_D)
  // all 64 keys with columns DH c..DH c + DH - 1 of dK and dV
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int col = 2 * (lane % 4);  // this thread's first query (of 8) in each n8 block
  const int ko = F::SPLIT_D ? 0 : 64 * c, dc = F::SPLIT_D ? DH * c : 0;
  const float scale2 = scale * LOG2E;
  const Cap cap(CAP ? softcap : 0.f, scale);
  const uint32_t ka = smem_addr(ks) + ko * 128, va = smem_addr(vs) + ko * 128;
  const int k0 = t.r0 + ko;                      // this consumer's first key
  const int key_lo = k0 + 16 * warp + lane / 4;  // this thread's keys: key_lo, key_lo + 8

  float dk_acc[DH / 2], dv_acc[DH / 2], s[TN / 2], dp[TN / 2];
  uint32_t p[TN / 4], ds[TN / 4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  int next = STAGES;  // thread 0: the next iteration whose loads are to be issued
  bar_wait(kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES, qt = q_begin + (i % nq) * TN;
    bar_wait(&full[st], (i / STAGES) & 1);
    // else every query is left of this consumer's keys, or past its window
    if ((!causal || qt + TN - 1 >= k0) && (window <= 0 || qt < k0 + 63 + window)) {
      const uint32_t qb = smem_addr(qs + st * F::RING_BYTES);
      const uint32_t db = smem_addr(dos + st * F::RING_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // k16 steps along D: 32 bytes of a 128-byte row
        wgmma_qk(s, desc(ka + kk / 4 * KT * 128 + kk % 4 * 32, 16, 1024),
                 desc(qb + kk / 4 * TN * 128 + kk % 4 * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_qk(dp, desc(va + kk / 4 * KT * 128 + kk % 4 * 32, 16, 1024),
                 desc(db + kk / 4 * TN * 128 + kk % 4 * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const float2* sp = sts + st * TN;
      const bool masked = (causal && qt < k0 + 63) || (window > 0 && qt + TN - 1 >= k0 + window);
#pragma unroll
      for (int idx = 0; idx < TN / 2; ++idx) {
        const int qi = 8 * (idx >> 2) + col + (idx & 1);  // this entry's query in the tile
        const float2 ld = sp[qi];
        float2 pd = p_ds<CAP>(s[idx], dp[idx], ld.x, ld.y, scale2, cap);
        if (masked && !live(qt + qi, key_lo + 8 * ((idx >> 1) & 1), causal, window))
          pd = make_float2(0.f, 0.f);
        s[idx] = pd.x;
        dp[idx] = pd.y;  // dS^T
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        p[q] = pack_bf16(s[2 * q], s[2 * q + 1]);
        ds[q] = pack_bf16(dp[2 * q], dp[2 * q + 1]);
      }
      // this consumer's DH columns of dO and Q: 64-wide blocks dc / 64 on
      const uint32_t qcol = qb + dc / 64 * TN * 128, dcol = db + dc / 64 * TN * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk)  // k16 steps along the queries: 16 rows of dO, Q
        wgmma_pv(dv_acc, p + 4 * kk, desc(dcol + kk * 2048, TN * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk)
        wgmma_pv(dk_acc, ds + 4 * kk, desc(qcol + kk * 2048, TN * 128, 1024));
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
    float* mine = part + (static_cast<long long>(tile) * splits + split) * DKDV_THREADS * F::PART;
    float4* out = reinterpret_cast<float4*>(mine + threadIdx.x * F::PART);
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      out[i] = make_float4(dk_acc[4 * i], dk_acc[4 * i + 1], dk_acc[4 * i + 2], dk_acc[4 * i + 3]);
      out[DH / 8 + i] =
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
    for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    for (int j = 0; j < splits; ++j) {
      const volatile float* in = part + ((static_cast<long long>(tile) * splits + j) *
                                             DKDV_THREADS + threadIdx.x) * F::PART;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) {
        dk_acc[i] += in[i];
        dv_acc[i] += in[DH / 2 + i];
      }
    }
  }
  store_rows<DH>(dk + t.b * dks.b + t.head * dks.h + dc, dks.s, key_lo, Sk, dk_acc, scale);
  store_rows<DH>(dv + t.b * dvs.b + t.head * dvs.h + dc, dvs.s, key_lo, Sk, dv_acc, 1.f);
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

template <int D, bool CAP, bool WIN>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float2* stats, int* counter,
           float* part, int* done, int splits, int B, int Hq, int Hkv, int Sq, int Sk,
           const long long* st, int causal, int window, float softcap, float scale, int phases,
           cudaStream_t stream) {
  using F = BwdCfg<D>;
  const int G = Hq / Hkv, sq_pad = (Sq + 127) / 128 * 128;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Strides os{st[9], st[10], st[11]}, dqs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
  cudaError_t err;
  if (phases & 1) {
    CUtensorMap mq, mdo, mk, mv;
    if (!make_map(&mq, q, D, Sq, Hq, B, st[0], st[1], st[2], F::ROWS) ||
        !make_map(&mdo, dout, D, Sq, Hq, B, st[12], st[13], st[14], F::ROWS) ||
        !make_map(&mk, k, D, Sk, Hkv, B, st[3], st[4], st[5], TN) ||
        !make_map(&mv, v, D, Sk, Hkv, B, st[6], st[7], st[8], TN))
      return -2;
    if ((err = allow_smem(bwd_dq_sm90<D, CAP, WIN>, F::DQ_SMEM)) != cudaSuccess) return err;
    const long long total = static_cast<long long>((Sq + F::ROWS - 1) / F::ROWS) * B * Hq;
    bwd_dq_sm90<D, CAP, WIN><<<static_cast<unsigned>(std::min<long long>(total, sms)), THREADS,
                     F::DQ_SMEM, stream>>>(
        mq, mdo, mk, mv, static_cast<const bf16*>(o), os, lse, stats, sq_pad,
        static_cast<bf16*>(dq), dqs, counter, B, Hq, Sq, Sk, G,
        group_of(static_cast<long long>(B) * Hq, 4ll * Sk * D / G), causal, window, softcap,
        scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phases & 2) {
    CUtensorMap mk, mv, mq, mdo;
    if (!make_map(&mk, k, D, Sk, Hkv, B, st[3], st[4], st[5], F::ROWS) ||
        !make_map(&mv, v, D, Sk, Hkv, B, st[6], st[7], st[8], F::ROWS) ||
        !make_map(&mq, q, D, Sq, Hq, B, st[0], st[1], st[2], TN) ||
        !make_map(&mdo, dout, D, Sq, Hq, B, st[12], st[13], st[14], TN))
      return -2;
    if ((err = allow_smem(bwd_dkdv_sm90<D, CAP, WIN>, F::DKDV_SMEM)) != cudaSuccess) return err;
    const long long total = static_cast<long long>((Sk + F::ROWS - 1) / F::ROWS) * B * Hkv;
    bwd_dkdv_sm90<D, CAP, WIN><<<static_cast<unsigned>(total * splits), DKDV_THREADS, F::DKDV_SMEM,
                       stream>>>(
        mk, mv, mq, mdo, stats, sq_pad, static_cast<bf16*>(dk), dks, static_cast<bf16*>(dv),
        dvs, part, done, splits, B, Hkv, Sq, Sk, G,
        group_of(static_cast<long long>(B) * Hkv, 4ll * Sq * D * G), causal, window, softcap,
        scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// q, o, dout, dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Sk, D); bf16, each
// with its own (batch, head, seq) element strides (TMA-describable: bases
// 16-byte aligned, strides multiples of 8 elements) and a unit stride along
// D; Sq, Sk > 0. lse: the forward's fp32 (B, Hq, Sq), contiguous, under the
// same causal, window and softcap. stats: fp32 scratch of (B, Hq, Sq_pad,
// 2), Sq_pad = Sq rounded up to 128, contiguous, 16-byte aligned. counter:
// two ints, 0 before the launch and 0 again after it (the dq launch resets
// them), not shared with a launch that may run at the same time. splits:
// the query-head groups a dk/dv work tile (128 keys of a (b, kv-head), 64
// at D = 256) splits into (a block each; 1 where the work tiles fill the
// card); with splits > 1, part: fp32 scratch of tiles x splits x 256 x
// flash_attention_bwd_sm90_part(D), and done: one int a work tile, 0 before
// the launch and 0 again after it. window: 0 for none; softcap: 0 for none.
// phases: 3 runs both launches; 1 only dq (which writes stats), 2 only dk
// and dv (which read them), for timing the two apart. Returns -1 for a D
// not compiled (64, 128, 256), -2 if a TMA descriptor is refused, else
// cudaGetLastError() of the first launch that fails, or 0.
extern "C" int flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* stats, int* counter, void* part,
    int* done, int splits, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, long long dsb, long long dsh, long long dss, long long dqsb,
    long long dqsh, long long dqss, long long dksb, long long dksh, long long dkss,
    long long dvsb, long long dvsh, long long dvss, int causal, int window, float softcap,
    float scale, int phases, void* stream) {
  const long long st[24] = {qsb, qsh,  qss,  ksb,  ksh,  kss,  vsb,  vsh,
                            vss, osb,  osh,  oss,  dsb,  dsh,  dss,  dqsb,
                            dqsh, dqss, dksb, dksh, dkss, dvsb, dvsh, dvss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float2* sp = static_cast<float2*>(stats);
  float* pp = static_cast<float*>(part);
#define BWD_ARGS                                                                          \
  q, k, v, o, dout, l, dq, dk, dv, sp, counter, pp, done, splits, B, Hq, Hkv, Sq, Sk, st, \
      causal, window, softcap, scale, phases, s
#define BWD_LAUNCH(DD)                                                                    \
  (softcap > 0.f ? (window > 0 ? launch<DD, true, true>(BWD_ARGS)                         \
                               : launch<DD, true, false>(BWD_ARGS))                       \
                 : (window > 0 ? launch<DD, false, true>(BWD_ARGS)                        \
                               : launch<DD, false, false>(BWD_ARGS)))
  if (D == 64) return BWD_LAUNCH(64);
  if (D == 128) return BWD_LAUNCH(128);
  if (D == 256) return BWD_LAUNCH(256);
#undef BWD_LAUNCH
#undef BWD_ARGS
  return -1;
}

// dynamic shared memory (bytes) of the dq (kernel 0) or the dk/dv (kernel 1)
// launch at head dim D, -1 if none
extern "C" int flash_attention_bwd_sm90_smem(int D, int kernel) {
  if (D == 64) return kernel == 0 ? BwdCfg<64>::DQ_SMEM : BwdCfg<64>::DKDV_SMEM;
  if (D == 128) return kernel == 0 ? BwdCfg<128>::DQ_SMEM : BwdCfg<128>::DKDV_SMEM;
  if (D == 256) return kernel == 0 ? BwdCfg<256>::DQ_SMEM : BwdCfg<256>::DKDV_SMEM;
  return -1;
}
