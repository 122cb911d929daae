// Fused causal/windowed attention with an online softmax for Hopper (sm_90a):
// K and V tiles fed by TMA into a ring of shared-memory stages, S = Q K^T
// and O += P V on wgmma, S, P and O in registers.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// for bf16 q, k, v at D = 64, 128 or 256 whose strides a TMA descriptor can
// describe (kernels/flash_attention/kernel.py::wgmma_eligible); the model's
// prefill takes this path (recurrentgemma's local attention at D = 256).
// Computes what flash_attention.cu computes, per
// (batch b, query head h, query row i):
//   s_j = softcap(q_i . k_j / sqrt(D)) over keys j of kv-head h / G that pass
//         the masks (j < Sk; causal: j <= i; window: j > i - window),
//   o_i = sum_j softmax(s)_j v_j,
// fp32 softmax statistics, P rounded to bf16 for the second product; a row
// whose keys are all masked gives 0.
//
// Structure. A work tile is 128 query rows of one (b, h) and the key tiles
// they see. Blocks are persistent, one per SM, each taking work tiles until
// none is left (see order below): one producer warpgroup, of which one
// thread issues the TMA loads, and two consumer warpgroups of 64 rows each
// (setmaxnreg moves registers from the producer, 24, to them, 240). The
// producer loads a work tile's Q once, then its K and V tiles of 128 keys
// into a ring of STAGES stages (2 at D = 128, 4 at D = 64); K and V have
// full and empty barriers of their own, so S = Q K^T starts while V is in
// flight and K's stage is refilled as soon as Q K^T is done. The ring runs
// on across work tiles, and Q has a full and an empty barrier, so the next
// tile's Q, K and V load while the consumers finish the last. Tensors are
// described as 4-D (D, S, H, B) with their own strides, so the model's
// (B, S, H, D) tensors pass as transposed views without a copy; a 128-byte
// swizzle row holds 64 of D, so D = 128 is two boxes. The TMA fills rows
// past Sq and Sk with zeros.
//
// D = 256 (recurrentgemma-2b): key tiles of 64, not 128. Q for the two
// consumers is 64 KB and two stages of K and V of 64 x 256 are 128 KB, 192
// KB in all; tiles of 128 keys would need 256 KB for one stage of each. The
// O accumulator of a consumer thread is 64 x 256 / 128 = 128 fp32 registers
// (m64n256k16 for P V), S and P 32 and 16 more, inside setmaxnreg's 240. The
// window's tiles: a work tile loads only the key tiles some of its rows see
// (from the tile holding key q0 - window + 1), so tiles wholly left of the
// window are skipped, never loaded; those it loads are masked only where
// the window's edge cuts them.
//
//   S = Q K^T  SS wgmma m64n128k16: Q and K both K-major (D contiguous).
//   O += P V   RS wgmma m64nDk16: the S accumulators, exponentiated and
//              rounded to bf16, are already the A fragment (thread (warp w,
//              lane l) holds rows 16w + l/4 (+8), keys 8j + 2(l%4) (+1)); V
//              (keys x D, D contiguous) is read MN-major through the
//              descriptor's transpose bit. P V of tile i runs while Q K^T of
//              tile i + 1 is issued.
//   softmax    ex2 of one FFMA a logit (the scale folded into log2(e), the
//              row maximum kept in raw units); row max and row sum across
//              the four lanes that share a row. Masks are computed only on
//              the tiles they cut (the causal diagonal, the window's left
//              edge, keys past Sk: zeros are not -inf); tiles wholly masked
//              for the work tile are never loaded.
//   order      (b, h) pairs in groups whose K and V fit 4 MiB, so that the
//              query tiles of one head run close together and find its K
//              and V in the L2; within a group the longest query tiles first
//              (causal tiles at S = 512 differ fourfold in work). A block
//              takes the next tile not yet taken (an atomic counter), so
//              blocks that drew short tiles take more and the last round is
//              of short tiles.
//
// Bound on an H100: at the served prefill shapes (8 x 512 tokens) the bytes
// (q, k, v read once, o written once) at 3.35 TB/s take longer than the bf16
// operations at 989 TFLOP/s (qwen3: 15.0 us against 8.7 us; gpt3: 120 us
// against 52 us). What holds the kernel above that: the two consumers run
// their softmax between their own products (taking turns at the tensor
// cores through named barriers was measured slower: one more issue step a
// key tile, and the turns serialize the short causal loops), the diagonal
// tile's masked half is computed, and O is stored from registers.

#include <cuda_bf16.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE_M = 128;  // query rows of a work tile: two consumers of 64

template <int D>
struct FlashCfg {
  static constexpr int BM = TILE_M;
  static constexpr int BN = D == 256 ? 64 : 128;  // keys per K or V tile
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int DB = D / 64;   // 64-wide blocks of D, one 128-byte swizzle row each
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one stage of K, or of V
  static constexpr int THREADS = 384;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + (2 + 4 * STAGES) * 8 + 8;
  static_assert(D == 64 || D == 128 || D == 256, "head dim");
  static_assert(SMEM <= 232448, "shared memory");
};

struct Strides {
  long long b, h, s;
};

#define F8(i)                                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 64 keys) (+)= Q K^T: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (64 x 128 keys) (+)= Q K^T: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 128) += P V: P from registers, V MN-major in shared memory
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 256) += P V: P from registers, V MN-major in shared memory (four
// 64-wide blocks of D, LBO bytes apart)
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72),
        F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 64) += P V
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One work tile: 128 query rows of one (b, h) and the key tiles they see.
struct Work {
  int q0, head, b, k_begin, n;
};

// Work tile w of nqt x B Hq: (b, h) pairs in groups of `group` (whose K and V
// stay in the L2 while the group runs), within a group the longest query
// tiles (the causal ones nearest the end) first; key tiles of BN
template <int BN>
__device__ __forceinline__ Work work_of(int w, int nqt, int B, int Hq, int group, int Sk,
                                        int causal, int window) {
  constexpr int BM = TILE_M;
  const int bh = B * Hq, per_group = nqt * group;
  const int g0 = w / per_group * group, rows = min(bh - g0, group), r = w % per_group;
  const int pair = g0 + r % rows;
  Work t;
  t.q0 = (nqt - 1 - r / rows) * BM;
  t.head = pair % Hq;
  t.b = pair / Hq;
  const int k_end = causal ? min(Sk, t.q0 + BM) : Sk;  // past the last key any row sees
  t.k_begin = window > 0 ? max(0, t.q0 - window + 1) / BN * BN : 0;
  t.n = k_end > t.k_begin ? (k_end - t.k_begin + BN - 1) / BN : 0;
  return t;
}

// Persistent: block j takes work tile j first, then the next one not yet
// taken (counter[0], an atomic count of the tiles handed out past the first
// gridDim.x), so that blocks that drew short tiles take more. The last block
// to run out resets both counters to 0 for the next launch. The ring's
// stages and phases run on across a block's work tiles, so the producer
// loads the next tile's Q and first K and V while the consumers finish the
// last one.
template <int D>
__global__ void __launch_bounds__(FlashCfg<D>::THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
               int* __restrict__ counter, Strides os, int B, int Hq, int Sq, int Sk, int G,
               int group, int causal, int window, float softcap, float scale) {
  using F = FlashCfg<D>;
  constexpr int BM = F::BM, BN = F::BN, STAGES = F::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;                           // [DB][BM][128 bytes]
  uint8_t* ks = qs + F::Q_BYTES;                // [STAGES][DB][BN][128 bytes]
  uint8_t* vs = ks + STAGES * F::KV_BYTES;      // [STAGES][DB][BN][128 bytes]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * F::KV_BYTES);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;
  volatile int* work = reinterpret_cast<volatile int*>(v_empty + STAGES);  // the tile Q holds
  const int nqt = (Sq + BM - 1) / BM, total = nqt * B * Hq;

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
        mbar_wait(q_empty, (wi & 1) ^ 1);  // the consumers are done with the last Q
        *work = w;
        if (w >= total) {  // none left: the consumers stop at this phase
          mbar_arrive(q_full);
          break;
        }
        const Work t = work_of<BN>(w, nqt, B, Hq, group, Sk, causal, window);
        const int hk = t.head / G;
        mbar_expect_tx(q_full, F::Q_BYTES);
#pragma unroll
        for (int j = 0; j < F::DB; ++j)
          tma_load_4d(qs + j * BM * 128, &map_q, 64 * j, t.q0, t.head, t.b, q_full);
        for (int i = 0; i < t.n; ++i, ++it) {
          const int s = it % STAGES, kt = t.k_begin + i * BN;
          const uint32_t par = ((it / STAGES) & 1) ^ 1;
          mbar_wait(&k_empty[s], par);
          mbar_expect_tx(&k_full[s], F::KV_BYTES);
#pragma unroll
          for (int j = 0; j < F::DB; ++j)
            tma_load_4d(ks + s * F::KV_BYTES + j * BN * 128, &map_k, 64 * j, kt, hk, t.b,
                        &k_full[s]);
          mbar_wait(&v_empty[s], par);
          mbar_expect_tx(&v_full[s], F::KV_BYTES);
#pragma unroll
          for (int j = 0; j < F::DB; ++j)
            tma_load_4d(vs + s * F::KV_BYTES + j * BN * 128, &map_v, 64 * j, kt, hk, t.b,
                        &v_full[s]);
        }
        w = gridDim.x + atomicAdd(counter, 1);
      }
      __threadfence();  // this block's last take is seen before its count below
      if (atomicAdd(counter + 1, 1) == gridDim.x - 1) {  // every block has run out
        counter[0] = 0;
        counter[1] = 0;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;  // this consumer's 64 rows of each work tile
  const int warp = tid / 32, lane = tid % 32;
  const int col = 2 * (lane % 4);  // this thread's first key (of 8) in each n8 block
  // logits in raw units: s, or (softcap / scale) tanh(s scale / softcap);
  // the exponent is scale log2(e) (x - max)
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f, cap_raw = softcap / scale;
  const float scale2 = scale * LOG2E;
  const uint32_t qa = smem_addr(qs) + c * 64 * 128;

  float acc[D / 2], s[BN / 2];
  uint32_t p[BN / 4];
  // S of the key tile at kt into probabilities relative to the new row
  // maxima m; corr = exp(old max - new max), by which l here and O before
  // the tile's P V are scaled; l: this thread's share of the row sums
  auto softmax = [&](int kt, int r0, int row_lo, float(&m)[2], float(&l)[2],
                     float(&corr)[2]) {
    if (softcap > 0.f) {  // cap; then mask where the tile cuts a mask
#pragma unroll
      for (int idx = 0; idx < BN / 2; ++idx) s[idx] = cap_raw * tanhf(s[idx] * cap_in);
    }
    const bool masked = (causal && kt + BN - 1 > r0) ||
                        (window > 0 && kt <= r0 + 63 - window) || kt + BN > Sk;
    if (masked) {
#pragma unroll
      for (int idx = 0; idx < BN / 2; ++idx) {
        const int key = kt + 8 * (idx >> 2) + col + (idx & 1);
        const int row = row_lo + 8 * ((idx >> 1) & 1);
        bool live = key < Sk;
        if (causal) live = live && row >= key;
        if (window > 0) live = live && key > row - window;
        s[idx] = live ? s[idx] : NEG_INF;
      }
    }
    float mt[2] = {m[0], m[1]}, ms[2];
#pragma unroll
    for (int idx = 0; idx < BN / 2; ++idx) mt[(idx >> 1) & 1] = fmaxf(mt[(idx >> 1) & 1], s[idx]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      corr[h] = ex2((m[h] - mt[h]) * scale2);
      m[h] = mt[h];
      l[h] *= corr[h];
      // a row with no live key yet: its masked entries must give 0, not 1
      ms[h] = m[h] > 0.5f * NEG_INF ? m[h] * scale2 : 0.f;
    }
#pragma unroll
    for (int idx = 0; idx < BN / 2; ++idx) {
      const int h = (idx >> 1) & 1;
      s[idx] = ex2(fmaf(s[idx], scale2, -ms[h]));
      l[h] += s[idx];
    }
  };
  int it = 0;  // key tiles consumed so far: the ring position
  for (int wi = 0;; ++wi) {
    mbar_wait(q_full, wi & 1);
    const int w = *work;
    if (w >= total) break;
    const Work t = work_of<BN>(w, nqt, B, Hq, group, Sk, causal, window);
    const int r0 = t.q0 + 64 * c;                    // this consumer's first row
    const int row_lo = r0 + 16 * warp + lane / 4;    // this thread's rows: row_lo, row_lo + 8
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's share of the sum

    if (t.n == 0) mbar_arrive(q_empty);
    int prev = -1;  // the stage of the tile whose P V is in flight
    float corr[2];
    for (int i = 0; i < t.n; ++i, ++it) {
      const int st = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      mbar_wait(&k_full[st], ph);
      const uint32_t kb = smem_addr(ks + st * F::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // k16 steps along D: 32 bytes of a 128-byte row
        wgmma_qk(s, desc(qa + kk / 4 * BM * 128 + kk % 4 * 32, 16, 1024),
                 desc(kb + kk / 4 * BN * 128 + kk % 4 * 32, 16, 1024), kk > 0);
      wgmma_commit();
      if (prev >= 0) {  // P V of the previous tile is done: its V stage is free
        wgmma_wait<1>();
        fence_regs(acc);
        fence_regs(p);
        mbar_arrive(&v_empty[prev]);
      }
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&k_empty[st]);  // Q K^T is done: K's stage is free, and Q after the last
      if (i == t.n - 1) mbar_arrive(q_empty);

      softmax(t.k_begin + i * BN, r0, row_lo, m, l, corr);
#pragma unroll
      for (int idx = 0; idx < D / 2; ++idx) acc[idx] *= corr[(idx >> 1) & 1];
#pragma unroll
      for (int q = 0; q < BN / 4; ++q) p[q] = pack_bf16(s[2 * q], s[2 * q + 1]);

      mbar_wait(&v_full[st], ph);
      const uint32_t vb = smem_addr(vs + st * F::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)  // k16 steps along the keys: 16 rows of V
        wgmma_pv(acc, p + 4 * kk, desc(vb + kk * 2048, BN * 128, 1024));
      wgmma_commit();
      prev = st;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    if (prev >= 0) mbar_arrive(&v_empty[prev]);

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.f / fmaxf(l[h], 1e-30f);
    }
    __nv_bfloat16* obase = o + t.b * os.b + t.head * os.h + col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = obase + static_cast<long long>(row) * os.s;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv[h], acc[4 * j + 2 * h + 1] * inv[h]);
    }
  }
}

// (B, H, S, D) bf16 with element strides (sb, sh, ss) and a unit stride along
// D, as a 4-D (D, S, H, B) map read in boxes of 64 of D by `rows` rows, the
// 128-byte swizzle; false if refused
bool make_map(CUtensorMap* map, const void* base, int D, long long S, long long H, long long B,
              long long sb, long long sh, long long ss, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss * 2), static_cast<cuuint64_t>(sh * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int* counter, int B, int Hq,
           int Hkv, int Sq, int Sk, const long long* st, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
  using F = FlashCfg<D>;
  CUtensorMap map_q, map_k, map_v;
  if (!make_map(&map_q, q, D, Sq, Hq, B, st[0], st[1], st[2], F::BM) ||
      !make_map(&map_k, k, D, Sk, Hkv, B, st[3], st[4], st[5], F::BN) ||
      !make_map(&map_v, v, D, Sk, Hkv, B, st[6], st[7], st[8], F::BN))
    return -2;
  auto kernel = flash_fwd_sm90<D>;
  // set on every launch: the limit belongs to the device current at the call
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // one block per SM, each taking work tiles; (b, h) pairs in groups whose
  // K and V take at most 4 MiB of the L2 (measured best of 4-24 MiB at the
  // served shapes: the query tiles of a head then run close together)
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long total = static_cast<long long>((Sq + F::BM - 1) / F::BM) * B * Hq;
  const long long kv_bytes = 4ll * Sk * D / (Hq / Hkv);  // K and V per query head
  const int group = static_cast<int>(
      std::max(1ll, std::min(static_cast<long long>(B) * Hq, (4ll << 20) / kv_bytes)));
  kernel<<<static_cast<unsigned>(std::min<long long>(total, sms)), F::THREADS, F::SMEM,
           stream>>>(map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), counter,
                     Strides{st[9], st[10], st[11]}, B, Hq, Sq, Sk, Hq / Hkv, group, causal,
                     window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o (B, Hq, Sq, D), bf16, each with
// its own (batch, head, seq) element strides (TMA-describable: bases 16-byte
// aligned, strides multiples of 8 elements) and a unit stride along D; Sq,
// Sk > 0. counter: two ints, 0 before the launch and 0 again after it (the
// kernel resets them), not shared with a launch that may run at the same
// time. Returns -1 for a D not compiled (64, 128, 256), -2 if a TMA descriptor is
// refused, else cudaGetLastError() after the launch.
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                        int* counter, int B, int Hq, int Hkv, int Sq, int Sk,
                                        int D,
                                        long long qsb, long long qsh, long long qss,
                                        long long ksb, long long ksh, long long kss,
                                        long long vsb, long long vsh, long long vss,
                                        long long osb, long long osh, long long oss, int causal,
                                        int window, float softcap, float scale, void* stream) {
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, counter, B, Hq, Hkv, Sq, Sk, st, causal, window, softcap,
                      scale, s);
  if (D == 128)
    return launch<128>(q, k, v, o, counter, B, Hq, Hkv, Sq, Sk, st, causal, window, softcap,
                       scale, s);
  if (D == 256)
    return launch<256>(q, k, v, o, counter, B, Hq, Hkv, Sq, Sk, st, causal, window, softcap,
                       scale, s);
  return -1;
}

// dynamic shared memory (bytes) of the kernel at head dim D, -1 if none
extern "C" int flash_attention_sm90_smem(int D) {
  return D == 64    ? FlashCfg<64>::SMEM
         : D == 128 ? FlashCfg<128>::SMEM
         : D == 256 ? FlashCfg<256>::SMEM
                    : -1;
}
