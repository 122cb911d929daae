// One-query (decode) attention over a bf16 KV cache for Hopper (sm_90a), a
// kv-head's query heads on the tensor cores, the live keys cut into equal
// segments of the card's blocks, all in one launch.
//
// Replaces src/repro/kernels/decode_attention/kernel.py:61
// (decode_attention_pallas) for bf16 calls whose q, K and V bases and strides
// allow 16-byte loads (decode_attention/kernel.py::chunked_eligible) at more
// than CHUNKED_MAX_G query heads a kv-head (decode_attention/kernel.py::
// decode_kernel), at D in {32, 64, 128, 256}. Computes, per (batch b, kv-head h,
// query head g of the group):
//   s_t = softcap(q_g . k_t * scale) for t < lengths[b],
//   o_g = sum_t softmax(s)_t v_t,
// with P rounded to bf16 before P V, as the plain version does
// (decode_attention/ref.py), and fp32 sums. Keys at or past lengths[b] are
// not read; a slot at length 0 writes zeros.
//
// Bound on an H100: bytes. Each live key and value row is read once for all
// the G query heads of its kv-head: 4 G operations a byte of K and V.
//
// Design. The TPU kernel computes a (G x D) . (D x bk) product a key block
// on its matrix unit; here the group's query heads, padded to 16 rows, are
// the A operand of mma.sync m16n8k16 (bf16 in, fp32 sums): S = Q K^T over a
// unit of UK = 16 keys is two n8 blocks, and the S fragments, scaled, capped,
// masked and exponentiated in registers (row maxima and sums over the quad
// of lanes that shares a row), are rounded to bf16 and are exactly the A
// operand of P V; V's B fragments come by ldmatrix.trans (mma.sync and not
// wgmma: the kernel is bound by bytes, and an item has 16 rows, not 64). A
// group above 16 heads is cut into items of 16 (each reads K and V again).
// Work: a unit is UK keys of one (b, item); a slot walks max(1, ceil(len /
// UK)) units, counted from the lengths on the device (the host never reads
// them). Every block cuts each (b, item) run into segments of P units, P
// the least for which all the segments fit the grid (one segment a block;
// only where there are more runs than blocks do blocks take several in
// turn), but at least ceil(longest slot's units / n_seg_max), so that no run has
// more than n_seg_max segments. A block has 4 workers, a warp each or at
// D = 256 a pair of warps, each warp copying half of D of K and V and
// holding that half of the O tile (16 x 256 fp32 would not fit one warp's
// registers), both computing S from the whole K tile; worker w takes units
// w, w + 4, ... of the segment and keeps its own ring of STAGES units in
// shared memory, filled by cp.async (16-byte copies, zero-filled past the
// length) two units ahead of the tensor cores, with a warp (pair) barrier
// and no block barrier a unit. The block merges its workers' softmax states
// in shared memory in worker order; a run of one segment writes the output,
// else each segment writes its state to a scratch sized from T and takes a
// ticket from a per-run counter (a fence before it); the block that draws
// the last ticket merges the run's states in segment order (the same sums
// in the same order on every launch: the grid is fixed for a card), writes
// the output and resets the counter to 0 for the next launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ROWS = 16;     // query heads of an item: the m16 of mma.sync
constexpr int UK = 16;       // keys of a unit: two n8 blocks of S, one k16 step of P V
constexpr int STAGES = 3;    // a worker's ring of units
constexpr int PAD = 8;       // bf16 row padding: 16 bytes, so ldmatrix rows spread over banks
constexpr int MAX_SEGS = 32; // segments of a run, at most (n_seg_max <= MAX_SEGS)
constexpr int SLOT_SLACK = 1024;  // bytes of slot tables the occupancy is asked with

struct KV {
  long long b, t, h;  // element strides of k and v (B, T, Hkv, D); D contiguous
};

template <int D>
struct Cfg {
  static constexpr int WPI = D == 256 ? 2 : 1;  // warps of a worker
  static constexpr int DW = D / WPI;            // columns of D a warp copies (K, V) and holds (O)
  static constexpr int NWK = 4;                 // workers of a block
  static constexpr int WARPS = NWK * WPI, THREADS = WARPS * 32;
  static constexpr int KROW = D + PAD, VROW = DW + PAD;
  // a stage of a worker: the unit's K rows (all of D, S needs them) and
  // each of its warps' V columns
  static constexpr int STAGE = UK * KROW + WPI * UK * VROW;  // bf16 elements
  static constexpr int RING = NWK * STAGES * STAGE;          // bf16 elements
  static constexpr int QTILE = ROWS * KROW;                  // bf16 elements
  // over the ring once every worker is done with it: the workers' states,
  // then a run's segments' m and l (m then their weights) and its rows' sums
  static constexpr int MERGE = 2 * NWK * ROWS + NWK * ROWS * D;  // fp32
  static constexpr int WEIGHTS = 2 * ROWS * MAX_SEGS + ROWS;     // fp32
  static_assert((MERGE + WEIGHTS) * 4 <= RING * 2, "the merge must fit over the ring");
  static constexpr int SMEM = (RING + QTILE) * 2;  // bytes, then 2 B + 1 ints of slot tables
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, L2 only; zero-filled (nothing read) unless live
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// the warps of a worker wait for each other: one warp, or a pair (named
// barrier 1 + worker; 0 is __syncthreads)
template <int WPI>
__device__ __forceinline__ void worker_sync(int wk) {
  if (WPI == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wk), "r"(32 * WPI) : "memory");
}

// units of a slot: at least 1, so that a slot at length 0 writes zeros
__device__ __forceinline__ int slot_units(int len) { return len > UK ? (len + UK - 1) / UK : 1; }

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// q (B, Hkv, G, D), out the same, contiguous; part: fp32 m, l (rows *
// n_seg_max each) then acc (rows * n_seg_max * D), rows = B * Hkv * G;
// tickets: one int per (b, item), B * Hkv * ceil(G / 16), 0 between
// launches. Dynamic shared memory: Cfg<D>::SMEM bytes, then 2 B + 1 ints.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
decode_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
           float* __restrict__ part, int* __restrict__ tickets,
           __nv_bfloat16* __restrict__ out, int B, int T, int Hkv, int G, int n_seg_max,
           KV ks, KV vs, float softcap, float scale) {
  using C = Cfg<D>;
  constexpr int THREADS = C::THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = ring + C::RING;
  int* sm_len = reinterpret_cast<int*>(qs + C::QTILE);  // [B] lengths, clamped to [0, T]
  int* sm_seg0 = sm_len + B;                           // [B + 1] a slot's first segment
  __shared__ int sm_P, sm_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int HC = (G + ROWS - 1) / ROWS, HH = Hkv * HC;  // items a slot
  const long long rows = static_cast<long long>(B) * Hkv * G;
  float* part_m = part;
  float* part_l = part + rows * n_seg_max;
  float* part_acc = part + 2 * rows * n_seg_max;

  // the slots' lengths, read once; then P, the units of a segment: the least
  // at which every segment has a block (searched by warp 0, lanes over the
  // slots), at least ceil(longest / n_seg_max)
  for (int b = tid; b < B; b += THREADS) sm_len[b] = min(max(__ldg(lengths + b), 0), T);
  __syncthreads();
  if (warp == 0) {
    int longest = 1, units = 0;
    for (int b = lane; b < B; b += 32) {
      const int u = slot_units(sm_len[b]);
      longest = max(longest, u);
      units += u;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      longest = max(longest, __shfl_xor_sync(0xffffffffu, longest, off));
    units = warp_sum(units) * HH;
    const int grid = gridDim.x;
    int lo = max((longest + n_seg_max - 1) / n_seg_max, (units + grid - 1) / grid);
    int hi = longest;
    lo = min(lo, hi);
    while (lo < hi) {  // segments(P) falls as P grows; at P = longest it is B * HH
      const int mid = (lo + hi) / 2;
      int segs = 0;
      for (int b = lane; b < B; b += 32) segs += (slot_units(sm_len[b]) + mid - 1) / mid;
      if (warp_sum(segs) * HH <= grid)
        hi = mid;
      else
        lo = mid + 1;
    }
    if (lane == 0) sm_P = lo;
  }
  __syncthreads();
  const int P = sm_P;
  if (tid == 0) {
    sm_seg0[0] = 0;
    for (int b = 0; b < B; ++b)
      sm_seg0[b + 1] = sm_seg0[b] + HH * ((slot_units(sm_len[b]) + P - 1) / P);
  }
  __syncthreads();
  const int total = sm_seg0[B];

  const int wk = warp / C::WPI, half = warp % C::WPI;  // the worker, and its warp's half of D
  __nv_bfloat16* wring = ring + wk * STAGES * C::STAGE;
  const int r_lo = lane / 4, r_hi = r_lo + 8, col = 2 * (lane % 4);

  for (int seg = blockIdx.x; seg < total; seg += gridDim.x) {
    int lo_b = 0, hi_b = B - 1;
    while (lo_b < hi_b) {  // the last slot whose first segment is <= seg
      const int mid = (lo_b + hi_b + 1) / 2;
      if (sm_seg0[mid] <= seg)
        lo_b = mid;
      else
        hi_b = mid - 1;
    }
    const int b = lo_b, len = sm_len[b];
    const int nseg = (sm_seg0[b + 1] - sm_seg0[b]) / HH;  // segments of each run of slot b
    const int hh = (seg - sm_seg0[b]) / nseg, s = (seg - sm_seg0[b]) % nseg;
    const int hk = hh / HC, g0 = (hh % HC) * ROWS, ng = min(ROWS, G - g0);
    const int c0 = s * P, nu = min(P, slot_units(len) - c0);  // the segment's units
    const int mine = nu > wk ? (nu - wk + C::NWK - 1) / C::NWK : 0;
    const long long row0 = (static_cast<long long>(b) * Hkv + hk) * G + g0;
    const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h + half * C::DW;
    const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h + half * C::DW;

    // the item's query rows (zeros past its heads), one group of copies
    for (int c = tid; c < ROWS * (D / 8); c += THREADS) {
      const int r = c / (D / 8), d = (c % (D / 8)) * 8;
      cp_async16(qs + r * C::KROW + d, q + (row0 + min(r, ng - 1)) * D + d, r < ng);
    }
    cp_commit();
    // unit i of this worker into stage i % STAGES: its warp's columns of
    // the K rows and of the V rows (one group, empty past the last unit)
    auto stage_unit = [&](int i) {
      if (i < mine) {
        const int t0 = (c0 + wk + i * C::NWK) * UK;
        __nv_bfloat16* kd = wring + (i % STAGES) * C::STAGE + half * C::DW;
        __nv_bfloat16* vd = wring + (i % STAGES) * C::STAGE + UK * C::KROW + half * UK * C::VROW;
        constexpr int CH = C::DW / 8;  // 16-byte chunks of a row's columns
#pragma unroll
        for (int j = 0; j < UK * CH / 32; ++j) {
          const int c = lane + 32 * j, r = c / CH, d = (c % CH) * 8, t = t0 + r;
          const bool live = t < len;
          const long long tt = live ? t : 0;  // an address in the slot when nothing is read
          cp_async16(kd + r * C::KROW + d, kb + tt * ks.t + d, live);
          cp_async16(vd + r * C::VROW + d, vb + tt * vs.t + d, live);
        }
      }
      cp_commit();
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) stage_unit(i);
    cp_wait<STAGES - 1>();  // the query rows (this thread's copies)
    __syncthreads();        // ... and every thread's

    // the worker's softmax state: m per row (the same on the quad), l this
    // lane's share (summed over the quad at the end), O in mma fragments
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
    float acc[C::DW / 8][4];
#pragma unroll
    for (int n = 0; n < C::DW / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int i = 0; i < mine; ++i) {
      cp_wait<STAGES - 2>();  // unit i has landed (this thread's copies)
      worker_sync<C::WPI>(wk);  // ... every copy of the worker's, and unit i - 1 is used
      stage_unit(i + STAGES - 1);    // into the stage unit i - 1 held
      const __nv_bfloat16* Ks = wring + (i % STAGES) * C::STAGE;
      const __nv_bfloat16* Vs = Ks + UK * C::KROW + half * UK * C::VROW;
      const int t0 = (c0 + wk + i * C::NWK) * UK;

      // S = Q K^T: K rows are the column-major B operand as stored
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qf[4], kf[4];
        ldsm_x4(qf, qs + (lane % 16) * C::KROW + kk * 16 + (lane / 16) * 8);
        ldsm_x4(kf, Ks + ((lane / 16) * 8 + lane % 8) * C::KROW + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(sc[0], qf, kf[0], kf[1]);
        mma_bf16(sc[1], qf, kf[2], kf[3]);
      }
      // scale, cap and mask; row maxima over the quad of lanes sharing a row
      float mt_lo = NEG_INF, mt_hi = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          x = t0 + 8 * j + col + (e & 1) < len ? x : NEG_INF;
          sc[j][e] = x;
          if (e < 2)
            mt_lo = fmaxf(mt_lo, x);
          else
            mt_hi = fmaxf(mt_hi, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mt_lo = fmaxf(mt_lo, __shfl_xor_sync(0xffffffffu, mt_lo, off));
        mt_hi = fmaxf(mt_hi, __shfl_xor_sync(0xffffffffu, mt_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mt_lo), mn_hi = fmaxf(m_hi, mt_hi);
      const float corr_lo = __expf(m_lo - mn_lo), corr_hi = __expf(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= corr_lo;
      l_hi *= corr_hi;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mn = e < 2 ? mn_lo : mn_hi;
          const float p = sc[j][e] > 0.5f * NEG_INF ? __expf(sc[j][e] - mn) : 0.f;
          sc[j][e] = p;
          if (e < 2)
            l_lo += p;
          else
            l_hi += p;
        }
#pragma unroll
      for (int n = 0; n < C::DW / 8; ++n) {
        acc[n][0] *= corr_lo;
        acc[n][1] *= corr_lo;
        acc[n][2] *= corr_hi;
        acc[n][3] *= corr_hi;
      }
      // O += P V: P from registers (rounded to bf16), V through ldmatrix.trans
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int n = 0; n < C::DW / 8; n += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vs + (((lane / 8) % 2) * 8 + lane % 8) * C::VROW + (n + lane / 16) * 8);
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }

    // the block's state: its workers' merged in worker order, in shared
    // memory over the ring (every copy has landed: the groups left are empty)
    cp_wait<0>();
    __syncthreads();
    float* mg_m = reinterpret_cast<float*>(smem_raw);
    float* mg_l = mg_m + C::NWK * ROWS;
    float* mg_acc = mg_l + C::NWK * ROWS;
    if (half == 0 && lane % 4 == 0) {
      mg_m[wk * ROWS + r_lo] = m_lo;
      mg_m[wk * ROWS + r_hi] = m_hi;
      mg_l[wk * ROWS + r_lo] = l_lo;
      mg_l[wk * ROWS + r_hi] = l_hi;
    }
#pragma unroll
    for (int n = 0; n < C::DW / 8; ++n) {
      const int d = half * C::DW + n * 8 + col;
      *reinterpret_cast<float2*>(mg_acc + (wk * ROWS + r_lo) * D + d) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(mg_acc + (wk * ROWS + r_hi) * D + d) =
          make_float2(acc[n][2], acc[n][3]);
    }
    __syncthreads();
    const bool whole = nseg == 1;
    for (int idx = tid; idx < ng * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < C::NWK; ++w) M = fmaxf(M, mg_m[w * ROWS + r]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < C::NWK; ++w) {
        const float mw = mg_m[w * ROWS + r];
        const float wt = mw > 0.5f * NEG_INF ? __expf(mw - M) : 0.f;
        L = fmaf(mg_l[w * ROWS + r], wt, L);
        A = fmaf(mg_acc[(w * ROWS + r) * D + d], wt, A);
      }
      if (whole) {
        out[(row0 + r) * D + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
      } else {
        const long long pi = (row0 + r) * n_seg_max + s;
        part_acc[pi * D + d] = A;
        if (d == 0) {
          part_m[pi] = M;
          part_l[pi] = L;
        }
      }
    }
    if (!whole) {
      // the block's writes are released by a fence before its ticket; the
      // block that draws the last one merges the run's states in order
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        int* ticket = tickets + static_cast<long long>(b) * HH + hh;
        const int drawn = atomicAdd(ticket, 1);
        sm_last = drawn == nseg - 1;
        if (drawn == nseg - 1) {
          __threadfence();
          *ticket = 0;  // for the next launch; no other block takes this one
        }
      }
      __syncthreads();
      if (sm_last) {
        // the run's m and l, every (row, segment) at once, then each row's
        // weights (a thread a row), then the threads over the rows' 16-byte
        // columns, several segments' loads of a thread's columns in flight
        float* wts = mg_acc + C::NWK * ROWS * D;  // [ROWS][MAX_SEGS]: m, then weights
        float* seg_l = wts + ROWS * MAX_SEGS;     // [ROWS][MAX_SEGS]
        float* sums = seg_l + ROWS * MAX_SEGS;    // [ROWS]
        for (int idx = tid; idx < ng * nseg; idx += THREADS) {
          const int r = idx / nseg, si = idx % nseg;
          const long long pi = (row0 + r) * n_seg_max + si;
          wts[r * MAX_SEGS + si] = __ldcg(part_m + pi);
          seg_l[r * MAX_SEGS + si] = __ldcg(part_l + pi);
        }
        __syncthreads();
        if (tid < ng) {
          float M = NEG_INF, L = 0.f;
          for (int si = 0; si < nseg; ++si) M = fmaxf(M, wts[tid * MAX_SEGS + si]);
          for (int si = 0; si < nseg; ++si) {
            const float mc = wts[tid * MAX_SEGS + si];
            const float wt = mc > 0.5f * NEG_INF ? __expf(mc - M) : 0.f;
            wts[tid * MAX_SEGS + si] = wt;
            L = fmaf(seg_l[tid * MAX_SEGS + si], wt, L);
          }
          sums[tid] = fmaxf(L, 1e-30f);
        }
        __syncthreads();
        constexpr int COLS = D / 4, PER = ROWS * COLS / THREADS;  // float4 columns a thread
        float4 a[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int si = 0; si < nseg; ++si) {
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const int idx = tid + j * THREADS, r = idx / COLS, c4 = idx % COLS;
            if (r < ng) {
              const float wt = wts[r * MAX_SEGS + si];
              const float4 x = __ldcg(reinterpret_cast<const float4*>(
                  part_acc + ((row0 + r) * n_seg_max + si) * D + 4 * c4));
              a[j].x = fmaf(x.x, wt, a[j].x);
              a[j].y = fmaf(x.y, wt, a[j].y);
              a[j].z = fmaf(x.z, wt, a[j].z);
              a[j].w = fmaf(x.w, wt, a[j].w);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int idx = tid + j * THREADS, r = idx / COLS, c4 = idx % COLS;
          if (r < ng) {
            const float L = sums[r];
            __nv_bfloat16* o = out + (row0 + r) * D + 4 * c4;
            reinterpret_cast<uint32_t*>(o)[0] = pack_bf16(a[j].x / L, a[j].y / L);
            reinterpret_cast<uint32_t*>(o)[1] = pack_bf16(a[j].z / L, a[j].w / L);
          }
        }
      }
    }
    __syncthreads();  // the shared memory is the next segment's
  }
}

template <int D>
int smem_bytes(int B) {
  return Cfg<D>::SMEM + (2 * B + 1) * static_cast<int>(sizeof(int));
}

constexpr int MAX_DYN = 226 * 1024;  // dynamic shared memory a launch may ask for (and
                                     // the kernel's few static bytes within 227 KB)

// blocks of decode_mma<D> an SM holds, asked once with SLOT_SLACK bytes of
// slot tables (up to 127 slots), after raising the kernel's dynamic shared
// memory limit; a negative value is the CUDA error of either call
template <int D>
int blocks_per_sm() {
  static const int n = [] {
    cudaError_t err = cudaFuncSetAttribute(
        decode_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN);
    int per = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, decode_mma<D>, Cfg<D>::THREADS,
                                                          Cfg<D>::SMEM + SLOT_SLACK);
    if (err != cudaSuccess) return -static_cast<int>(err);
    return per > 0 ? per : 1;
  }();
  return n;
}

template <int D>
int launch(cudaStream_t st, const void* q, const void* k, const void* v, const int* lengths,
           float* part, int* tickets, void* out, int B, int T, int Hkv, int G, int n_seg_max,
           KV ks, KV vs, float softcap, float scale) {
  const int dyn = smem_bytes<D>(B);
  if (dyn > MAX_DYN || n_seg_max < 1 || n_seg_max > MAX_SEGS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_sm = blocks_per_sm<D>();
  if (per_sm < 0) return -per_sm;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (B * Hkv * G == 0) return 0;
  decode_mma<D><<<per_sm * (sms > 0 ? sms : 1), Cfg<D>::THREADS, dyn, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, part, tickets,
      static_cast<__nv_bfloat16*>(out), B, T, Hkv, G, n_seg_max, ks, vs, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hkv, G, D) bf16 contiguous; k, v (B, T, Hkv, D) bf16 with element
// strides (batch, time, head), a contiguous last axis, 16-byte aligned bases
// and strides that are multiples of 8; lengths (B,) int32; part: fp32
// scratch of B * Hkv * G * n_seg_max * (D + 2) values, n_seg_max in [1, 32]
// (no run is cut into more segments); tickets: B * Hkv * ceil(G / 16) ints,
// 0 before the launch and 0 again after it; out (B, Hkv, G, D) bf16
// contiguous. D in {32, 64, 128, 256}. Returns -1 for another D, else
// cudaGetLastError().
extern "C" int decode_attention_mma_fwd(const void* q, const void* k, const void* v,
                                        const void* lengths, void* part, void* tickets,
                                        void* out, int B, int T, int Hkv, int G, int D,
                                        int n_seg_max, long long ksb, long long kst,
                                        long long ksh, long long vsb, long long vst,
                                        long long vsh, float softcap, float scale,
                                        void* stream) {
  const KV ks{ksb, kst, ksh}, vs{vsb, vst, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* p = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  switch (D) {
    case 32:
      return launch<32>(st, q, k, v, lens, p, tk, out, B, T, Hkv, G, n_seg_max, ks, vs, softcap,
                        scale);
    case 64:
      return launch<64>(st, q, k, v, lens, p, tk, out, B, T, Hkv, G, n_seg_max, ks, vs, softcap,
                        scale);
    case 128:
      return launch<128>(st, q, k, v, lens, p, tk, out, B, T, Hkv, G, n_seg_max, ks, vs,
                         softcap, scale);
    case 256:
      return launch<256>(st, q, k, v, lens, p, tk, out, B, T, Hkv, G, n_seg_max, ks, vs,
                         softcap, scale);
    default:
      return -1;
  }
}

// dynamic shared memory of a launch at D with B slots, and the blocks an SM
// holds (the grid is that many times the SMs), for the build report
extern "C" int decode_attention_mma_smem(int D, int B) {
  switch (D) {
    case 32: return smem_bytes<32>(B);
    case 64: return smem_bytes<64>(B);
    case 128: return smem_bytes<128>(B);
    case 256: return smem_bytes<256>(B);
    default: return -1;
  }
}

extern "C" int decode_attention_mma_blocks_per_sm(int D) {
  switch (D) {
    case 32: return blocks_per_sm<32>();
    case 64: return blocks_per_sm<64>();
    case 128: return blocks_per_sm<128>();
    case 256: return blocks_per_sm<256>();
    default: return -1;
  }
}
