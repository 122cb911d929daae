// One-query (decode) attention over a bf16 KV cache for Hopper (sm_90a), the
// live keys cut into equal shares of the card's warps, all in one launch.
//
// Replaces repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// for bf16 tensors at D in {32, 64, 128, 256} whose q, K and V bases and
// strides allow 16-byte loads (decode_attention/kernel.py::chunked_eligible).
// Computes, per (batch b, kv-head h, query head g of the group):
//   s_t = softcap(q_g . k_t / sqrt(D)) for t < lengths[b],
//   o_g = sum_t softmax(s)_t v_t,
// in fp32. Keys at or past lengths[b] are not read.
//
// Bound on an H100: bytes. Each live key and value row is read once and used
// for the G query heads of its kv-head, about 2 operations per byte.
//
// Design. A unit is UK = 2048 / D keys of one (b, kv-head, group of up to 8
// query heads): 8 rows of 16-byte loads per lane, 4 KB of K and 4 KB of V
// for a warp. The work list is every live unit, in (b, head group, unit)
// order: each block reads the lengths on the device once (the host never
// does) into a prefix of units per slot, so a slot at 1024 keys and one at
// 196 take 64 and 13 units at D = 128. The grid is as many blocks of 4 warps
// as fit on the card; each warp takes an equal run of P consecutive units
// (P at least ceil(longest slot / MAX_SEGS)), so whatever the lengths, no
// warp has more than P units. A warp keeps one softmax state (m, l, acc) per
// query head across the units of a (b, head group) run, with no barrier: it
// issues the next unit's 16 loads as soon as the current one's are used.
// Where its range ends a run, the warp writes the output if it held the
// whole run; else it writes its partial state to a scratch sized from T
// (segment = the warp's place among the run's warps) and takes a ticket from
// a per-(b, head group) counter (a fence before it releases the writes); the
// warp that draws the last ticket merges the run's partials in segment order
// (the same sums in the same order on every run of the kernel: the grid is
// fixed for a card), writes the output and resets the counter to 0 for the
// next launch. A slot at length 0 writes zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4, THREADS = WARPS * 32;
constexpr int PASSES = 8;  // 16-byte loads of K (and of V) per lane per unit
constexpr int MAX_SEGS = 32;  // warps a run is cut among, at most (one more at its ends)

struct KV {
  long long b, t, h;  // element strides of k and v (B, T, Hkv, D); D contiguous
};

template <int D>
struct Shape {
  static constexpr int LPR = D / 8;     // lanes per key row, 8 bf16 each
  static constexpr int RPW = 32 / LPR;  // rows per warp per pass
  static constexpr int UK = RPW * PASSES;  // keys per unit: 8 KB of K and V
};

// units of a slot: at least 1, so that a slot at length 0 writes zeros
__device__ __forceinline__ int slot_units(int len, int UK) {
  return len > UK ? (len + UK - 1) / UK : 1;
}

__device__ __forceinline__ float lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// the 8 bf16 values of a 16-byte load, as fp32
__device__ __forceinline__ void widen8(const uint4& r, float (&f)[8]) {
  f[0] = lo(r.x), f[1] = hi(r.x), f[2] = lo(r.y), f[3] = hi(r.y);
  f[4] = lo(r.z), f[5] = hi(r.z), f[6] = lo(r.w), f[7] = hi(r.w);
}

// a unit's place: slot b, head group hh (kv-head hk, query heads g0 ..
// g0 + ng), unit c of the slot's n, the slot's length, and the first unit
// of its (b, hh) run in the work list
struct Unit {
  int b, hh, c, n, len, first;
};

// The work list is every (b, hh, unit) in that order; worker w (a warp)
// takes units [w P, (w + 1) P), P = ceil(U / workers). sm_first[b] = the
// first unit of slot b (B + 1 entries, in units of one head group).
__device__ __forceinline__ Unit unit_of(int u, const int* sm_first, const int* sm_len, int B,
                                        int HH, int UK) {
  int lo_b = 0, hi_b = B - 1;
  while (lo_b < hi_b) {  // the last slot whose first unit is <= u
    const int mid = (lo_b + hi_b + 1) / 2;
    if (sm_first[mid] * HH <= u) lo_b = mid;
    else hi_b = mid - 1;
  }
  Unit x;
  x.b = lo_b;
  x.len = sm_len[lo_b];
  x.n = slot_units(x.len, UK);
  const int j = u - sm_first[lo_b] * HH;
  x.hh = j / x.n;
  x.c = j % x.n;
  x.first = u - x.c;
  return x;
}

// the unit after x in the work list
__device__ __forceinline__ Unit next_unit(Unit x, int u, const int* sm_first, const int* sm_len,
                                          int B, int HH, int UK) {
  if (x.c + 1 < x.n) {
    ++x.c;
    return x;
  }
  if (x.hh + 1 < HH) {
    ++x.hh;
    x.c = 0;
    x.first = u + 1;
    return x;
  }
  return unit_of(u + 1, sm_first, sm_len, B, HH, UK);
}

// q (B, Hkv, G, D), out the same, contiguous; part: fp32 m, l (rows *
// n_seg_max each) then acc (rows * n_seg_max * D), rows = B * Hkv * G;
// tickets: one int per (b, kv-head, group of GC heads), 0 between launches.
// Dynamic shared memory: 2 B + 1 ints.
template <int D, int GC>
__global__ void __launch_bounds__(THREADS, GC == 1 ? 4 : GC == 2 ? 3 : 2)
decode_chunked(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
             float* __restrict__ part, int* __restrict__ tickets,
             __nv_bfloat16* __restrict__ out, int B, int T, int Hkv, int G, int n_seg_max,
             KV ks, KV vs, float softcap, float scale) {
  using S = Shape<D>;
  extern __shared__ int sm_slots[];  // [B + 1] first units, then [B] lengths
  int* sm_first = sm_slots;
  int* sm_len = sm_slots + B + 1;
  __shared__ int sm_longest;
  const int HC = (G + GC - 1) / GC, HH = Hkv * HC;  // head groups per slot
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = (lane % S::LPR) * 8;   // this lane's 8 dimensions
  const int rl = lane / S::LPR;         // its row within a pass
  const long long rows = static_cast<long long>(B) * Hkv * G;
  float* part_m = part;
  float* part_l = part + rows * n_seg_max;
  float* part_acc = part + 2 * rows * n_seg_max;

  // the slots' lengths (clamped to [0, T]) and unit counts, read once, in
  // parallel; a prefix sum gives each slot's first unit
  for (int b = threadIdx.x; b < B; b += THREADS) {
    const int len = min(max(__ldg(lengths + b), 0), T);
    sm_len[b] = len;
    sm_first[b + 1] = slot_units(len, S::UK);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int longest = 1;
    sm_first[0] = 0;
    for (int b = 0; b < B; ++b) {
      longest = max(longest, sm_first[b + 1]);
      sm_first[b + 1] += sm_first[b];
    }
    sm_longest = longest;
  }
  __syncthreads();
  // P units a warp: an equal share, but no run cut among more than
  // MAX_SEGS + 1 warps, whose partials the last of them merges
  const int U = sm_first[B] * HH, workers = gridDim.x * WARPS;
  const int P = max((U + workers - 1) / workers, (sm_longest + MAX_SEGS - 1) / MAX_SEGS);
  const int w = blockIdx.x * WARPS + warp;
  const int u0 = w * P, u1 = min(U, u0 + P);
  if (u0 >= u1) return;

  uint4 qr[GC], kr[PASSES], vr[PASSES];
  auto load_q = [&](const Unit& x, uint4(&dst)[GC]) {
    const int hk = x.hh / HC, g0 = (x.hh % HC) * GC, ng = min(GC, G - g0);
    const __nv_bfloat16* qb = q + ((static_cast<long long>(x.b) * Hkv + hk) * G + g0) * D + d0;
#pragma unroll
    for (int g = 0; g < GC; ++g)
      dst[g] = g < ng ? __ldg(reinterpret_cast<const uint4*>(qb + g * D))
                      : make_uint4(0u, 0u, 0u, 0u);
  };
  // the unit's K and V rows, all 16 loads in flight at once
  auto load_kv = [&](const Unit& x) {
    const int hk = x.hh / HC;
    const __nv_bfloat16* kb = k + x.b * ks.b + hk * ks.h + d0;
    const __nv_bfloat16* vb = v + x.b * vs.b + hk * vs.h + d0;
    const int t0 = x.c * S::UK + rl;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int t = t0 + p * S::RPW;
      if (t < x.len) {
        kr[p] = __ldcs(reinterpret_cast<const uint4*>(kb + t * ks.t));
        vr[p] = __ldcs(reinterpret_cast<const uint4*>(vb + t * vs.t));
      } else {
        kr[p] = vr[p] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  Unit x = unit_of(u0, sm_first, sm_len, B, HH, S::UK);
  load_q(x, qr);
  load_kv(x);
  // the warp's running softmax state over its units of the current (b, hh):
  // m is the same on every lane; l and acc are this lane's rows' share
  float m[GC], l[GC], acc[GC][8];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  for (int u = u0; u < u1; ++u) {
    const int g0 = (x.hh % HC) * GC, ng = min(GC, G - g0), t0 = x.c * S::UK + rl;
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < ng) {
        float qf[8];
        widen8(qr[g], qf);
        // scores of this lane's rows: a share of the dot, summed over the
        // row's lanes (independent shuffle chains)
        float s[PASSES];
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          float kf[8];
          widen8(kr[p], kf);
          s[p] = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s[p] = fmaf(qf[e], kf[e], s[p]);
        }
#pragma unroll
        for (int off = S::LPR / 2; off > 0; off >>= 1)
#pragma unroll
          for (int p = 0; p < PASSES; ++p) s[p] += __shfl_xor_sync(0xffffffffu, s[p], off);
        float mx = m[g];
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          float sc = s[p] * scale;
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          s[p] = t0 + p * S::RPW < x.len ? sc : NEG_INF;
          mx = fmaxf(mx, s[p]);
        }
#pragma unroll
        for (int off = S::LPR; off < 32; off <<= 1)  // over the warp's row groups
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float corr = m[g] > 0.5f * NEG_INF ? __expf(m[g] - mx) : 0.f;
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          const float pr = s[p] > 0.5f * NEG_INF ? __expf(s[p] - mx) : 0.f;
          float vf[8];
          widen8(vr[p], vf);
          l[g] += pr;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
        }
        m[g] = mx;
      }
    }

    // the next unit's loads go out as soon as this one's are used
    const Unit cur = x;
    const bool more = u + 1 < u1;
    if (more) {
      x = next_unit(cur, u, sm_first, sm_len, B, HH, S::UK);
      if (x.first != cur.first) load_q(x, qr);  // this unit's q is used
      load_kv(x);
    }
    if (more && x.first == cur.first) continue;

    // the warp's run of (b, hh) ends here: its state summed over the row
    // groups, then written out, or written as a partial when other warps
    // hold the rest of the run
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int off = S::LPR; off < 32; off <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      }
    const int hk = cur.hh / HC, cg0 = (cur.hh % HC) * GC, cng = min(GC, G - cg0);
    const long long row0 = (static_cast<long long>(cur.b) * Hkv + hk) * G + cg0;
    const int w_first = cur.first / P, w_last = (cur.first + cur.n - 1) / P;
    if (w_first == w_last) {  // the whole run is this warp's
      if (lane < S::LPR) {
#pragma unroll
        for (int g = 0; g < GC; ++g)
          if (g < cng)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              out[(row0 + g) * D + d0 + e] = __float2bfloat16(acc[g][e] / fmaxf(l[g], 1e-30f));
      }
    } else {
      const int seg = w - w_first, nseg = w_last - w_first + 1;
      if (lane < S::LPR) {
#pragma unroll
        for (int g = 0; g < GC; ++g)
          if (g < cng) {
            const long long pi = (row0 + g) * n_seg_max + seg;
#pragma unroll
            for (int e = 0; e < 8; ++e) part_acc[pi * D + d0 + e] = acc[g][e];
            if (lane == 0) {
              part_m[pi] = m[g];
              part_l[pi] = l[g];
            }
          }
      }
      // the warp's writes are released by a fence before its ticket; the
      // warp that draws the last one merges the run's partials in order
      int* ticket = tickets + static_cast<long long>(cur.b) * HH + cur.hh;
      int drawn = 0;
      __syncwarp();
      if (lane == 0) {
        __threadfence();
        drawn = atomicAdd(ticket, 1);
        if (drawn == nseg - 1) {
          __threadfence();
          *ticket = 0;  // for the next launch; no other warp takes this one
        }
      }
      drawn = __shfl_sync(0xffffffffu, drawn, 0);
      __syncwarp();  // the lanes' reads below come after lane 0's acquire
      if (drawn == nseg - 1) {
        // lanes over the segments for the maximum and the sum of weights,
        // then over the dimensions, the segments' loads independent
#pragma unroll 1
        for (int g = 0; g < cng; ++g) {
          const long long p0 = (row0 + g) * n_seg_max;
          float mm = NEG_INF, ll = 0.f;
          for (int si = lane; si < nseg; si += 32) mm = fmaxf(mm, __ldcg(part_m + p0 + si));
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
          for (int si = lane; si < nseg; si += 32) {
            const float mc = __ldcg(part_m + p0 + si);
            if (mc > 0.5f * NEG_INF) ll = fmaf(__ldcg(part_l + p0 + si), __expf(mc - mm), ll);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) ll += __shfl_xor_sync(0xffffffffu, ll, off);
          float aa[D / 32];
#pragma unroll
          for (int j = 0; j < D / 32; ++j) aa[j] = 0.f;
#pragma unroll 8
          for (int si = 0; si < nseg; ++si) {
            const float mc = __ldcg(part_m + p0 + si);
            const float wt = mc > 0.5f * NEG_INF ? __expf(mc - mm) : 0.f;
#pragma unroll
            for (int j = 0; j < D / 32; ++j)
              aa[j] = fmaf(wt, __ldcg(part_acc + (p0 + si) * D + lane + 32 * j), aa[j]);
          }
#pragma unroll
          for (int j = 0; j < D / 32; ++j)
            out[(row0 + g) * D + lane + 32 * j] = __float2bfloat16(aa[j] / fmaxf(ll, 1e-30f));
        }
      }
    }
    if (!more) break;
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }
  }
}

template <int D, int GC>
int launch(cudaStream_t st, const void* q, const void* k, const void* v, const int* lengths,
           float* part, int* tickets, void* out, int B, int T, int Hkv, int G, int n_seg_max,
           KV ks, KV vs, float softcap, float scale) {
  auto kernel = decode_chunked<D, GC>;
  const int dyn = (2 * B + 1) * static_cast<int>(sizeof(int));
  if (dyn > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  // blocks per SM, set by the registers (the few bytes of dynamic shared
  // memory do not bind): asked once, not on every decode step
  static const int per_sm = [&] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, dyn);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = per_sm * (sms > 0 ? sms : 1);
  if (B * Hkv * G == 0) return 0;
  kernel<<<grid, THREADS, dyn, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, part, tickets,
      static_cast<__nv_bfloat16*>(out), B, T, Hkv, G, n_seg_max, ks, vs, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// query heads per item: the whole group up to 8, else groups of 8
template <int D>
int launch_g(int G, cudaStream_t st, const void* q, const void* k, const void* v,
             const int* lengths, float* part, int* tickets, void* out, int B, int T, int Hkv,
             int n_seg_max, KV ks, KV vs, float softcap, float scale) {
  if (G == 1)
    return launch<D, 1>(st, q, k, v, lengths, part, tickets, out, B, T, Hkv, G, n_seg_max, ks,
                        vs, softcap, scale);
  if (G == 2)
    return launch<D, 2>(st, q, k, v, lengths, part, tickets, out, B, T, Hkv, G, n_seg_max, ks,
                        vs, softcap, scale);
  if (G <= 4)
    return launch<D, 4>(st, q, k, v, lengths, part, tickets, out, B, T, Hkv, G, n_seg_max, ks,
                        vs, softcap, scale);
  return launch<D, 8>(st, q, k, v, lengths, part, tickets, out, B, T, Hkv, G, n_seg_max, ks,
                      vs, softcap, scale);
}

}  // namespace

// q (B, Hkv, G, D) bf16 contiguous; k, v (B, T, Hkv, D) bf16 with element
// strides (batch, time, head), a contiguous last axis, 16-byte aligned bases
// and strides that are multiples of 8; lengths (B,) int32; part: fp32
// scratch of B * Hkv * G * n_seg_max * (D + 2) values, n_seg_max =
// ceil(T / UK) at least 1, UK = 2048 / D keys; tickets: B * Hkv * G ints, 0
// before the launch and 0 again after it; out (B, Hkv, G, D) bf16
// contiguous. D in {32, 64, 128, 256}. Returns -1 for another D, else
// cudaGetLastError().
extern "C" int decode_attention_chunked_fwd(const void* q, const void* k, const void* v,
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
      return launch_g<32>(G, st, q, k, v, lens, p, tk, out, B, T, Hkv, n_seg_max, ks, vs,
                          softcap, scale);
    case 64:
      return launch_g<64>(G, st, q, k, v, lens, p, tk, out, B, T, Hkv, n_seg_max, ks, vs,
                          softcap, scale);
    case 128:
      return launch_g<128>(G, st, q, k, v, lens, p, tk, out, B, T, Hkv, n_seg_max, ks, vs,
                           softcap, scale);
    case 256:
      return launch_g<256>(G, st, q, k, v, lens, p, tk, out, B, T, Hkv, n_seg_max, ks, vs,
                           softcap, scale);
    default:
      return -1;
  }
}
