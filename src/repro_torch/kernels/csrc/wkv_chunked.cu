// RWKV6 WKV recurrence in the chunked-parallel form, for Hopper (sm_90a).
//
// Replaces repro/kernels/wkv/kernel.py::wkv_pallas for every call with
// T > 1 (prefill); the decode step (T = 1) stays on csrc/wkv.cu. It computes
// what wkv.cu computes, with the same contract: per (batch b, head h), an
// N x N fp32 state S (row i: key channel, column j: value channel), for
// t < lengths[b]
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = S[i][j] * w_t[i] + k_t[i] * v_t[j]
// and steps at or past lengths[b] leave S as it is and output zero.
//
// Bound on an H100 at the served prefill: bytes (20 N bytes of r, k, v, w
// and out a step against 5 N^2 + 2 N fp32 operations, 16 per byte at N = 64,
// below the 20 at which 67 TFLOP/s and 3.35 TB/s meet), plus the state read
// and written once. What held wkv.cu far from it is not bytes but a serial
// chain at low occupancy: one block of N threads per (h, b), every step in
// turn, 64 blocks of 2 warps for a batch-1 refill on 132 SMs.
//
// The chunked-parallel form. Chunks of L = 16 steps; with a_t[i] the sum of
// log w over the chunk's steps up to t (a_{-1} = 0):
//   out_t = (r_t e^{a_{t-1}}) S + sum_{s<t} A[t][s] v_s + (r_t . u k_t) v_t
//   A[t][s] = sum_i r_t[i] k_s[i] e^{a_{t-1}[i] - a_s[i]}
//   S <- e^{a_L} (rows) S + (k e^{a_L - a})^T V
// One serial dependence a chunk, through S; everything else of a chunk
// depends on r, k, w alone. All in fp32 on the CUDA cores (TF32 keeps 10
// mantissa bits and cannot meet the 1e-4 gate).
//
// Design.
//  * The state is spread over blocks: column j of S evolves on its own given
//    r, k and w, so the grid is (H, B, N / NC), each block an N x NC slice of
//    S, read from state0 once and written once; no per-chunk state reaches
//    device memory. The wrapper picks NC so that the busiest SM has the
//    least work: the 8-slot wave of 64 heads of 64 runs 512 blocks of 64
//    columns, a batch-1 refill 128 blocks of 32 (one an SM), since a narrower
//    slice repeats the chunk's decays and scores for fewer columns.
//  * Four warpgroups (512 threads), in a pipeline over chunks. Warpgroups
//    0-1 prepare chunk c + 1 while warpgroups 2-3 finish chunk c: the log
//    decays, the factors RQ = r e^{a_{t-1}}, KD = k e^{a_L - a}, e^{a_L},
//    and the scores A (a 4 x 4 tile of (t, s) over 4 channels a thread, the
//    16 threads of a tile summed by a butterfly of shuffles). The factors
//    pass through a double buffer between full and empty named barriers.
//    Warpgroup 2 takes the outputs as 4 x 4 register tiles (steps x
//    columns) in parts: each part RQ S over a share of S's rows (read from
//    a copy of S in shared memory) and A V over a share of the steps;
//    warpgroup 3 the state update KD^T V on its own 4-column register tiles
//    of S, kept for the whole sequence. Then the parts are summed and stored
//    16 bytes at a time.
//  * r, k and w are copied a chunk ahead by the preparing warps, v by the
//    others, with cp.async (16 bytes a copy, zero-filled past lengths[b])
//    into double buffers.
//  * What bounds it: instruction issue and latency, not bytes or the fp32
//    rate. A chunk's preparation and its products are about even in
//    instructions, hence the pipeline; the decays and scores cost a block
//    the same whatever its columns, hence the wide slices. Every butterfly
//    has its levels unrolled by template: an array indexed inside a loop
//    the compiler did not unroll goes to local memory.

// Numerics. No division; every factor is 2^x of a direct sum of log2 decays:
//  * log2 w: for w > 15/16 by log1p's series on 1 - w (exact in fp32), to
//    a few ulps of a small result; else by the hardware's lg2, whose
//    absolute error of ~2^-22 is under 3e-6 of |log2 w| >= 0.093 there.
//    Clamped below at -60 log2(e), so w = 0 gives no -inf - (-inf): e^-60 =
//    8.8e-27 against 0 is invisible in fp32 beside the k v^T added in the
//    same step (1 ulp of 1 is 1.2e-7).
//  * a_{t-1} and a_L - a_s are prefix and suffix sums of the chunk's log
//    decays, never differences of two large sums (whose rounding, at |a| up
//    to 960, would reach 6e-5 of a term).
//  * The scores are factored as (r_t e^{a_{t-1}}) . (k_s e^{-a_s}) only
//    where the (b, h)'s chunk total -a_L stays at or below 60 in every
//    channel: then e^{-a_s} <= 1.1e26 and e^{a_{t-1}} >= 8.8e-27 stay normal
//    fp32 for any |r|, |k| of 1e-12 to 1e12. Otherwise the chunk takes the
//    elementwise form, e^{gap} with the gap summed over s < m < t from
//    m = t - 1 down (kernels/wkv/ref.py::wkv_chunked_ref is this
//    arithmetic in PyTorch).
//  * Pad steps (at or past lengths[b], or past T in the last chunk) are
//    identity steps: r, k, v zero-filled, log w taken as 0.
// Inputs with w in [0, 1] (the model's exp(-exp(x))) are the contract.
//
// Decode in place: state_out may be state0. A block reads its own slice of
// state0 before its first step and writes the same slice of state_out after
// its last; slices of different blocks are disjoint.
//
// Training: given s_seg (B, H, ceil(T / (16 seg_chunks)), N, N), the state
// warpgroup also writes its slice of the state at the start of every
// segment of seg_chunks chunks, from the registers it keeps anyway: the
// states csrc/wkv_bwd.cu rebuilds each chunk's from. Serving passes none
// (one untaken branch a chunk).

#include <cuda_runtime.h>

namespace {

constexpr int L = 16;               // steps a chunk
constexpr int WG = 128;             // threads a warpgroup
constexpr int PREP = 2 * WG;        // warpgroups 0-1 prepare
constexpr int THREADS = PREP + 2 * WG;  // then inter-chunk outputs, state
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LOG2_W_MIN = -60.f * LOG2E;    // log w >= -60
constexpr float FACTOR_LIMIT2 = 60.f * LOG2E;  // factored where -a_L <= 60
// named barriers (0 is __syncthreads)
constexpr int BAR_PREP = 1, BAR_FULL = 2, BAR_EMPTY = 4, BAR_COMP = 6;

struct Strides {
  long long b, t, h;  // element strides of a (B, T, H, N) input; N contiguous
};

template <int N, int NC>
struct Layout {
  static constexpr int P = N + 4;                    // a row along N, padded: 16 B
  static constexpr int LP = L + 4;                   // a row along t, padded
  static constexpr int PC = NC + 4;                  // a row of the slice's columns, padded
  static constexpr int KS = WG / NC;                 // parts the outputs are summed in
  static constexpr int RKW = 3 * L * N;              // r, k, w (then log2 w), [L][N] each
  static constexpr int STG = 0;                      // [2][RKW]
  static constexpr int VS = 2 * RKW;                 // [2][L][NC] v
  static constexpr int KQT = VS + 2 * L * NC;        // [N][LP] k e^{-a_t}, transposed
  static constexpr int RKT = KQT + N * LP;           // [N][LP] r u k, transposed
  static constexpr int TOT = RKT + N * LP;           // [PREP / N][N]
  // double-buffered, from the preparing warps to the others
  static constexpr int RQT = TOT + PREP;             // [N][LP] RQ transposed
  static constexpr int KD = RQT + N * LP;            // [L][P] k e^{a_L - a_t}
  static constexpr int DECAY = KD + L * P;           // [N] e^{a_L}
  static constexpr int AS = DECAY + N;               // [L][LP] the scores, transposed: [s][t]
  static constexpr int BUF = AS + L * LP - RQT;      // one buffer
  static constexpr int SM = RQT + 2 * BUF;           // [N][PC] the slice of S at the chunk's start
  static constexpr int OP = SM + N * PC;             // [KS][L][PC] partial inter-chunk outputs
  static constexpr int FLOATS = OP + KS * L * PC;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// bar.sync that returns whether `pred` holds in any participating thread
__device__ __forceinline__ bool bar_or(int id, int count, bool pred) {
  unsigned any;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 q, %1, 0;\n"
      " bar.red.or.pred p, %2, %3, q;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(any)
      : "r"(static_cast<unsigned>(pred)), "r"(id), "r"(count)
      : "memory");
  return any != 0;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// log2 w for w in [0, 1]: above 15/16 by log1p(-d) = -d (1 + d/2 + ... +
// d^6/7) with d = 1 - w exact, whose last term is under 2^-25 of the sum;
// else by the hardware's lg2 (absolute error ~2^-22, |log2 w| >= 0.093)
__device__ __forceinline__ float log2_decay(float w) {
  const float d = 1.f - w;
  float p = fmaf(d, 1.f / 7.f, 1.f / 6.f);
  p = fmaf(d, p, 1.f / 5.f);
  p = fmaf(d, p, 1.f / 4.f);
  p = fmaf(d, p, 1.f / 3.f);
  p = fmaf(d, p, 1.f / 2.f);
  p = fmaf(d, p, 1.f);
  return d < 0.0625f ? -d * p * LOG2E : __log2f(w);
}

// One level of a butterfly over lanes OFF apart: each lane keeps half of
// its 2 HALF values (the upper half where its lane bit OFF is set), summed
// with its partner's.
template <int HALF, int OFF>
__device__ __forceinline__ void butterfly_level(float (&a)[16], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int q = 0; q < HALF; ++q) {
    const float lo = a[q], hi = a[q + HALF];
    a[q] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, OFF);
  }
}

// The sum of 16 values over KP neighbouring lanes (a power of 2 up to 16),
// scattered: lane g of the KP keeps the sums of values g 16 / KP .. (g + 1)
// 16 / KP - 1 in a[0 .. 16 / KP - 1].
template <int KP>
__device__ __forceinline__ void reduce_scatter16(float (&a)[16], int g) {
  static_assert(KP == 2 || KP == 4 || KP == 8 || KP == 16, "lanes a group");
  butterfly_level<8, KP / 2>(a, g);
  if constexpr (KP >= 4) butterfly_level<4, KP / 4>(a, g);
  if constexpr (KP >= 8) butterfly_level<2, KP / 8>(a, g);
  if constexpr (KP >= 16) butterfly_level<1, KP / 16>(a, g);
}

// One thread's share of a chunk's rows of an input: 16-byte pieces idx,
// idx + NT, ... of a (L, W) tile, row idx / (W / 4), for the NT threads
// numbered `me`.
template <int W, int NT>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, long long st, int chunk,
                                          int len, int me) {
  constexpr int PIECES = L * W / 4;
#pragma unroll
  for (int idx0 = 0; idx0 < PIECES; idx0 += NT) {
    const int idx = idx0 + me;
    if (PIECES % NT != 0 && idx >= PIECES) break;
    const int row = idx / (W / 4), c4 = idx % (W / 4), tg = chunk * L + row;
    cp_async16(dst + row * W + 4 * c4, src + (tg < len ? tg : 0) * st + 4 * c4, tg < len);
  }
}

// Warpgroups 0-1: for each chunk, the log decays, the factors into buffer
// chunk & 1 and the scores; r, k, w copied one chunk ahead.
template <int N, int NC>
__device__ __forceinline__ void prepare(float* smem, int n_chunks, int len, const float* rb,
                                        const float* kb, const float* wb, Strides sr,
                                        Strides sk, Strides sw, float ui) {
  using Ly = Layout<N, NC>;
  constexpr int P = Ly::P, LP = Ly::LP;
  constexpr int QS = PREP / N;  // step groups
  constexpr int SPT = L / QS;   // steps a thread
  static_assert(SPT % 2 == 0 && PREP == L * L, "a thread's steps fill 8-byte stores; "
                "one score a thread");
  const int me = threadIdx.x, ci = me % N, cq = me / N;
  float* const kqt = smem + Ly::KQT;
  float* const rkt = smem + Ly::RKT;
  float* const tot = smem + Ly::TOT;
  auto issue = [=](int chunk) {
    float* stage = smem + Ly::STG + (chunk & 1) * Ly::RKW;
    copy_rows<N, PREP>(stage, rb, sr.t, chunk, len, me);
    copy_rows<N, PREP>(stage + L * N, kb, sk.t, chunk, len, me);
    copy_rows<N, PREP>(stage + 2 * L * N, wb, sw.t, chunk, len, me);
    cp_async_commit();
  };
  issue(0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    float* const buf = smem + Ly::RQT + (chunk & 1) * Ly::BUF;
    float* const rqt = buf;
    float* const kd = buf + (Ly::KD - Ly::RQT);
    float* const decay = buf + (Ly::DECAY - Ly::RQT);
    float* const at = buf + (Ly::AS - Ly::RQT);
    const float* sr_ = smem + Ly::STG + (chunk & 1) * Ly::RKW;
    const float* sk_ = sr_ + L * N;
    float* slw = const_cast<float*>(sr_) + 2 * L * N;  // w, then log2 w in place
    if (chunk >= 2) bar_sync(BAR_EMPTY + (chunk & 1), THREADS);  // chunk - 2 consumed
    cp_async_wait_all();
    bar_sync(BAR_PREP, PREP);  // this chunk landed; the previous one is prepared
    if (chunk + 1 < n_chunks) issue(chunk + 1);

    // 1. log2 decays and their sums per step group (all loads first: the
    //    steps are independent)
    float lw[SPT];
#pragma unroll
    for (int m = 0; m < SPT; ++m) lw[m] = slw[(cq * SPT + m) * N + ci];
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < SPT; ++m) {
      const float x = fmaxf(log2_decay(lw[m]), LOG2_W_MIN);
      lw[m] = chunk * L + cq * SPT + m < len ? x : 0.f;
      sum += lw[m];
    }
#pragma unroll
    for (int m = 0; m < SPT; ++m) slw[(cq * SPT + m) * N + ci] = lw[m];
    tot[cq * N + ci] = sum;
    bar_sync(BAR_PREP, PREP);

    // 2. RQ = r e^{a_{t-1}}, KQ = k e^{-a_t}, KD = k e^{a_L - a_t}, r u k
    float pre = 0.f, post = 0.f, total = 0.f;
#pragma unroll
    for (int q = 0; q < QS; ++q) {
      const float x = tot[q * N + ci];
      total += x;
      if (q < cq) pre += x;
      if (q > cq) post += x;
    }
    const bool factored = -total <= FACTOR_LIMIT2;
    const float e_last = exp2f(total);
    float after[SPT];
    {
      float run = post;
#pragma unroll
      for (int m = SPT - 1; m >= 0; --m) {
        after[m] = run;
        run += lw[m];
      }
    }
    {
      float rt[SPT], kt[SPT], a[SPT + 1], x[SPT], y[SPT], z[SPT];
#pragma unroll
      for (int m = 0; m < SPT; ++m) {
        rt[m] = sr_[(cq * SPT + m) * N + ci];
        kt[m] = sk_[(cq * SPT + m) * N + ci];
      }
      a[0] = pre;
#pragma unroll
      for (int m = 0; m < SPT; ++m) a[m + 1] = a[m] + lw[m];
#pragma unroll
      for (int m = 0; m < SPT; ++m) {
        const int t = cq * SPT + m;
        x[m] = rt[m] * exp2f(a[m]);
        y[m] = factored ? kt[m] * exp2f(-a[m + 1]) : 0.f;
        z[m] = rt[m] * ui * kt[m];
        kd[t * P + ci] = factored ? y[m] * e_last : kt[m] * exp2f(after[m]);
      }
      const int at0 = ci * LP + cq * SPT;
#pragma unroll
      for (int m = 0; m < SPT; m += 2) {
        *reinterpret_cast<float2*>(&rqt[at0 + m]) = make_float2(x[m], x[m + 1]);
        *reinterpret_cast<float2*>(&kqt[at0 + m]) = make_float2(y[m], y[m + 1]);
        *reinterpret_cast<float2*>(&rkt[at0 + m]) = make_float2(z[m], z[m + 1]);
      }
    }
    if (cq == 0) decay[ci] = e_last;
    const bool all_factored = !bar_or(BAR_PREP, PREP, !factored);

    // 3. the scores, stored transposed (at[s][t]). Factored: a 4 x 4 tile of
    //    (t, s) over 4 of the N channels a thread (kp, kp + KP, ...), the KP
    //    threads of a tile summed by a butterfly that leaves each 16 / KP of
    //    its entries; on a diagonal tile the diagonal takes sum_i r u k
    //    instead. Elementwise: one (t, s) a thread.
    if (all_factored) {
      constexpr int KP = N / 4, NE = 16 / KP;
      const int kp = me % KP, tile = me / KP, t0 = 4 * (tile / 4), s0 = 4 * (tile % 4);
      if (me < 16 * KP) {
        float a[16] = {};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float4 x4 = ld4(rqt + (kp + KP * ii) * LP + t0),
                       y4 = ld4(kqt + (kp + KP * ii) * LP + s0);
          const float xs[4] = {x4.x, x4.y, x4.z, x4.w}, ys[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) a[4 * q + c] = fmaf(xs[q], ys[c], a[4 * q + c]);
        }
        if (t0 == s0) {
          float4 d = ld4(rkt + kp * LP + t0);
#pragma unroll
          for (int ii = 1; ii < 4; ++ii) {
            const float4 e = ld4(rkt + (kp + KP * ii) * LP + t0);
            d.x += e.x, d.y += e.y, d.z += e.z, d.w += e.w;
          }
          a[0] = d.x, a[5] = d.y, a[10] = d.z, a[15] = d.w;
        }
        reduce_scatter16<KP>(a, kp);
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int t = t0 + (kp * NE + e) / 4, s2 = s0 + (kp * NE + e) % 4;
          at[s2 * LP + t] = s2 <= t ? a[e] : 0.f;
        }
      }
    } else {
      const int t = me >> 4, s2 = me & 15;
      float a = 0.f;
      if (s2 == t) {
        for (int i = 0; i < N; ++i) a += rkt[i * LP + t];
      } else if (s2 < t) {
        for (int i = 0; i < N; ++i) {
          float gap = 0.f;
          for (int m = t - 1; m > s2; --m) gap += slw[m * N + i];
          a = fmaf(sr_[t * N + i] * sk_[s2 * N + i], exp2f(gap), a);
        }
      }
      at[s2 * LP + t] = s2 <= t ? a : 0.f;
    }
    bar_arrive(BAR_FULL + (chunk & 1), THREADS);  // buffer chunk & 1 is full
  }
}

template <int N, int NC>
__global__ void __launch_bounds__(THREADS, 1)
wkv_chunked_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* state0,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   float* state_out, float* __restrict__ s_seg, int seg_chunks, int T, int H,
                   Strides sr, Strides sk, Strides sv, Strides sw) {
  using Ly = Layout<N, NC>;
  constexpr int P = Ly::P, LP = Ly::LP, PC = Ly::PC, KS = Ly::KS;
  constexpr int JT = NC / 4;        // 4-column tiles of the slice
  constexpr int KR = N / KS;        // rows of S in a part of the inter-chunk sums
  constexpr int TI = N * NC / 512;  // rows of a state tile (TI x 4, one a thread)
  static_assert(L == 16 && KS >= 1 && L % KS == 0 && TI >= 1 && (TI == 1 || TI == 2 || TI % 4 == 0),
                "tile shapes");
  extern __shared__ __align__(16) float smem[];

  const int h = blockIdx.x, b = blockIdx.y, col0 = blockIdx.z * NC, tid = threadIdx.x;
  const int len = lengths != nullptr ? min(max(lengths[b], 0), T) : T;
  const long long sbase = ((long long)b * H + h) * N * N;
  const int n_chunks = (len + L - 1) / L;

  if (tid < PREP) {
    if (n_chunks > 0)
      prepare<N, NC>(smem, n_chunks, len, r + b * sr.b + h * sr.h, k + b * sk.b + h * sk.h,
                     w + b * sw.b + h * sw.h, sr, sk, sw, u[(long long)h * N + tid % N]);
  } else {
    // warpgroup 1: the inter-chunk outputs (tile of 4 steps x 4 columns, rows
    // part * KR .. part * KR + KR - 1 of S); warpgroup 2: the state, a tile
    // of TI rows x 4 columns a thread, in registers for the whole sequence
    const int me = tid - PREP;
    const bool state_wg = me >= WG;
    const int q_ = state_wg ? me - WG : me;
    const int j0 = 4 * (q_ % JT);
    const int t0 = 4 * ((q_ / JT) % 4), part = q_ / (4 * JT);
    const int i0 = TI * (q_ / JT);
    float* const sm = smem + Ly::SM;
    float* const op = smem + Ly::OP;
    float S[TI][4];
    if (state_wg) {
#pragma unroll
      for (int a = 0; a < TI; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          S[a][c] = state0 != nullptr ? state0[sbase + (long long)(i0 + a) * N + col0 + j0 + c]
                                      : 0.f;
        *reinterpret_cast<float4*>(&sm[(i0 + a) * PC + j0]) =
            make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
      }
    }
    const float* vb = v + b * sv.b + h * sv.h + col0;
    auto issue_v = [=](int chunk) {
      copy_rows<NC, 2 * WG>(smem + Ly::VS + (chunk & 1) * L * NC, vb, sv.t, chunk, len, me);
      cp_async_commit();
    };
    if (n_chunks > 0) issue_v(0);
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const float* const buf = smem + Ly::RQT + (chunk & 1) * Ly::BUF;
      const float* const rqt = buf;
      const float* const kd = buf + (Ly::KD - Ly::RQT);
      const float* const decay = buf + (Ly::DECAY - Ly::RQT);
      const float* const at = buf + (Ly::AS - Ly::RQT);
      const float* const sv_ = smem + Ly::VS + (chunk & 1) * L * NC;
      cp_async_wait_all();
      bar_sync(BAR_FULL + (chunk & 1), THREADS);  // the factors are in; v and S too
      if (chunk + 1 < n_chunks) issue_v(chunk + 1);

      // 4. the outputs in parts: part p sums RQ S over rows p KR .. p KR + KR
      //    - 1 of S and A V over steps p L / KS .. (p + 1) L / KS - 1; or the
      //    state update S <- e^{a_L} S + KD^T V
      if (!state_wg) {
        float o[4][4] = {};
#pragma unroll 8
        for (int i = part * KR; i < part * KR + KR; ++i) {
          const float4 x = ld4(&rqt[i * LP + t0]), y = ld4(&sm[i * PC + j0]);
          const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) o[a][c] = fmaf(xs[a], ys[c], o[a][c]);
        }
#pragma unroll
        for (int s2 = part * (L / KS); s2 < (part + 1) * (L / KS); ++s2) {
          const float4 x = ld4(&at[s2 * LP + t0]), y = ld4(&sv_[s2 * NC + j0]);
          const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) o[a][c] = fmaf(xs[a], ys[c], o[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(&op[(part * L + t0 + a) * PC + j0]) =
              make_float4(o[a][0], o[a][1], o[a][2], o[a][3]);
      } else {
        if (s_seg != nullptr && chunk % seg_chunks == 0) {
          const int n_seg = (n_chunks + seg_chunks - 1) / seg_chunks;
          float* const seg = s_seg + (((long long)b * H + h) * n_seg + chunk / seg_chunks) * N * N;
#pragma unroll
          for (int a = 0; a < TI; ++a)
            *reinterpret_cast<float4*>(&seg[(i0 + a) * N + col0 + j0]) =
                make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
        }
#pragma unroll
        for (int a = 0; a < TI; ++a) {
          const float d = decay[i0 + a];
#pragma unroll
          for (int c = 0; c < 4; ++c) S[a][c] *= d;
        }
#pragma unroll 4
        for (int s2 = 0; s2 < L; ++s2) {
          const float4 y = ld4(&sv_[s2 * NC + j0]);
          const float ys[4] = {y.x, y.y, y.z, y.w};
          float xs[TI];
          if constexpr (TI % 4 == 0) {
#pragma unroll
            for (int a = 0; a < TI; a += 4) {
              const float4 x = ld4(&kd[s2 * P + i0 + a]);
              xs[a] = x.x, xs[a + 1] = x.y, xs[a + 2] = x.z, xs[a + 3] = x.w;
            }
          } else {
#pragma unroll
            for (int a = 0; a < TI; ++a) xs[a] = kd[s2 * P + i0 + a];
          }
#pragma unroll
          for (int a = 0; a < TI; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) S[a][c] = fmaf(xs[a], ys[c], S[a][c]);
        }
      }
      bar_sync(BAR_COMP, 2 * WG);

      // 5. the new state's copy for the next chunk; the outputs: the parts'
      //    sums, one tile of 1 step x 4 columns a thread
      if (state_wg) {
#pragma unroll
        for (int a = 0; a < TI; ++a)
          *reinterpret_cast<float4*>(&sm[(i0 + a) * PC + j0]) =
              make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
      }
#pragma unroll
      for (int tile0 = 0; tile0 < L * JT; tile0 += 2 * WG) {
        const int tile = tile0 + me;
        if ((L * JT) % (2 * WG) != 0 && tile >= L * JT) break;
        const int t = tile / JT, jo = 4 * (tile % JT);
        float4 x = ld4(&op[t * PC + jo]);
#pragma unroll
        for (int p2 = 1; p2 < KS; ++p2) {
          const float4 y = ld4(&op[(p2 * L + t) * PC + jo]);
          x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
        }
        if (chunk * L + t < len)
          *reinterpret_cast<float4*>(out + ((long long)b * T + chunk * L + t) * H * N +
                                     (long long)h * N + col0 + jo) = x;
      }
      // buffer chunk & 1 may take chunk + 2 (which the preparing warps wait for)
      if (chunk + 2 < n_chunks) bar_arrive(BAR_EMPTY + (chunk & 1), THREADS);
    }
    if (state_wg) {
#pragma unroll
      for (int a = 0; a < TI; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          state_out[sbase + (long long)(i0 + a) * N + col0 + j0 + c] = S[a][c];
    }
  }

  // pad steps' outputs
  for (int idx = tid; idx < (T - len) * NC; idx += THREADS) {
    const long long t = len + idx / NC;
    out[((long long)b * T + t) * H * N + (long long)h * N + col0 + idx % NC] = 0.f;
  }
}

template <int N, int NC>
cudaError_t launch(cudaStream_t st, const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* state0, const int* lengths,
                   float* out, float* state_out, float* s_seg, int seg_chunks, int B, int T,
                   int H, Strides sr, Strides sk, Strides sv, Strides sw) {
  constexpr int bytes = Layout<N, NC>::FLOATS * 4;
  cudaError_t err = cudaFuncSetAttribute(wkv_chunked_kernel<N, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  wkv_chunked_kernel<N, NC><<<dim3(H, B, N / NC), THREADS, bytes, st>>>(
      r, k, v, w, u, state0, lengths, out, state_out, s_seg, seg_chunks, T, H, sr, sk, sv, sw);
  return cudaGetLastError();
}

}  // namespace

// The shared memory of one block at (N, NC), in bytes (for the build log).
extern "C" int wkv_chunked_smem(int N, int NC) {
  switch (N * 1000 + NC) {
    case 64016: return Layout<64, 16>::FLOATS * 4;
    case 64032: return Layout<64, 32>::FLOATS * 4;
    case 64064: return Layout<64, 64>::FLOATS * 4;
    case 32016: return Layout<32, 16>::FLOATS * 4;
    case 32032: return Layout<32, 32>::FLOATS * 4;
    default: return -1;
  }
}

// r, k, v, w: (B, T, H, N) fp32 with element strides (batch, time, head) and a
// contiguous last axis, 16-byte aligned bases and strides that are multiples
// of 4 elements; u: (H, N) fp32 contiguous; state0: (B, H, N, N) fp32
// contiguous, or null for a zero state; lengths: (B,) int32, or null for T
// steps everywhere; out: (B, T, H, N) fp32 contiguous; state_out: (B, H, N, N)
// fp32 contiguous, which may be state0 (updated in place). (N, NC) in
// {(64, 16), (64, 32), (64, 64), (32, 16), (32, 32)}: NC value columns a
// block. s_seg: null, or with lengths null a (B, H, ceil(T / (16
// seg_chunks)), N, N) fp32 contiguous tensor that takes the state at the
// start of each segment of seg_chunks >= 1 chunks. Returns
// cudaGetLastError().
extern "C" int wkv_chunked_fwd(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* state0, const void* lengths,
                               void* out, void* state_out, void* s_seg, int seg_chunks, int B,
                               int T, int H, int N, int NC,
                               long long srb, long long srt, long long srh, long long skb,
                               long long skt, long long skh, long long svb, long long svt,
                               long long svh, long long swb, long long swt, long long swh,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sr{srb, srt, srh}, sk{skb, skt, skh}, sv{svb, svt, svh}, sw{swb, swt, swh};
  const float *fr = static_cast<const float*>(r), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fw = static_cast<const float*>(w),
              *fu = static_cast<const float*>(u), *fs = static_cast<const float*>(state0);
  const int* lens = static_cast<const int*>(lengths);
  float* fo = static_cast<float*>(out);
  float* fso = static_cast<float*>(state_out);
  float* fseg = static_cast<float*>(s_seg);
  if (fseg != nullptr && (seg_chunks < 1 || lens != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define WKV_CHUNKED_CASE(n, nc)                                                          \
  case n * 1000 + nc:                                                                    \
    return static_cast<int>(launch<n, nc>(st, fr, fk, fv, fw, fu, fs, lens, fo, fso, fseg, \
                                          seg_chunks, B, T, H, sr, sk, sv, sw));
  switch (N * 1000 + NC) {
    WKV_CHUNKED_CASE(64, 16)
    WKV_CHUNKED_CASE(64, 32)
    WKV_CHUNKED_CASE(64, 64)
    WKV_CHUNKED_CASE(32, 16)
    WKV_CHUNKED_CASE(32, 32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV_CHUNKED_CASE
}
