// Backward of the RWKV6 WKV recurrence for Hopper (sm_90a): the gradients
// of csrc/wkv_chunked.cu's forward over whole sequences, in the chunked form.
//
// Differentiates the function of repro/kernels/wkv/kernel.py:51::wkv_pallas;
// the JAX package has no backward kernel (it differentiates its model's
// lax.scan, repro/models/recurrent.py::wkv_scan, in XLA).
// kernels/wkv/ref.py::wkv_bwd_chunked_ref is this arithmetic in PyTorch and
// wkv_bwd_ref the sequential formula both are held to. Per (batch b, head
// h), with S_{t-1} the state before step t and D_t the gradient of the
// state after it (D_T = dstate, zeros if none):
//   D_{t-1} = diag(w_t) D_t + r_t do_t^T
//   dr_t = S_{t-1} do_t + u k_t (v_t . do_t),  dk_t = D_t v_t + u r_t (v_t . do_t)
//   dv_t = D_t^T k_t + (r_t . u k_t) do_t,     dw_t = rowsum(D_t * S_{t-1})
//   du = sum over b and t of r k (v . do),     dstate0 = D_0
// dw is 0 where the forward clamps log w (below -60: its output does not
// depend on w there). No lengths: a train step runs whole sequences.
//
// States. Given s_seg, the chunked forward writes the state at the start of
// each segment of seg_chunks chunks (64 steps: a (B, H, ceil(T / 64), N, N)
// fp32 tensor, 67 MB at rwkv6-7b's train shape (8, 512, 64, 64), against
// 268 MB for every chunk's start). The backward takes the segments from the
// last: it rebuilds each chunk's starting state in shared memory from its
// segment's (the forward's state update, S <- 2^tot S + KD^T V), then runs
// the segment's chunks from the last, carrying D.
//
// A chunk of L = 16 steps, with lw = max(log2 w, -60 log2 e) (0 past T),
// pre_t and post_t the sums of lw over the chunk's steps before and after
// t, E[t][s] = 2^(sum of lw over s < m < t) (a direct sum, never the
// difference of two), S its starting state, D the gradient of its final
// one, sd_t = S do_t, dvv_t = D v_t and M = dO V^T:
//   drS_t = 2^pre_t sd_t + sum_{s<t} E[t][s] k_s M[t][s]
//   dkD_t = 2^post_t dvv_t + sum_{s>t} E[s][t] r_s M[s][t]
//   dr = drS + u k M[t][t],  dk = dkD + u r M[t][t]
//   dv_t = D^T (k_t 2^post_t) + sum_{s>=t} A[s][t] do_s, with the forward's
//          scores A[t][s] = sum_i r_t k_s E[t][s] (s < t), A[t][t] = r_t . u k_t
//   dw_t = 2^(pre_t + post_t) rowsum(D * S) + 2^post_t sum_{s<t} E[t][s] k_s dvv_s
//          + 2^pre_t sum_{s>t} E[s][t] r_s sd_s
//          + sum_{s>t} E[s][t] r_s sum_{q<t} E[t][q] k_q M[s][q]
//   D <- 2^(sum lw) (rows) D + (r 2^pre)^T dO
// Every factor is an E or a 2^x of a sum of log decays, at most 1: the
// elementwise form of the forward, which never overflows, so no factored
// branch is needed (its exponentials, L^2 N / 2 a chunk, are few beside the
// N^2 L products). dw is the rowsum itself, expanded: the identity that
// takes d(log w) from prefix sums of r drS and k dkD, divided by w, loses
// the relative precision of small decays (1.6e-3 of dw at w in (0, 0.2) in
// fp32, against 3e-7 for this form; kernels/wkv/ref.py's mirror).
//
//
// Design (redesigned for Hopper): one block per (b, h) of 512 threads,
// owning the segment's chunk states and D whole in shared memory (230144
// bytes: one block an SM); every sum runs in a fixed order and no atomics,
// so the same inputs give the same bits. The states are N x N rows whose
// 16-byte granules are swizzled by row (granule c of row i at c ^ ((i / 4)
// % 8)), so that a warp reads a column of granules over 16 rows as well as
// a row without bank conflicts, and every N x N product runs on register
// tiles: a thread owns a 4 x 4 (or 2 x 4, 4 x 2) block of the output and
// reads each operand as 16-byte vectors once per 4-deep step (16 FFMA a
// load, against 1 in the first design). The steps of a segment (the chunk
// states rebuilt from its start, then its chunks from the last) run as one
// sequence whose next step's inputs (and the next segment's start state)
// arrive by cp.async into a second buffer while the current step computes.
// A backward chunk takes four phases between barriers, each spread over
// all 16 warps:
//   1. the log decays and their sums before and after each step (a thread
//      a channel and an eighth of the chunk, the eighths' totals exchanged
//      by shuffles; each sum a direct one), KD, RQ and their factors; M and
//      M^T (a warp a step, the channels' halves summed by a shuffle); sd =
//      S do and dvv = D v (4 x 4 tiles over a quarter of the channels, the
//      quarters summed by shuffles); rowsum(D S) (2 x 4 tiles, a 16-lane
//      butterfly);
//   2. every pair q < t's factors E[t][q] k_q and E[t][q] r_t (a thread a
//      channel and two q of the same work, t from q + 1 on: 2 x 120 x 64 in
//      shared memory, rows padded so that neighbouring pairs fall in other
//      banks); KD^T D (2 x 4 tiles over a quarter of the channels, summed
//      by shuffles into the thread's (step, two columns), kept in
//      registers);
//   3. the scores A[t][q] (a thread a quarter of a pair's channels, 16-byte
//      loads, two shuffles) and dr, dk and dw a (step t, channel i) each
//      from the factors, t the same across a warp (t and t + 8: the same
//      work); the loop over q < t runs as far as t needs, each q feeding
//      the 16 sums over the later steps from registers (a switch on t's
//      first group of 4 later steps, taken once an item, keeps the loop
//      free of branches);
//   4. dv (KD^T D plus the scores times dO) and D at the chunk's start (4 x
//      2 tiles of the rank-16 update).
// du: each thread's share of r k M[t][t], summed over the warps in order,
// then over b in order by a second launch (no atomics), as a resumed train
// step needs.
//
// What set the design (cycle stamps by phase and warp, on an H100 80GB HBM3
// at 700 W, at (8, 512, 64, 64)): with 256 threads the (t, i) pass as 16
// unrolled instantiations, one a t, ran from a cold instruction cache and
// took most of the time; run as loops over shared memory it was
// bound by each FMA's wait for its loads; every phase ran at a low rate of
// instructions a cycle, so the block went to 512 threads (128 registers a
// thread, no spill) and the pass to the register sums above. Tried and
// dropped: segments of 32 steps (2 chunks; half the rebuilding, twice the
// s_seg): a little off the backward, less the forward's longer writes,
// for 67 MB more a layer.
//
// Bound on an H100: at (8, 512, 64, 64) it reads r, k, v, w and do and
// writes dr, dk, dv and dw (36 bytes a (b, t, h, i)) and reads s_seg: 671
// MB, 0.20 ms at 3.35 TB/s; about 10 N^2 fp32 operations a (b, t, h), 0.16
// ms at 67 TFLOP/s. It takes 1.233 ms there (16% of the bound) against
// the first design's 2.809 in the same call (chip_pair.py, the mean of two
// turns each, on an H100 80GB HBM3 at 700 W); ptxas: 128 registers, no
// spill.

#include <cuda_runtime.h>

namespace {

constexpr int N = 64;                // head size
constexpr int L = 16;                // steps a chunk
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SEG_CHUNKS = 4;    // chunk states a block keeps
constexpr int P = N + 4;             // a row of a chunk's tile, padded to 16 bytes
constexpr int LP = L + 4;            // a row of M, M^T and the scores
constexpr int PAIRS = L * (L - 1) / 2;  // the chunk's (t, q) pairs with q < t
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LOG2_W_MIN = -60.f * LOG2E;
constexpr unsigned FULL = 0xffffffffu;

struct Tiles {                       // a chunk's inputs, zeros past T
  float r[L * P], k[L * P], v[L * P], w[L * P], dout[L * P];
};

struct Smem {
  float st[MAX_SEG_CHUNKS][N * N];   // each chunk's starting state in the segment (swizzled)
  float d[N * N];                    // the gradient of the current chunk's final state (swizzled)
  Tiles in[2];                       // this step's inputs and the next one's
  float lw[L * P];                   // log2 w, clamped; 0 past T
  float epre[L * P], epost[L * P], epp[L * P];  // 2^pre, 2^post, 2^(pre + post)
  float kd[L * P], rq[L * P];        // k 2^post, r 2^pre
  float sd[L * P], dvv[L * P];       // S do_t, D v_t
  float m[L * LP], mt[L * LP];       // M[t][s] = do_t . v_s, and M^T
  float a[L * LP];                   // the scores A[t][q], q <= t
  float xe[PAIRS * P], ye[PAIRS * P];  // E[t][q] k_q and E[t][q] r_t of pair (t, q), by channel
  __align__(16) float u[N];          // the bonus
  float etot[N], p0[N];              // 2^(sum lw); rowsum(D * S)
};

// the index of pair (t, q), q < t, in xe and ye
__host__ __device__ constexpr int pair(int t, int q) { return t * (t - 1) / 2 + q; }

// each pair's t and q
struct PairTable {
  unsigned char t[PAIRS], q[PAIRS];
};

constexpr PairTable make_pair_table() {
  PairTable tab{};
  for (int t = 1; t < L; ++t)
    for (int q = 0; q < t; ++q) {
      tab.t[pair(t, q)] = static_cast<unsigned char>(t);
      tab.q[pair(t, q)] = static_cast<unsigned char>(q);
    }
  return tab;
}

__constant__ PairTable PAIR_OF = make_pair_table();

// the float offset of 16-byte granule c of row `row` of a swizzled N x N state
__device__ __forceinline__ int swz(int row, int c) {
  return row * N + ((c ^ ((row >> 2) & 7)) << 2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

__device__ __forceinline__ void st2(float* p, float2 x) { *reinterpret_cast<float2*>(p) = x; }

__device__ __forceinline__ float at(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// log2 w for w in [0, 1], as csrc/wkv_chunked.cu takes it: above 15/16 by
// log1p's series on 1 - w, else by the hardware's lg2
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A step of a block: chunk c of segment g, rebuilding the next chunk's
// starting state (back 0) or taking the chunk's gradients (back 1); g < 0
// past the last
struct Step {
  int g, c, back;
};

__device__ __forceinline__ int chunks_in(int g, int seg_chunks, int n_chunks) {
  return min(seg_chunks, n_chunks - g * seg_chunks);
}

__device__ __forceinline__ Step first_step(int g, int seg_chunks, int n_chunks) {
  return Step{g, 0, chunks_in(g, seg_chunks, n_chunks) > 1 ? 0 : 1};
}

// segment g: its chunk states rebuilt from the first, then its chunks from
// the last; then segment g - 1
__device__ __forceinline__ Step next_step(Step s, int seg_chunks, int n_chunks) {
  const int nc = chunks_in(s.g, seg_chunks, n_chunks);
  if (!s.back) return s.c + 2 < nc ? Step{s.g, s.c + 1, 0} : Step{s.g, nc - 1, 1};
  if (s.c > 0) return Step{s.g, s.c - 1, 1};
  return s.g > 0 ? first_step(s.g - 1, seg_chunks, n_chunks) : Step{-1, 0, 0};
}

// the slot of chunk c of segment g's starting state: a segment's first
// slot follows the next segment's, so that its start state arrives while
// the next segment's first chunk still reads its own
__device__ __forceinline__ int slot(int g, int c, int n_seg) {
  return (n_seg - 1 - g + c) % MAX_SEG_CHUNKS;
}

// a step's inputs, rows t0 .. t0 + L - 1 (zeros past T): k, v and w
// (threads 0-255), and r and dout for a backward step (256-511); a (row,
// 16-byte granule) a thread
__device__ __forceinline__ void load_step(Tiles& x, const float* rb, const float* kb,
                                          const float* vb, const float* wb, const float* ob,
                                          long long row, int t0, int T, bool back) {
  const int e = threadIdx.x & 255, s = e >> 4, c = e & 15, t = t0 + s;
  const bool live = t < T;
  const long long off = live ? t * row + 4 * c : 0;
  const int o = s * P + 4 * c;
  if (threadIdx.x < 256) {
    cp_async16(x.k + o, kb + off, live);
    cp_async16(x.v + o, vb + off, live);
    cp_async16(x.w + o, wb + off, live);
  } else if (back) {
    cp_async16(x.r + o, rb + off, live);
    cp_async16(x.dout + o, ob + off, live);
  }
}

// an N x N fp32 state, row-major, into a swizzled one
__device__ __forceinline__ void load_state(float* dst, const float* src) {
  for (int e = threadIdx.x; e < N * N / 4; e += THREADS)
    cp_async16(dst + swz(e >> 4, e & 15), src + 4 * e, true);
}

// The chunk's log decays, clamped (0 past T), and the sums of lw before
// (pre) and after (post) each step: a thread a channel i and an eighth q of
// the chunk (steps 2q, 2q + 1), the eighths' totals exchanged by shuffles,
// each sum a direct one; 2^(the chunk's sum) and KD = k 2^post, and (BACK)
// lw, 2^pre, 2^post, 2^(pre + post) and RQ = r 2^pre
template <bool BACK>
__device__ __forceinline__ void decays(Smem& sm, const Tiles& x, int t0, int T) {
  const int lane = threadIdx.x & 31, i = (threadIdx.x >> 5) * 4 + (lane >> 3), q = lane & 7;
  float lw[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int s = 2 * q + a;
    lw[a] = t0 + s < T ? fmaxf(log2_decay(x.w[s * P + i]), LOG2_W_MIN) : 0.f;
  }
  const float tot = lw[0] + lw[1];
  float part[8];
#pragma unroll
  for (int qq = 0; qq < 8; ++qq) part[qq] = __shfl_sync(FULL, tot, (lane & ~7) | qq);
  float pre = 0.f, after = 0.f, all = 0.f;
#pragma unroll
  for (int qq = 0; qq < 8; ++qq) {
    if (qq < q) pre += part[qq];
    all += part[qq];
  }
#pragma unroll
  for (int qq = 7; qq >= 0; --qq)
    if (qq > q) after += part[qq];
  if (q == 0) sm.etot[i] = exp2f(all);
  const float post[2] = {lw[1] + after, after};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int o = (2 * q + a) * P + i;
    const float e_post = exp2f(post[a]);
    sm.kd[o] = x.k[o] * e_post;
    if (BACK) {
      const float e_pre = exp2f(pre);
      sm.lw[o] = lw[a];
      sm.epre[o] = e_pre;
      sm.epost[o] = e_post;
      sm.epp[o] = exp2f(pre + post[a]);
      sm.rq[o] = x.r[o] * e_pre;
    }
    pre += lw[a];
  }
}

// out[i][j] = etot[i] in[i][j] + sum_s X[s][i] Y[s][j] (the state's rank-L
// update): a 4 x 2 tile a thread (rows 4 ti .., columns 2 tj ..), s in
// order; out may be in
__device__ __forceinline__ void rank_update(float* out, const float* in, const float* X,
                                            const float* Y, const float* etot) {
  const int ti = threadIdx.x >> 5, tj = threadIdx.x & 31;
  const int col = 2 * (tj & 1);  // the pair's place in its granule
  float2 acc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float e = etot[4 * ti + a];
    const float2 s = ld2(in + swz(4 * ti + a, tj >> 1) + col);
    acc[a] = make_float2(e * s.x, e * s.y);
  }
#pragma unroll
  for (int s = 0; s < L; ++s) {
    const float4 xs = ld4(X + s * P + 4 * ti);
    const float2 ys = ld2(Y + s * P + 2 * tj);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float xa = at(xs, a);
      acc[a].x = fmaf(xa, ys.x, acc[a].x);
      acc[a].y = fmaf(xa, ys.y, acc[a].y);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) st2(out + swz(4 * ti + a, tj >> 1) + col, acc[a]);
}

// M[t][s] = do_t . v_s and its transpose: a warp a t, a lane an s and half
// of the channels, the halves summed by a shuffle
__device__ __forceinline__ void dout_v(Smem& sm, const Tiles& x) {
  const int t = threadIdx.x >> 5, lane = threadIdx.x & 31, s = lane & 15, h = lane >> 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int cc = 0; cc < N / 8; ++cc) {
    const int c = (N / 8) * h + cc;
    const float4 a = ld4(x.dout + t * P + 4 * c), b = ld4(x.v + s * P + 4 * c);
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.y = fmaf(a.y, b.y, acc.y);
    acc.z = fmaf(a.z, b.z, acc.z);
    acc.w = fmaf(a.w, b.w, acc.w);
  }
  float m = (acc.x + acc.y) + (acc.z + acc.w);
  m += __shfl_xor_sync(FULL, m, 16);
  if (h == 0) {
    sm.m[t * LP + s] = m;
    sm.mt[s * LP + t] = m;
  }
}

// Four 4 x 4 tiles acc[a][b] of four threads (lanes 8 and 16 apart, split
// = lane bits 3-4), each a quarter of one sum, summed by shuffles into row
// 2 (split >> 1) + (split & 1) of the tile, one a thread
__device__ __forceinline__ float4 sum_quarters(float (&acc)[4][4], int split) {
  const bool hi = (split & 2) != 0, lo = (split & 1) != 0;
  float pair2[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float mine = hi ? acc[a + 2][b] : acc[a][b];
      const float other = hi ? acc[a][b] : acc[a + 2][b];
      pair2[a][b] = mine + __shfl_xor_sync(FULL, other, 16);
    }
  float res[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float mine = lo ? pair2[1][b] : pair2[0][b];
    const float other = lo ? pair2[0][b] : pair2[1][b];
    res[b] = mine + __shfl_xor_sync(FULL, other, 8);
  }
  return make_float4(res[0], res[1], res[2], res[3]);
}

// sd[t][i] = sum_j S[i][j] do_t[j] (warps 0-7) and dvv[t][i] = sum_j D[i][j]
// v_t[j] (warps 8-15): a 4 x 4 tile of (t, i) over a quarter of j a thread,
// the quarters summed by shuffles
__device__ __forceinline__ void state_products(Smem& sm, const Tiles& x, const float* S) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int prod = w >> 3, tt = (w >> 1) & 3, ti = 8 * (w & 1) + (lane & 7), split = lane >> 3;
  const float* X = prod ? x.v : x.dout;
  const float* Y = prod ? sm.d : S;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll
  for (int cc = 0; cc < N / 16; ++cc) {
    const int c = (N / 16) * split + cc;
    float4 xa[4], yb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xa[a] = ld4(X + (4 * tt + a) * P + 4 * c);
#pragma unroll
    for (int b = 0; b < 4; ++b) yb[b] = ld4(Y + swz(4 * ti + b, c));
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float s = fmaf(xa[a].x, yb[b].x, acc[a][b]);
        s = fmaf(xa[a].y, yb[b].y, s);
        s = fmaf(xa[a].z, yb[b].z, s);
        acc[a][b] = fmaf(xa[a].w, yb[b].w, s);
      }
  }
  const float4 res = sum_quarters(acc, split);
  st4((prod ? sm.dvv : sm.sd) + (4 * tt + 2 * (split >> 1) + (split & 1)) * P + 4 * ti, res);
}

// p0[i] = rowsum(D * S): 2 x 4 tiles, the row's 16 tiles summed by a
// butterfly over 16 lanes
__device__ __forceinline__ void row_dots(Smem& sm, const float* S) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  float p[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float4 dd = ld4(sm.d + swz(2 * ti + a, tj)), ss = ld4(S + swz(2 * ti + a, tj));
    p[a] = fmaf(dd.w, ss.w, fmaf(dd.z, ss.z, fmaf(dd.y, ss.y, dd.x * ss.x)));
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int a = 0; a < 2; ++a) p[a] += __shfl_xor_sync(FULL, p[a], off);
  if (tj == 0)
#pragma unroll
    for (int a = 0; a < 2; ++a) sm.p0[2 * ti + a] = p[a];
}

// KD^T D for dv: dvd[t][j] = sum_i kd[t][i] D[i][j], a 2 x 4 tile of (t, j)
// over a quarter of i a thread (lanes 8 and 16 apart), summed by shuffles
// into a (row, column pair) a thread: row t, columns j .. j + 1
__device__ __forceinline__ float2 kd_d(const Smem& sm, int& t, int& j) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tt = w >> 1, tj = 8 * (w & 1) + (lane & 7), split = lane >> 3;
  float acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll
  for (int cc = 0; cc < N / 16; ++cc) {
    const int c = (N / 16) * split + cc;  // channels 4c .. 4c + 3
    float4 ka[2], db[4];
#pragma unroll
    for (int a = 0; a < 2; ++a) ka[a] = ld4(sm.kd + (2 * tt + a) * P + 4 * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) db[e] = ld4(sm.d + swz(4 * c + e, tj));
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float k = at(ka[a], e);
        acc[a][0] = fmaf(k, db[e].x, acc[a][0]);
        acc[a][1] = fmaf(k, db[e].y, acc[a][1]);
        acc[a][2] = fmaf(k, db[e].z, acc[a][2]);
        acc[a][3] = fmaf(k, db[e].w, acc[a][3]);
      }
  }
  // split bit 1 keeps row a, bit 0 the column pair
  const bool hi = (split & 2) != 0, lo = (split & 1) != 0;
  float row[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float mine = hi ? acc[1][b] : acc[0][b];
    const float other = hi ? acc[0][b] : acc[1][b];
    row[b] = mine + __shfl_xor_sync(FULL, other, 16);
  }
  float res[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const float mine = lo ? row[b + 2] : row[b];
    const float other = lo ? row[b] : row[b + 2];
    res[b] = mine + __shfl_xor_sync(FULL, other, 8);
  }
  t = 2 * tt + hi;
  j = 4 * tj + 2 * lo;
  return make_float2(res[0], res[1]);
}

// E[t][q] = 2^(sum of lw over q < m < t) of every pair, times k_q (xe) and
// times r_t (ye): a thread a channel and two q (a and 15 - a: the same
// work), t from q + 1 on, the sum a direct one
__device__ __forceinline__ void pair_factors(Smem& sm, const Tiles& x) {
  const int i = threadIdx.x & (N - 1), a = threadIdx.x / N;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int q = n == 0 ? a : L - 1 - a;
    const float kq = x.k[q * P + i];
    float gap = 0.f;
#pragma unroll 4
    for (int t = q + 1; t < L; ++t) {
      const float e = exp2f(gap);
      sm.xe[pair(t, q) * P + i] = e * kq;
      sm.ye[pair(t, q) * P + i] = e * x.r[t * P + i];
      gap += sm.lw[t * P + i];
    }
  }
}

// The scores A[t][q] = sum_i r_t E[t][q] k_q (q < t) and A[t][t] = sum_i r_t
// u k_t: a thread a quarter of the channels of a pair (or diagonal entry),
// by 16-byte loads, the four quarters (neighbouring lanes) summed by
// shuffles
__device__ __forceinline__ void scores(Smem& sm, const Tiles& x) {
  constexpr int TASKS = 4 * (PAIRS + L);
#pragma unroll
  for (int task = threadIdx.x; task < (TASKS + THREADS - 1) / THREADS * THREADS;
       task += THREADS) {
    const int p = task >> 2, c = 4 * (task & 3);  // the quarter's first granule
    float acc = 0.f;
    if (p < PAIRS) {
      const float* xr = x.r + PAIR_OF.t[p] * P;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 a = ld4(xr + 4 * (c + e)), b = ld4(sm.xe + p * P + 4 * (c + e));
        acc = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
      }
    } else if (p < PAIRS + L) {
      const int o = (p - PAIRS) * P;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 a = ld4(x.r + o + 4 * (c + e)), b = ld4(x.k + o + 4 * (c + e));
        const float4 uu = ld4(sm.u + 4 * (c + e));
        acc = fmaf(a.w * uu.w, b.w,
                   fmaf(a.z * uu.z, b.z, fmaf(a.y * uu.y, b.y, fmaf(a.x * uu.x, b.x, acc))));
      }
    }
    acc += __shfl_xor_sync(FULL, acc, 1);
    acc += __shfl_xor_sync(FULL, acc, 2);
    if ((task & 3) == 0) {
      if (p < PAIRS)
        sm.a[PAIR_OF.t[p] * LP + PAIR_OF.q[p]] = acc;
      else if (p < PAIRS + L)
        sm.a[(p - PAIRS) * (LP + 1)] = acc;
    }
  }
}

struct Grads {
  float *dr, *dk, *dw;
  long long base, row;
  int t0, T;
};

// The sums over q < t of an item: acc[s] = sum_q E[t][q] k_q M[s][q] for
// the steps s of groups G0 .. 3 of 4 (those past t and, in group G0, some
// at or before t, unused), and drs, dw_k; q from t - 1 down
template <int G0>
__device__ __forceinline__ void item_sums(const Smem& sm, int t, int i, float (&acc)[L],
                                          float& drs, float& dw_k) {
  const float* xt = sm.xe + pair(t, 0) * P + i;  // E[t][q] k_q at xt[q P]
#pragma unroll 2
  for (int q = t - 1; q >= 0; --q) {
    const float xq = xt[q * P];
    drs = fmaf(xq, sm.m[t * LP + q], drs);
    dw_k = fmaf(xq, sm.dvv[q * P + i], dw_k);
#pragma unroll
    for (int s4 = G0; s4 < L / 4; ++s4) {
      const float4 m4 = ld4(sm.mt + q * LP + 4 * s4);  // M[s][q], s = 4 s4 ..
      acc[4 * s4] = fmaf(xq, m4.x, acc[4 * s4]);
      acc[4 * s4 + 1] = fmaf(xq, m4.y, acc[4 * s4 + 1]);
      acc[4 * s4 + 2] = fmaf(xq, m4.z, acc[4 * s4 + 2]);
      acc[4 * s4 + 3] = fmaf(xq, m4.w, acc[4 * s4 + 3]);
    }
  }
}

// The sums over s > t of an item, s in groups G0 .. 3 of 4 (in group G0
// only those past t): dkd, dw_r and dw_rk
template <int G0>
__device__ __forceinline__ void item_later(const Smem& sm, int t, int i, const float (&acc)[L],
                                           float& dkd, float& dw_r, float& dw_rk) {
#pragma unroll
  for (int s = 4 * G0; s < L; ++s)
    if (s > t) {
      const float ys = sm.ye[pair(s, t) * P + i];  // E[s][t] r_s
      dkd = fmaf(ys, sm.mt[t * LP + s], dkd);
      dw_r = fmaf(ys, sm.sd[s * P + i], dw_r);
      dw_rk = fmaf(ys, acc[s], dw_rk);
    }
}

// dr, dk and dw at step t of the chunk and channel i, from the pairs'
// factors; returns the channel's share of du at this step. t is the same
// across the warp: the loops run as far as t needs, each q feeding the
// sums over the later steps s from registers, from the first group of 4
// steps that holds one past t (a branch on t taken once an item)
__device__ __forceinline__ float step_grads(const Smem& sm, const Tiles& x, int t, int i,
                                            const Grads& g) {
  const int o = t * P + i;
  const float ri = x.r[o], ki = x.k[o], ui = sm.u[i];
  float acc[L];  // acc[s] = sum_{q<t} E[t][q] k_q M[s][q], for s > t
#pragma unroll
  for (int s = 0; s < L; ++s) acc[s] = 0.f;
  float drs = 0.f, dw_k = 0.f, dkd = 0.f, dw_r = 0.f, dw_rk = 0.f;
  switch ((t + 1) / 4) {
    case 0:
      item_sums<0>(sm, t, i, acc, drs, dw_k);
      item_later<0>(sm, t, i, acc, dkd, dw_r, dw_rk);
      break;
    case 1:
      item_sums<1>(sm, t, i, acc, drs, dw_k);
      item_later<1>(sm, t, i, acc, dkd, dw_r, dw_rk);
      break;
    case 2:
      item_sums<2>(sm, t, i, acc, drs, dw_k);
      item_later<2>(sm, t, i, acc, dkd, dw_r, dw_rk);
      break;
    default:
      item_sums<3>(sm, t, i, acc, drs, dw_k);
      item_later<3>(sm, t, i, acc, dkd, dw_r, dw_rk);
  }
  const float e_pre = sm.epre[o], e_post = sm.epost[o];
  drs = fmaf(e_pre, sm.sd[o], drs);
  dkd = fmaf(e_post, sm.dvv[o], dkd);
  const float dwt = sm.epp[o] * sm.p0[i] + e_post * dw_k + e_pre * dw_r + dw_rk;
  const float mtt = sm.m[t * LP + t];
  if (g.t0 + t < g.T) {
    const long long off = g.base + (g.t0 + t) * g.row + i;
    g.dr[off] = fmaf(ui * ki, mtt, drs);
    g.dk[off] = fmaf(ui * ri, mtt, dkd);
    g.dw[off] = log2_decay(x.w[o]) < LOG2_W_MIN ? 0.f : dwt;
  }
  return ri * ki * mtt;
}

__global__ void __launch_bounds__(THREADS, 1)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s_seg,
               const float* __restrict__ dout, const float* __restrict__ dstate,
               float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ dstate0,
               float* __restrict__ du_part, int T, int H, int seg_chunks) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long row = static_cast<long long>(H) * N;
  const long long base = static_cast<long long>(b) * T * row + static_cast<long long>(h) * N;
  const int n_chunks = (T + L - 1) / L;
  const int n_seg = (n_chunks + seg_chunks - 1) / seg_chunks;
  const float *rb = r + base, *kb = k + base, *vb = v + base, *wb = w + base,
              *ob = dout + base;

  for (int e = tid; e < N * N / 4; e += THREADS)
    st4(sm.d + swz(e >> 4, e & 15),
        dstate != nullptr ? ld4(dstate + bh * N * N + 4 * e) : make_float4(0.f, 0.f, 0.f, 0.f));
  if (tid < N) sm.u[tid] = u[h * N + tid];
  // the items of this thread: channel 32 (warp / 8) + lane at steps warp % 8
  // and warp % 8 + 8; its share of du
  const int ch = 32 * (warp >> 3) + lane, t_lo = warp & 7;
  float du_acc = 0.f;

  Step s = first_step(n_seg - 1, seg_chunks, n_chunks);
  load_step(sm.in[0], rb, kb, vb, wb, ob, row, (s.g * seg_chunks + s.c) * L, T, s.back);
  load_state(sm.st[slot(s.g, 0, n_seg)], s_seg + (bh * n_seg + s.g) * N * N);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int buf = 0; s.g >= 0; buf ^= 1) {
    const Step nx = next_step(s, seg_chunks, n_chunks);
    if (nx.g >= 0) {  // the next step's inputs, and its segment's start state
      load_step(sm.in[buf ^ 1], rb, kb, vb, wb, ob, row, (nx.g * seg_chunks + nx.c) * L, T,
                nx.back);
      if (nx.g != s.g)
        load_state(sm.st[slot(nx.g, 0, n_seg)], s_seg + (bh * n_seg + nx.g) * N * N);
    }
    cp_async_commit();
    const Tiles& x = sm.in[buf];
    const int t0 = (s.g * seg_chunks + s.c) * L;
    if (!s.back) {  // the next chunk's starting state: S <- 2^tot S + KD^T V
      decays<false>(sm, x, t0, T);
      __syncthreads();
      rank_update(sm.st[slot(s.g, s.c + 1, n_seg)], sm.st[slot(s.g, s.c, n_seg)], sm.kd, x.v,
                  sm.etot);
    } else {
      const float* S = sm.st[slot(s.g, s.c, n_seg)];
      // 1. decays, M, sd, dvv, rowsum(D * S)
      decays<true>(sm, x, t0, T);
      dout_v(sm, x);
      state_products(sm, x, S);
      row_dots(sm, S);
      __syncthreads();
      // 2. the pairs' factors; KD^T D
      pair_factors(sm, x);
      int t, j;
      float2 acc = kd_d(sm, t, j);
      __syncthreads();
      // 3. the scores; dr, dk and dw
      scores(sm, x);
      const Grads g{dr, dk, dw, base, row, t0, T};
      du_acc += step_grads(sm, x, t_lo, ch, g);
      du_acc += step_grads(sm, x, t_lo + 8, ch, g);
      __syncthreads();
      // 4. dv_t = KD^T D + sum_{s>=t} A[s][t] do_s; D at the chunk's start
      for (int q = t; q < L; ++q) {
        const float a = sm.a[q * LP + t];
        const float2 o = ld2(x.dout + q * P + j);
        acc.x = fmaf(a, o.x, acc.x);
        acc.y = fmaf(a, o.y, acc.y);
      }
      if (t0 + t < T) st2(dv + base + (t0 + t) * row + j, acc);
      rank_update(sm.d, sm.d, sm.rq, x.dout, sm.etot);
    }
    cp_async_wait_all();
    __syncthreads();
    s = nx;
  }
  if (dstate0 != nullptr)
    for (int e = tid; e < N * N / 4; e += THREADS)
      st4(dstate0 + bh * N * N + 4 * e, ld4(sm.d + swz(e >> 4, e & 15)));
  // du's share of this (b, h): the shares of the 8 warps of each channel
  // summed in order
  sm.sd[warp * 32 + lane] = du_acc;
  __syncthreads();
  if (tid < N) {
    float acc = 0.f;
    for (int q = 0; q < WARPS / 2; ++q) acc += sm.sd[((tid >> 5) * (WARPS / 2) + q) * 32 + (tid & 31)];
    du_part[bh * N + tid] = acc;
  }
}

// du[h, i] = sum over b, in order, of du_part[b, h, i]
__global__ void wkv_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                                  int B, int HN) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= HN) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[static_cast<long long>(b) * HN + e];
  du[e] = acc;
}

}  // namespace

// The shared memory of one block, in bytes (for the build log).
extern "C" int wkv_bwd_smem() { return static_cast<int>(sizeof(Smem)); }

// r, k, v, w, dout: (B, T, H, N) fp32 contiguous, 16-byte aligned; u: (H, N);
// s_seg: (B, H, ceil(T / (16 seg_chunks)), N, N), each segment's starting
// state as csrc/wkv_chunked.cu writes it; dstate: (B, H, N, N) or null for
// zeros; dr, dk, dv, dw: (B, T, H, N); dstate0: (B, H, N, N) or null;
// du_part: (B, H, N) scratch; du: (H, N); all fp32 contiguous. N = 64,
// seg_chunks 1-4. Two launches on `stream`; returns cudaGetLastError().
extern "C" int wkv_bwd(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* s_seg, const void* dout, const void* dstate,
                       void* dr, void* dk, void* dv, void* dw, void* dstate0, void* du_part,
                       void* du, int B, int T, int H, int n, int seg_chunks, void* stream) {
  if (n != N || seg_chunks < 1 || seg_chunks > MAX_SEG_CHUNKS || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int bytes = static_cast<int>(sizeof(Smem));
  cudaError_t err =
      cudaFuncSetAttribute(wkv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_kernel<<<dim3(H, B), THREADS, bytes, st>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s_seg), static_cast<const float*>(dout),
      static_cast<const float*>(dstate), static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dw), static_cast<float*>(dstate0),
      static_cast<float*>(du_part), T, H, seg_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hn = H * N;
  wkv_bwd_du_kernel<<<(hn + 255) / 256, 256, 0, st>>>(static_cast<const float*>(du_part),
                                                      static_cast<float*>(du), B, hn);
  return static_cast<int>(cudaGetLastError());
}
