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
// Design: one block per (b, h), 512 threads, owning the segment's chunk
// states and D whole in shared memory (135 KB: one block an SM); every
// sum runs in a fixed order, so the same inputs give the same bits. Per
// chunk, between barriers: the inputs by 16-byte loads; the log decays,
// rowsum(D S), M, sd and dvv, a thread an element; the decays' sums, a
// thread a channel, in order; KD and RQ, then a thread per (t, i) for dr,
// dk, dw and its channel's share of the scores A[t][q], which a butterfly
// sums over the warp's 32 channels (t is the same across a warp, so the
// loops over the chunk's steps run unrolled and alike); a thread per
// (t, j) for dv; then D. du: each (b, h)'s share in a thread per channel,
// summed over b in order by a second launch (no atomics), as a resumed
// train step needs.
//
// Bound on an H100: at (8, 512, 64, 64) it reads r, k, v, w and do and
// writes dr, dk, dv and dw (36 bytes a (b, t, h, i)) and reads s_seg: 671
// MB, 0.20 ms at 3.35 TB/s; about 10 N^2 fp32 operations a (b, t, h), 0.16
// ms at 67 TFLOP/s. It takes 2.82 ms there on an H100 SXM at 700 W (7.1%):
// every product reads both operands from shared memory, about 32 K warp
// loads a chunk over both sweeps, at one a cycle the time it takes.
// Register tiles would cut those loads (ROADMAP B31).

#include <cuda_runtime.h>

namespace {

constexpr int N = 64;                // head size
constexpr int L = 16;                // steps a chunk
constexpr int THREADS = 512;
constexpr int MAX_SEG_CHUNKS = 4;    // chunk states a block keeps
constexpr int NP = N + 1;            // a state row, padded: rows i and i + 1 in other banks
constexpr int P = N + 4;             // a row of a chunk's tile, padded to 16 bytes
constexpr int LP = L + 1;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LOG2_W_MIN = -60.f * LOG2E;

struct Smem {
  float st[MAX_SEG_CHUNKS][N * NP];  // each chunk's starting state in the segment
  float d[N * NP];                   // the gradient of the current chunk's final state
  float r[L * P], k[L * P], v[L * P], w[L * P], dout[L * P];
  float lw[L * P];                   // log2 w, clamped; 0 past T
  float pre[L * P], post[L * P];     // sums of lw before and after each step
  float kd[L * P], rq[L * P];        // k 2^post, r 2^pre
  float sd[L * P], dvv[L * P];       // S do_t, D v_t
  float m[L * LP];                   // do_t . v_s
  float ah[2][L * LP];               // the scores, summed over channels 0-31 and 32-63
  float u[N], etot[N], p0[N];        // the bonus; 2^(sum lw); rowsum(D * S)
};

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

// rows t0 .. t0 + L - 1 of an input at `src` (element (b, 0, h, 0), `row`
// elements a step) into a tile, `fill` past T
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row, int t0,
                                          int T, float fill) {
  for (int idx = threadIdx.x; idx < L * N / 4; idx += THREADS) {
    const int s = idx / (N / 4), c4 = idx % (N / 4), t = t0 + s;
    float4 x = make_float4(fill, fill, fill, fill);
    if (t < T) x = __ldg(reinterpret_cast<const float4*>(src + t * row) + c4);
    *reinterpret_cast<float4*>(dst + s * P + 4 * c4) = x;
  }
}

// a (step, channel) a thread: the chunk's log decays, clamped, 0 past T
__device__ __forceinline__ void log_decays(Smem& sm, int t0, int T) {
  for (int e = threadIdx.x; e < L * N; e += THREADS) {
    const int s = e / N, o = s * P + e % N;
    sm.lw[o] = t0 + s < T ? fmaxf(log2_decay(sm.w[o]), LOG2_W_MIN) : 0.f;
  }
}

// threads 0 .. N - 1, a channel each: the sums of lw before and after each
// step, in order, and 2^(their total)
__device__ __forceinline__ void decay_sums(Smem& sm) {
  const int i = threadIdx.x;
  if (i >= N) return;
  float run = 0.f;
  for (int s = 0; s < L; ++s) {
    sm.pre[s * P + i] = run;
    run += sm.lw[s * P + i];
  }
  sm.etot[i] = exp2f(run);
  run = 0.f;
  for (int s = L - 1; s >= 0; --s) {
    sm.post[s * P + i] = run;
    run += sm.lw[s * P + i];
  }
}

// a (step, channel) a thread: KD = k 2^post and (with_r) RQ = r 2^pre
__device__ __forceinline__ void factors(Smem& sm, bool with_r) {
  for (int e = threadIdx.x; e < L * N; e += THREADS) {
    const int o = (e / N) * P + e % N;
    sm.kd[o] = sm.k[o] * exp2f(sm.post[o]);
    if (with_r) sm.rq[o] = sm.r[o] * exp2f(sm.pre[o]);
  }
}

// One level of a butterfly over lanes OFF apart: each lane keeps half of
// its 2 HALF values (the upper half where its lane bit OFF is set), summed
// with its partner's (csrc/wkv_chunked.cu's)
template <int HALF, int OFF>
__device__ __forceinline__ void butterfly_level(float (&a)[L], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int q = 0; q < HALF; ++q) {
    const float lo = a[q], hi = a[q + HALF];
    a[q] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, OFF);
  }
}

// The sum of 16 values over a warp's 32 lanes: lane g and g + 16 keep the
// sum of value g % 16 in a[0], in one order, so run to run the same bits
__device__ __forceinline__ void warp_sum16(float (&a)[L], int lane) {
  butterfly_level<8, 8>(a, lane);
  butterfly_level<4, 4>(a, lane);
  butterfly_level<2, 2>(a, lane);
  butterfly_level<1, 1>(a, lane);
  a[0] += __shfl_xor_sync(0xffffffffu, a[0], 16);
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
  const long long bh = static_cast<long long>(b) * H + h;
  const long long row = static_cast<long long>(H) * N;
  const long long base = static_cast<long long>(b) * T * row + static_cast<long long>(h) * N;
  const int n_chunks = (T + L - 1) / L;
  const int n_seg = (n_chunks + seg_chunks - 1) / seg_chunks;
  const float *rb = r + base, *kb = k + base, *vb = v + base, *wb = w + base,
              *ob = dout + base;

  for (int e = tid; e < N * N; e += THREADS)
    sm.d[(e / N) * NP + e % N] = dstate != nullptr ? dstate[bh * N * N + e] : 0.f;
  if (tid < N) sm.u[tid] = u[h * N + tid];
  float du_acc = 0.f;  // threads 0 .. N - 1: their channel's share of du

  for (int g = n_seg - 1; g >= 0; --g) {
    const int c_first = g * seg_chunks, nc = min(seg_chunks, n_chunks - c_first);
    __syncthreads();  // the previous segment is done with the states
    const float* seg = s_seg + (bh * n_seg + g) * N * N;
    for (int e = tid; e < N * N; e += THREADS) sm.st[0][(e / N) * NP + e % N] = seg[e];
    // the starting state of each later chunk of the segment
    for (int c = 0; c + 1 < nc; ++c) {
      const int t0 = (c_first + c) * L;
      __syncthreads();
      load_tile(sm.k, kb, row, t0, T, 0.f);
      load_tile(sm.v, vb, row, t0, T, 0.f);
      load_tile(sm.w, wb, row, t0, T, 1.f);
      __syncthreads();
      log_decays(sm, t0, T);
      __syncthreads();
      decay_sums(sm);
      __syncthreads();
      factors(sm, false);
      __syncthreads();
      for (int e = tid; e < N * N; e += THREADS) {
        const int i = e / N, j = e % N;
        float acc = sm.etot[i] * sm.st[c][i * NP + j];
#pragma unroll
        for (int s = 0; s < L; ++s) acc = fmaf(sm.kd[s * P + i], sm.v[s * P + j], acc);
        sm.st[c + 1][i * NP + j] = acc;
      }
    }
    // the segment's chunks from the last
    for (int c = nc - 1; c >= 0; --c) {
      const int t0 = (c_first + c) * L;
      const float* const S = sm.st[c];
      __syncthreads();
      load_tile(sm.r, rb, row, t0, T, 0.f);
      load_tile(sm.k, kb, row, t0, T, 0.f);
      load_tile(sm.v, vb, row, t0, T, 0.f);
      load_tile(sm.w, wb, row, t0, T, 1.f);
      load_tile(sm.dout, ob, row, t0, T, 0.f);
      __syncthreads();

      // 1. the log decays; rowsum(D * S) (threads 0-63), M (256-511); sd
      //    and dvv, a (step, row) each
      log_decays(sm, t0, T);
      if (tid < N) {
        float acc = 0.f;
        for (int j = 0; j < N; ++j) acc = fmaf(sm.d[tid * NP + j], S[tid * NP + j], acc);
        sm.p0[tid] = acc;
      }
      if (tid >= THREADS - L * L) {
        const int p = tid - (THREADS - L * L), t = p / L, s = p % L;
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < N; ++j) acc = fmaf(sm.dout[t * P + j], sm.v[s * P + j], acc);
        sm.m[t * LP + s] = acc;
      }
      for (int item = tid; item < 2 * L * N; item += THREADS) {
        const bool of_d = item >= L * N;
        const int it = of_d ? item - L * N : item, t = it / N, i = it % N;
        const float* x = of_d ? sm.v + t * P : sm.dout + t * P;
        const float* y = (of_d ? sm.d : S) + i * NP;
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < N; ++j) acc = fmaf(y[j], x[j], acc);
        (of_d ? sm.dvv : sm.sd)[t * P + i] = acc;
      }
      __syncthreads();
      decay_sums(sm);
      __syncthreads();

      // 2. KD and RQ; then dr, dk, dw and the scores' halves, a (step t,
      //    channel i) each: t is the same across a warp, so the loops over
      //    the chunk's steps run unrolled and alike, and a warp's 32
      //    channels sum each score A[t][q] by a butterfly
      factors(sm, true);
      for (int item = tid; item < L * N; item += THREADS) {
        const int t = item / N, i = item % N, o = t * P + i;
        const float ri = sm.r[o], ki = sm.k[o], ui = sm.u[i];
        float acc[L];  // acc[s] = sum_{q<t} E[t][q] k_q M[s][q], for s > t
        float sc[L];   // this channel's share of the scores A[t][q], q <= t
#pragma unroll
        for (int s = 0; s < L; ++s) acc[s] = 0.f;
        float drs = 0.f, dw_k = 0.f, gap = 0.f;
#pragma unroll
        for (int q = L - 1; q >= 0; --q) {
          if (q < t) {
            const float ek = exp2f(gap) * sm.k[q * P + i];
            drs = fmaf(ek, sm.m[t * LP + q], drs);
            dw_k = fmaf(ek, sm.dvv[q * P + i], dw_k);
#pragma unroll
            for (int s = 0; s < L; ++s)
              if (s > t) acc[s] = fmaf(ek, sm.m[s * LP + q], acc[s]);
            sc[q] = ri * ek;
            gap += sm.lw[q * P + i];
          } else {
            sc[q] = q == t ? ri * ui * ki : 0.f;
          }
        }
        float dkd = 0.f, dw_r = 0.f, dw_rk = 0.f;
        gap = 0.f;
#pragma unroll
        for (int s = 0; s < L; ++s) {
          if (s > t) {
            const float er = exp2f(gap) * sm.r[s * P + i];
            dkd = fmaf(er, sm.m[s * LP + t], dkd);
            dw_r = fmaf(er, sm.sd[s * P + i], dw_r);
            dw_rk = fmaf(er, acc[s], dw_rk);
            gap += sm.lw[s * P + i];
          }
        }
        const int lane = tid & 31;
        warp_sum16(sc, lane);
        if (lane < L) sm.ah[i / 32][t * LP + lane] = sc[0];
        const float e_pre = exp2f(sm.pre[o]), e_post = exp2f(sm.post[o]);
        drs = fmaf(e_pre, sm.sd[o], drs);
        dkd = fmaf(e_post, sm.dvv[o], dkd);
        const float dwt = exp2f(sm.pre[o] + sm.post[o]) * sm.p0[i] + e_post * dw_k +
                          e_pre * dw_r + dw_rk;
        if (t0 + t < T) {
          const float mtt = sm.m[t * LP + t], wt = sm.w[o];
          const long long off = (t0 + t) * row + i;
          dr[base + off] = fmaf(ui * ki, mtt, drs);
          dk[base + off] = fmaf(ui * ri, mtt, dkd);
          dw[base + off] = log2_decay(wt) < LOG2_W_MIN ? 0.f : dwt;
        }
      }
      __syncthreads();

      // 3. dv a (step t, column j) each, with A[s][t] the sum of its two
      //    halves; du's share
      for (int item = tid; item < L * N; item += THREADS) {
        const int t = item / N, j = item % N;
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < N; ++i) acc = fmaf(sm.kd[t * P + i], sm.d[i * NP + j], acc);
#pragma unroll
        for (int s = 0; s < L; ++s)
          if (s >= t)
            acc = fmaf(sm.ah[0][s * LP + t] + sm.ah[1][s * LP + t], sm.dout[s * P + j], acc);
        if (t0 + t < T) dv[base + (t0 + t) * row + j] = acc;
      }
      if (tid < N) {
#pragma unroll
        for (int t = L - 1; t >= 0; --t)
          du_acc = fmaf(sm.r[t * P + tid] * sm.k[t * P + tid], sm.m[t * LP + t], du_acc);
      }
      __syncthreads();

      // 4. D at the chunk's start
      for (int e = tid; e < N * N; e += THREADS) {
        const int i = e / N, j = e % N;
        float acc = sm.etot[i] * sm.d[i * NP + j];
#pragma unroll
        for (int s = 0; s < L; ++s) acc = fmaf(sm.rq[s * P + i], sm.dout[s * P + j], acc);
        sm.d[i * NP + j] = acc;
      }
    }
  }
  __syncthreads();
  if (dstate0 != nullptr)
    for (int e = tid; e < N * N; e += THREADS) dstate0[bh * N * N + e] = sm.d[(e / N) * NP + e % N];
  if (tid < N) du_part[bh * N + tid] = du_acc;
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
