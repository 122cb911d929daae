// One-query (decode) attention over a KV cache, for Hopper (sm_90a).
//
// Replaces repro/kernels/decode_attention/kernel.py::decode_attention_pallas.
// Computes, per (batch b, kv-head h, query head g of the group):
//   s_t = softcap(q_g . k_t / sqrt(D)) for t < lengths[b],
//   o_g = sum_t softmax(s)_t v_t,
// in fp32 whatever the input type. Keys at or past lengths[b] are not read.
//
// Bound on an H100: bytes. Each cached key and value row is read once and
// used for G query heads, about 2 operations per byte in bf16, far below the
// ~295 operations per byte at which the tensor cores would become the limit.
//
// Design (split-KV, "flash-decoding"). One block per (split, group chunk,
// kv-head, batch) walks its slice of [0, lengths[b]) with four warps; a warp
// takes UNROLL consecutive keys per step and issues all their loads before
// using any, each lane holding D/32 dimensions of a key and value row (a
// coalesced row read) and of the group's G query vectors, so all G heads of
// the group ride one pass over K/V, as in the TPU kernel. The UNROLL scores
// of a step are reduced across the warp side by side (independent shuffle
// chains) and folded into the warp's online softmax (m, l, acc) in one
// update. The warps' states are merged in shared memory into one partial per
// block; a second small kernel merges the splits. The split over
// the cache length puts B * Hkv * n_split blocks on the 132 SMs where B * Hkv
// alone (64 at 8 slots and 8 kv-heads) would leave half of them idle. The
// block loads lengths[b] itself, in place of the TPU kernel's scalar-prefetch
// SMEM operand, and its loop stops there, where the TPU kernel masks all of T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int UNROLL = 8;  // keys a warp loads before it uses them

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct KV {
  long long b, t, h;  // element strides of k and v (B, T, Hkv, D); D contiguous
};

// Partial results per (b, h, g, split): m, l and acc[D], fp32. GC query heads
// per block: 2 for groups of at most 2 heads and at D = 256 (whose 8 query
// and 8 sum registers a head would not leave room for 8 heads), else 8
// (larger groups take more blocks); a small GC leaves registers for more
// resident blocks.
template <typename T, int D, int GC>
__global__ void __launch_bounds__(WARPS * 32)
decode_partial(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ lengths, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_acc, int Hkv, int G,
               int n_gc, int n_split, int split_len, KV ks, KV vs, float softcap,
               float scale) {
  constexpr int DPL = D / 32;  // dimensions per lane
  __shared__ float sm_m[WARPS][GC], sm_l[WARPS][GC];
  __shared__ float sm_acc[WARPS][GC][D];

  const int split = blockIdx.x;
  const int hk = blockIdx.y / n_gc, g0 = (blockIdx.y % n_gc) * GC;
  const int b = blockIdx.z;
  const int ng = min(GC, G - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = lengths[b];
  const int t0 = split * split_len;
  const int t1 = min(len, t0 + split_len);

  float qr[GC][DPL], acc[GC][DPL], m[GC], l[GC];
  const T* qb = q + ((long long)(b * Hkv + hk) * G + g0) * D + lane * DPL;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      qr[g][e] = g < ng ? to_f(qb[g * D + e]) : 0.f;
      acc[g][e] = 0.f;
    }
  }

  const T* kb = k + b * ks.b + hk * ks.h + lane * DPL;
  const T* vb = v + b * vs.b + hk * vs.h + lane * DPL;
  for (int tb = t0 + warp * UNROLL; tb < t1; tb += WARPS * UNROLL) {
    float kx[UNROLL][DPL], vx[UNROLL][DPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = tb + u < t1 ? tb + u : tb;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        kx[u][e] = to_f(kb[t * ks.t + e]);
        vx[u][e] = to_f(vb[t * vs.t + e]);
      }
    }
    // per query head: the UNROLL scores reduced across the warp side by side
    // (independent shuffle chains), then one online-softmax update per step
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < ng) {
        float s[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          s[u] = 0.f;
#pragma unroll
          for (int e = 0; e < DPL; ++e) s[u] = fmaf(qr[g][e], kx[u][e], s[u]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
        float mt = NEG_INF;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          float sc = s[u] * scale;
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          s[u] = tb + u < t1 ? sc : NEG_INF;
          mt = fmaxf(mt, s[u]);
        }
        const float m_new = fmaxf(m[g], mt);
        const float corr = expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float p = s[u] > 0.5f * NEG_INF ? expf(s[u] - m_new) : 0.f;
          psum += p;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(p, vx[u][e], acc[g][e]);
        }
        l[g] = l[g] * corr + psum;
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < ng) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) sm_acc[warp][g][lane * DPL + e] = acc[g][e];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < ng * D; idx += WARPS * 32) {
    const int g = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = sm_m[w][g] > 0.5f * NEG_INF ? expf(sm_m[w][g] - mx) : 0.f;
      lsum = fmaf(sm_l[w][g], wt, lsum);
      a = fmaf(sm_acc[w][g][d], wt, a);
    }
    const long long p = ((long long)(b * Hkv + hk) * G + g0 + g) * n_split + split;
    part_acc[p * D + d] = a;
    if (d == 0) {
      part_m[p] = mx;
      part_l[p] = lsum;
    }
  }
}

// One block of D threads per (b, h, g) row merges the n_split partials.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out, int n_split) {
  const long long r = blockIdx.x;
  const int d = threadIdx.x;
  float mx = NEG_INF;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[r * n_split + s]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = part_m[r * n_split + s];
    const float wt = ms > 0.5f * NEG_INF ? expf(ms - mx) : 0.f;
    lsum = fmaf(part_l[r * n_split + s], wt, lsum);
    a = fmaf(part_acc[(r * n_split + s) * D + d], wt, a);
  }
  out[r * D + d] = from_f<T>(a / fmaxf(lsum, 1e-30f));
}

template <typename T, int D>
cudaError_t launch_d(cudaStream_t st, const void* q, const void* k, const void* v,
                     const int* lengths, float* part, void* out, int B, int Hkv, int G,
                     int n_split, int split_len, KV ks, KV vs, float softcap, float scale) {
  const long long rows = (long long)B * Hkv * G;
  float* part_m = part;
  float* part_l = part + rows * n_split;
  float* part_acc = part + 2 * rows * n_split;
  // GC = 8 is not instantiated at D = 256
  constexpr int GC_WIDE = D == 256 ? 2 : 8;
  if (G <= 2 || D == 256)
    decode_partial<T, D, 2><<<dim3(n_split, Hkv * ((G + 1) / 2), B), WARPS * 32, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, lengths, part_m, part_l, part_acc, Hkv, G,
        (G + 1) / 2, n_split, split_len, ks, vs, softcap, scale);
  else
    decode_partial<T, D, GC_WIDE><<<dim3(n_split, Hkv * ((G + 7) / 8), B), WARPS * 32, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, lengths, part_m, part_l, part_acc, Hkv, G,
        (G + 7) / 8, n_split, split_len, ks, vs, softcap, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T, D><<<(unsigned)rows, D, 0, st>>>(part_m, part_l, part_acc, (T*)out,
                                                     n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int D, cudaStream_t st, const void* q, const void* k, const void* v,
                   const int* lengths, float* part, void* out, int B, int Hkv, int G,
                   int n_split, int split_len, KV ks, KV vs, float softcap, float scale) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(st, q, k, v, lengths, part, out, B, Hkv, G, n_split, split_len,
                             ks, vs, softcap, scale);
    case 64:
      return launch_d<T, 64>(st, q, k, v, lengths, part, out, B, Hkv, G, n_split, split_len,
                             ks, vs, softcap, scale);
    case 128:
      return launch_d<T, 128>(st, q, k, v, lengths, part, out, B, Hkv, G, n_split,
                              split_len, ks, vs, softcap, scale);
    case 256:
      return launch_d<T, 256>(st, q, k, v, lengths, part, out, B, Hkv, G, n_split,
                              split_len, ks, vs, softcap, scale);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hkv, G, D) contiguous; k/v (B, T, Hkv, D) with element strides
// (batch, time, head) and a contiguous last axis; lengths (B,) int32;
// part: fp32 scratch of B*Hkv*G*n_split*(D+2) values; out (B, Hkv, G, D)
// contiguous. Keys [s*split_len, (s+1)*split_len) form split s.
// is_bf16: 1 for bfloat16 tensors, 0 for float32. Returns cudaGetLastError().
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* lengths, void* part, void* out, int is_bf16,
                                    int B, int Hkv, int G, int D, int n_split, int split_len,
                                    long long ksb, long long kst, long long ksh,
                                    long long vsb, long long vst, long long vsh,
                                    float softcap, float scale, void* stream) {
  const KV ks{ksb, kst, ksh}, vs{vsb, vst, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* p = static_cast<float*>(part);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(D, st, q, k, v, lens, p, out, B, Hkv, G, n_split,
                                      split_len, ks, vs, softcap, scale)
              : launch<float>(D, st, q, k, v, lens, p, out, B, Hkv, G, n_split, split_len, ks,
                              vs, softcap, scale);
  return static_cast<int>(err);
}
