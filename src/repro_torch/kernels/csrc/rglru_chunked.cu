// RG-LRU scan of Griffin (recurrentgemma) as a chunked scan over T, for
// Hopper (sm_90a).
//
// A kernel the port adds: the JAX package computes this recurrence in XLA,
// with lax.associative_scan in repro/models/recurrent.py::rglru_apply (:206;
// :211 is the decode step). This kernel takes every call with T > 1 (the
// prefill); the decode step (T = 1) stays on csrc/rglru.cu, where one launch
// of B d threads, each one step, is launch-bound and nothing chunked helps.
// Contract and arithmetic are rglru.cu's: per (batch b, channel c), for
// t < lengths[b]
//   r = sigmoid(ga_t), i = sigmoid(gx_t), log a = -8 r softplus(lam),
//   h_t = a h_{t-1} + sqrt(max(1 - a^2, 1e-12)) i u_t,
// from h_{-1} = h0 (or 0), and y_t = gate_t h_t, all in fp32; steps at or
// past lengths[b] leave h as it is (y there is gate * that h); h_out gets h
// after the last real step and may be h0 itself.
//
// Bound on an H100: bytes. A live element reads 12 bytes (u and the gate 2
// each, ga and gx 4 each), every element writes y (4), for about 20 fp32
// operations and four exponentials: 0.035 ms at the served wave (8, 436,
// 2560), 0.0055 ms at a batch-1 refill (1, 452, 2560) and 0.028 ms at the
// ring phase's prefill (1, 2304, 2560), at 3.35 TB/s.
//
// What held rglru.cu back: one thread per (b, c) walks all T steps, so the
// time is T times the latency of one step, 0.545 us at the wave and 0.500 us
// at a refill (chip_smoke.py, H100 80GB HBM3 at 700 W): the same per step
// with 8 times the data, a serial chain and not bytes. A refill launched 40
// blocks of 64 threads on 132 SMs.
//
// The chunked form. The recurrence is linear, h_t = a_t h_{t-1} + b_t, and a
// and b depend on the inputs alone. Cut each (b, c) chain into segments of L
// steps. A segment's summary is (P, hl): P = exp(sum of its log a), hl its
// scan from zero. Summaries combine by (P1, h1) o (P2, h2) = (P1 P2,
// h1 P2 + h2), recurrent.py:201-204's combine, so folding them in order from
// the carried h gives the h that enters each segment, h_in, from which the
// segment's steps run again. Pad steps (at or past lengths[b]) are identity
// steps: log a = 0, b = 0.
//
// Design.
//  * A block owns CT = 16 channels of one sequence across all of T, and
//    walks T in tiles of 16 segments (16 L steps) with h carried in
//    registers. The grid is (d / 16, B): 160 blocks at a batch-1 refill,
//    1280 at the wave. 16 channels make a row of 64 bytes of ga and gx and
//    32 of u and the gate: whole 32-byte sectors; 32 channels would make
//    80 blocks at a refill and leave 52 SMs idle.
//  * 256 threads: thread (s, c) = (tid / 16, tid % 16) takes segment s of
//    channel c. It computes its L steps' gates, keeps a_t, b_t and the gate
//    in registers and writes its summary to shared memory; after one
//    barrier every thread folds the tile's 16 summaries in order from the
//    carried h, keeping its own h_in and, at the end, the h that leaves the
//    tile (the 16 threads of a channel all reach it, so the next tile needs
//    no broadcast). Then it runs its steps again from h_in, h = a h + b,
//    and writes y = gate h: each input is read from device memory once and
//    y written once.
//  * L = 4 (tiles of 64 steps) for the wave and the refills, L = 8 (128)
//    for long calls (kernels/rglru/kernel.py::segment_steps): the shorter
//    tile wastes less past each sequence's last step and its 32 KB of
//    shared memory let four blocks share an SM; the longer one halves the
//    barriers and the fold per step.
//  * The inputs come in by cp.async, 16 bytes a copy, a tile ahead into
//    STAGES = 2 buffers (zero-filled past lengths[b] for u, ga and gx, whose
//    steps are pads; past T for the gate). Each thread's copies sit at the
//    same places in every tile, so their offsets are computed once. A
//    segment's rows are padded by one row of 16 elements: the two segments
//    a warp reads lie 16 banks apart (fp32) or 8 (bf16). A segment wholly
//    past lengths[b] skips its gates.
//  * Numerics: P is exp of a direct sum of log a, so a run of strong decays
//    underflows cleanly to 0, never a product of many small factors; within
//    a segment the steps are rglru.cu's own arithmetic. The gates are
//    computed exactly as rglru.cu computes them (expf, sqrtf and a
//    division; no fast-math intrinsics).
//  * What bounds it (chip_smoke.py, H100 80GB HBM3 at 700 W): instruction
//    issue, not bytes. The precise gates (four expf, two divisions, a
//    sqrtf) are most of a step's instructions, the fold and the copies most
//    of the rest; the wave reaches about 57% of its bound. A refill puts
//    two blocks (32 channels) on 28 of the 132 SMs, and its time is theirs.
// kernels/rglru/ref.py::rglru_chunked_ref is this arithmetic in PyTorch,
// with chunk = L.
//
// Training: given h_seg, each thread also writes the h_in of its segment
// there, (B, nseg, d) fp32 with nseg the tiles times SEGS: the state the
// backward (csrc/rglru_bwd.cu) runs each segment's steps again from. One
// store a segment (1/L of a step's bytes); serving passes none.
//
// Inputs: d a multiple of 8 and every base 16-byte aligned, so that each
// row of a channel tile splits into whole 16-byte copies
// (kernels/rglru/kernel.py::chunked_eligible).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CT = 16;              // channels a block
constexpr int SEGS = 16;            // segments a tile
constexpr int THREADS = SEGS * CT;  // a thread a segment of a channel
constexpr int STAGES = 2;  // tiles of inputs in shared memory: one loads while one is used
constexpr float RGLRU_C = 8.f;

// L steps a segment
template <int L>
struct Layout {
  static_assert(L % 4 == 0, "whole 16-byte copies");
  static constexpr int TT = SEGS * L;       // steps of a tile
  static constexpr int SEG = (L + 1) * CT;  // a segment's elements, padded by one row
  static constexpr int TILE = SEGS * SEG;   // elements of one input in one tile
  static constexpr int STAGE = TILE * (4 + 4 + 2 + 2);  // ga, gx fp32; u, gate bf16
  static constexpr int SUMMARY = SEGS * CT * 8;         // [SEGS][CT] (P, hl)
  static constexpr int BYTES = STAGES * STAGE + SUMMARY;
  static constexpr int F32 = TT * CT / 4;   // 16-byte copies of a tile of ga (and of gx)
  static constexpr int BF16 = TT * CT / 8;  // of u (and of the gate)
  static constexpr int F32_EACH = (F32 + THREADS - 1) / THREADS;
  static constexpr int BF16_EACH = (BF16 + THREADS - 1) / THREADS;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
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

// One thread's 16-byte copy of a tile, in the same slot of every tile: its
// row in the tile (-1: no copy, past the tile's copies or d's channels), its
// element offset from the tile's first row and its offset in the stage
struct Copy {
  int row, src, dst;
};

template <int L>
__global__ void __launch_bounds__(THREADS)
rglru_chunked_kernel(const __nv_bfloat16* __restrict__ u, const float* __restrict__ ga,
                     const float* __restrict__ gx, const float* __restrict__ lam,
                     const __nv_bfloat16* __restrict__ gate, const float* h0,
                     const int* __restrict__ lengths, float* __restrict__ y, float* h_out,
                     float* __restrict__ h_seg, int T, int d) {
  using Lo = Layout<L>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y, c0 = blockIdx.x * CT;
  const int c = threadIdx.x % CT, s = threadIdx.x / CT;
  const int cg = c0 + c;
  const bool cv = cg < d;
  const int len = lengths != nullptr ? min(max(lengths[b], 0), T) : T;
  const int tiles = (T + Lo::TT - 1) / Lo::TT;
  const long long row0 = static_cast<long long>(b) * T;

  Copy f32[Lo::F32_EACH], b16[Lo::BF16_EACH];
#pragma unroll
  for (int i = 0; i < Lo::F32_EACH; ++i) {
    const int idx = threadIdx.x + i * THREADS, r = idx / (CT / 4), q = idx % (CT / 4);
    const bool ok = idx < Lo::F32 && c0 + 4 * q < d;
    f32[i] = {ok ? r : -1, r * d + c0 + 4 * q, (r / L) * Lo::SEG + (r % L) * CT + 4 * q};
  }
#pragma unroll
  for (int i = 0; i < Lo::BF16_EACH; ++i) {
    const int idx = threadIdx.x + i * THREADS, r = idx / (CT / 8), q = idx % (CT / 8);
    const bool ok = idx < Lo::BF16 && c0 + 8 * q < d;
    b16[i] = {ok ? r : -1, r * d + c0 + 8 * q, (r / L) * Lo::SEG + (r % L) * CT + 8 * q};
  }

  // tile `tile`'s inputs into stage tile % STAGES, one commit group: u, ga
  // and gx zero-filled at or past lengths[b] (pad steps), the gate past T
  auto issue = [&](int tile) {
    unsigned char* st = smem + (tile % STAGES) * Lo::STAGE;
    float* sga = reinterpret_cast<float*>(st);
    float* sgx = sga + Lo::TILE;
    __nv_bfloat16* su = reinterpret_cast<__nv_bfloat16*>(sgx + Lo::TILE);
    __nv_bfloat16* sg = su + Lo::TILE;
    const int t0 = tile * Lo::TT;
    const long long e0 = (row0 + t0) * d;
#pragma unroll
    for (int i = 0; i < Lo::F32_EACH; ++i) {
      if (f32[i].row < 0) continue;
      const bool live = t0 + f32[i].row < len;
      const long long e = live ? e0 + f32[i].src : 0;
      cp_async16(sga + f32[i].dst, ga + e, live);
      cp_async16(sgx + f32[i].dst, gx + e, live);
    }
#pragma unroll
    for (int i = 0; i < Lo::BF16_EACH; ++i) {
      if (b16[i].row < 0) continue;
      const bool inside = t0 + b16[i].row < T;
      const long long e = inside ? e0 + b16[i].src : 0;
      cp_async16(su + b16[i].dst, u + e, inside && t0 + b16[i].row < len);
      cp_async16(sg + b16[i].dst, gate + e, inside);
    }
    cp_async_commit();
  };

  const float l = cv ? lam[cg] : 0.f;
  const float k = -RGLRU_C * (log1pf(expf(-fabsf(l))) + fmaxf(l, 0.f));  // -8 softplus(lam)
  // read before anything is written: h_out may be h0 (in place)
  float h = h0 != nullptr && cv ? h0[static_cast<long long>(b) * d + cg] : 0.f;
  float2* summary = reinterpret_cast<float2*>(smem + STAGES * Lo::STAGE);

  issue(0);
  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait_all();  // this thread's copies of `tile` have landed
    __syncthreads();      // everyone's, and the other stage is no longer read
    if (tile + 1 < tiles) issue(tile + 1);

    const unsigned char* st = smem + (tile % STAGES) * Lo::STAGE;
    const float* sga = reinterpret_cast<const float*>(st);
    const float* sgx = sga + Lo::TILE;
    const __nv_bfloat16* su = reinterpret_cast<const __nv_bfloat16*>(sgx + Lo::TILE);
    const __nv_bfloat16* sg = su + Lo::TILE;
    const int ts = tile * Lo::TT + s * L;  // this segment's first step
    float a[L], bs[L], g[L];              // a_t, b_t and the gate of each step
    float sum = 0.f, hl = 0.f;            // log P and hl at the segment's end
    if (ts < len) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int o = s * Lo::SEG + j * CT + c;
        const bool live = ts + j < len;
        const float la = k * sigmoid(sga[o]);
        const float bt = sqrtf(fmaxf(1.f - expf(2.f * la), 1e-12f)) *
                         (sigmoid(sgx[o]) * __bfloat162float(su[o]));
        const float log_a = live ? la : 0.f;  // a pad is an identity step
        a[j] = expf(log_a);
        bs[j] = live ? bt : 0.f;
        hl = fmaf(a[j], hl, bs[j]);
        sum += log_a;
      }
    } else {  // a segment of pads
#pragma unroll
      for (int j = 0; j < L; ++j) {
        a[j] = 1.f;
        bs[j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) g[j] = __bfloat162float(sg[s * Lo::SEG + j * CT + c]);
    summary[s * CT + c] = make_float2(expf(sum), hl);
    __syncthreads();

    // fold the tile's segments in order: h_in of this segment, then the
    // carry out of the tile
    float h_in = h;
#pragma unroll
    for (int s2 = 0; s2 < SEGS; ++s2) {
      if (s2 == s) h_in = h;
      const float2 ph = summary[s2 * CT + c];
      h = fmaf(ph.x, h, ph.y);
    }
    if (h_seg != nullptr && cv)
      h_seg[(static_cast<long long>(b) * tiles * SEGS + tile * SEGS + s) * d + cg] = h_in;
    // the fix-up: the segment's steps again from h_in, on the a and b kept
    float* yp = y + (row0 + ts) * d + cg;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      h_in = fmaf(a[j], h_in, bs[j]);
      if (cv && ts + j < T) yp[static_cast<long long>(j) * d] = g[j] * h_in;
    }
  }
  if (s == 0 && cv) h_out[static_cast<long long>(b) * d + cg] = h;
}

template <int L>
cudaError_t launch(cudaStream_t stream, const __nv_bfloat16* u, const float* ga,
                   const float* gx, const float* lam, const __nv_bfloat16* gate,
                   const float* h0, const int* lengths, float* y, float* h_out, float* h_seg,
                   int B, int T, int d) {
  constexpr int bytes = Layout<L>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(rglru_chunked_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  rglru_chunked_kernel<L><<<dim3((d + CT - 1) / CT, B), THREADS, bytes, stream>>>(
      u, ga, gx, lam, gate, h0, lengths, y, h_out, h_seg, T, d);
  return cudaGetLastError();
}

}  // namespace

// The shared memory of one block at L steps a segment, in bytes (for the
// build log); -1 for an L the kernel is not built for.
extern "C" int rglru_chunked_smem(int L) {
  switch (L) {
    case 4: return Layout<4>::BYTES;
    case 8: return Layout<8>::BYTES;
    default: return -1;
  }
}

// u, gate: (B, T, d) bf16; ga, gx: (B, T, d) fp32; lam: (d,) fp32; h0: (B, d)
// fp32 or null (zeros); lengths: (B,) int32 or null (T everywhere); y:
// (B, T, d) fp32; h_out: (B, d) fp32, which may be h0; h_seg: null, or
// (B, ceil(T / (16 L)) 16, d) fp32 for each segment's h_in. All contiguous,
// d a multiple of 8, u, ga, gx and gate 16-byte aligned. L: steps a
// segment, 4 or 8. Returns cudaGetLastError().
extern "C" int rglru_chunked_fwd(const void* u, const void* ga, const void* gx,
                                 const void* lam, const void* gate, const void* h0,
                                 const void* lengths, void* y, void* h_out, void* h_seg,
                                 int B, int T, int d, int L, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* fu = static_cast<const __nv_bfloat16*>(u);
  const auto* fg = static_cast<const __nv_bfloat16*>(gate);
  const auto* fa = static_cast<const float*>(ga);
  const auto* fx = static_cast<const float*>(gx);
  const auto* fl = static_cast<const float*>(lam);
  const auto* fh = static_cast<const float*>(h0);
  const auto* lens = static_cast<const int*>(lengths);
  auto* fy = static_cast<float*>(y);
  auto* fo = static_cast<float*>(h_out);
  auto* fs = static_cast<float*>(h_seg);
  switch (L) {
    case 4:
      return static_cast<int>(launch<4>(st, fu, fa, fx, fl, fg, fh, lens, fy, fo, fs, B, T, d));
    case 8:
      return static_cast<int>(launch<8>(st, fu, fa, fx, fl, fg, fh, lens, fy, fo, fs, B, T, d));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
