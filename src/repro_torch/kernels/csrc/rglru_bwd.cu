// Backward of the RG-LRU scan of Griffin (recurrentgemma) for Hopper
// (sm_90a): the gradients of csrc/rglru_chunked.cu's forward, as a chunked
// scan over T run from the end.
//
// Replaces no TPU kernel: the JAX package differentiates its RG-LRU
// (repro/models/recurrent.py::_rglru_gates and the lax.associative_scan of
// rglru_apply, :206) in XLA. It is the gradient of the port's forward
// (kernels/rglru/ref.py::rglru_bwd_ref is this arithmetic in PyTorch), per
// (batch b, channel c), with r, i, log a, a, e = exp(2 log a),
// sq = sqrt(max(1 - e, 1e-12)) and b = sq i u the forward's, g = dy gate:
//   dh_t   = g_t + a_{t+1} dh_{t+1}, from the end (dh_last at the last step);
//   dla_t  = dh_t h_{t-1} a_t + dh_t i u (-e / sq), the second term 0 where
//            the clamp holds (1 - e <= 1e-12: JAX's maximum passes nothing);
//   dga    = dla (-8 softplus(lam)) r (1 - r),  dgx = dh sq u i (1 - i),
//   du     = dh sq i,  dgate = dy h_t,  dh0 = a_0 dh_0,
//   dlam   = sigmoid(lam) sum over b and t of dla (-8 r).
// No lengths: a train step runs whole sequences (the wrapper refuses them).
//
// The reverse recurrence is the forward's linear scan run from the end with
// the carry x_t = a_t dh_t passed to the left: dh_t = g_t + x_{t+1}. A
// segment of L steps is summarised by (P, cl): P = exp(sum of its log a),
// cl its carry out from a zero carry in; summaries fold from the right,
// C = P C + cl, giving the carry that enters each segment, from which its
// steps run again. The forward (given h_seg) wrote each segment's h_in, so
// h_{t-1} is rebuilt inside the segment with the forward's own arithmetic
// (the same bits), and nothing of size T is kept but those states (1/L of
// a step's fp32 state).
//
// Design, the forward's mirrored: a block owns CT = 16 channels of one
// sequence, 256 threads, thread (s, c) segment s of channel c of a tile of
// 16 segments; tiles from the last to the first, the inputs (ga, gx, dy
// fp32, u and the gate bf16) by cp.async a tile ahead into two stages.
// Each thread computes its steps' gates and h once, keeps a, r, i, e, h and
// g in registers, writes its summary, and after one barrier folds the
// tile's 16 summaries from the right; then it runs its steps again from the
// carry in, writing du, dga, dgx and dgate a step at a time. dlam: each
// thread sums dla r over its steps, in order; the 16 threads of a channel
// add theirs in segment order into a (B, d) partial row, and a second
// launch sums the B rows in batch order: no atomics, the same bits run to
// run, as a resumed train step needs.
//
// Bound on an H100: bytes. A step reads u and the gate (2 bytes each), ga,
// gx and dy (4 each), writes du and dgate (2 each) and dga and dgx (4 each):
// 28 bytes, plus 4 / L of h_seg. At recurrentgemma's train shape
// (8, 512, 2560) that is 294 MB (L = 4: 10.5 MB of it h_seg), 0.088 ms at
// 3.35 TB/s. The precise gates (expf, divisions, sqrtf, as the forward
// computes them) make it issue-heavy, as the forward is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CT = 16;              // channels a block
constexpr int SEGS = 16;            // segments a tile
constexpr int THREADS = SEGS * CT;  // a thread a segment of a channel
constexpr int STAGES = 2;
constexpr float RGLRU_C = 8.f;

template <int L>
struct Layout {
  static_assert(L % 4 == 0, "whole 16-byte copies");
  static constexpr int TT = SEGS * L;
  static constexpr int SEG = (L + 1) * CT;  // a segment's elements, padded by one row
  static constexpr int TILE = SEGS * SEG;
  static constexpr int STAGE = TILE * (4 + 4 + 4 + 2 + 2);  // ga, gx, dy fp32; u, gate bf16
  static constexpr int SUMMARY = SEGS * CT * 8;              // [SEGS][CT] (P, cl)
  static constexpr int BYTES = STAGES * STAGE + SUMMARY;
  static constexpr int F32 = TT * CT / 4;
  static constexpr int BF16 = TT * CT / 8;
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

struct Copy {
  int row, src, dst;
};

template <int L>
__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const __nv_bfloat16* __restrict__ u, const float* __restrict__ ga,
                 const float* __restrict__ gx, const float* __restrict__ lam,
                 const __nv_bfloat16* __restrict__ gate, const float* __restrict__ h_seg,
                 const float* __restrict__ dy, const float* __restrict__ dh_last,
                 __nv_bfloat16* __restrict__ du, float* __restrict__ dga,
                 float* __restrict__ dgx, __nv_bfloat16* __restrict__ dgate,
                 float* __restrict__ dh0, float* __restrict__ dlam_part, int T, int d) {
  using Lo = Layout<L>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y, c0 = blockIdx.x * CT;
  const int c = threadIdx.x % CT, s = threadIdx.x / CT;
  const int cg = c0 + c;
  const bool cv = cg < d;
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

  // tile `tile`'s inputs into stage `st`, one commit group; zeros past T
  auto issue = [&](int tile, int st) {
    unsigned char* base = smem + st * Lo::STAGE;
    float* sga = reinterpret_cast<float*>(base);
    float* sgx = sga + Lo::TILE;
    float* sdy = sgx + Lo::TILE;
    __nv_bfloat16* su = reinterpret_cast<__nv_bfloat16*>(sdy + Lo::TILE);
    __nv_bfloat16* sg = su + Lo::TILE;
    const int t0 = tile * Lo::TT;
    const long long e0 = (row0 + t0) * d;
#pragma unroll
    for (int i = 0; i < Lo::F32_EACH; ++i) {
      if (f32[i].row < 0) continue;
      const bool live = t0 + f32[i].row < T;
      const long long e = live ? e0 + f32[i].src : 0;
      cp_async16(sga + f32[i].dst, ga + e, live);
      cp_async16(sgx + f32[i].dst, gx + e, live);
      cp_async16(sdy + f32[i].dst, dy + e, live);
    }
#pragma unroll
    for (int i = 0; i < Lo::BF16_EACH; ++i) {
      if (b16[i].row < 0) continue;
      const bool live = t0 + b16[i].row < T;
      const long long e = live ? e0 + b16[i].src : 0;
      cp_async16(su + b16[i].dst, u + e, live);
      cp_async16(sg + b16[i].dst, gate + e, live);
    }
    cp_async_commit();
  };

  const float l = cv ? lam[cg] : 0.f;
  const float k = -RGLRU_C * (log1pf(expf(-fabsf(l))) + fmaxf(l, 0.f));  // -8 softplus(lam)
  float carry = dh_last != nullptr && cv ? dh_last[static_cast<long long>(b) * d + cg] : 0.f;
  float dlam_acc = 0.f;  // sum of dla r over this thread's steps
  float2* summary = reinterpret_cast<float2*>(smem + STAGES * Lo::STAGE);

  issue(tiles - 1, 0);
  for (int it = 0; it < tiles; ++it) {
    const int tile = tiles - 1 - it;
    cp_async_wait_all();
    __syncthreads();  // everyone's copies have landed, the other stage is free
    if (tile > 0) issue(tile - 1, (it + 1) % STAGES);

    const unsigned char* base = smem + (it % STAGES) * Lo::STAGE;
    const float* sga = reinterpret_cast<const float*>(base);
    const float* sgx = sga + Lo::TILE;
    const float* sdy = sgx + Lo::TILE;
    const __nv_bfloat16* su = reinterpret_cast<const __nv_bfloat16*>(sdy + Lo::TILE);
    const __nv_bfloat16* sg = su + Lo::TILE;
    const int ts = tile * Lo::TT + s * L;  // this segment's first step
    // a, r, i, e of each step, h before each step and after the last (hs),
    // g = dy gate; pads (past T) are identity steps with g = 0
    float a[L], r[L], in[L], e[L], hs[L + 1], g[L];
    float sum = 0.f, cl = 0.f;  // log P and the carry out from a zero carry in
    hs[0] = 0.f;
    if (ts < T) {
      hs[0] = cv ? h_seg[(static_cast<long long>(b) * tiles * SEGS + tile * SEGS + s) * d + cg]
                 : 0.f;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int o = s * Lo::SEG + j * CT + c;
        const bool live = ts + j < T;
        r[j] = sigmoid(sga[o]);
        in[j] = sigmoid(sgx[o]);
        const float la = k * r[j];
        e[j] = expf(2.f * la);
        const float bt = sqrtf(fmaxf(1.f - e[j], 1e-12f)) * (in[j] * __bfloat162float(su[o]));
        const float log_a = live ? la : 0.f;
        a[j] = expf(log_a);
        hs[j + 1] = fmaf(a[j], hs[j], live ? bt : 0.f);
        g[j] = live ? sdy[o] * __bfloat162float(sg[o]) : 0.f;
        sum += log_a;
      }
#pragma unroll
      for (int j = L - 1; j >= 0; --j) cl = a[j] * (g[j] + cl);
    } else {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        a[j] = 1.f;
        g[j] = 0.f;
        r[j] = in[j] = e[j] = 0.f;
        hs[j + 1] = 0.f;
      }
    }
    summary[s * CT + c] = make_float2(expf(sum), cl);
    __syncthreads();

    // fold the tile's segments from the right: the carry into this
    // segment, then the carry out of the tile to the left
    float c_in = carry;
#pragma unroll
    for (int s2 = SEGS - 1; s2 >= 0; --s2) {
      if (s2 == s) c_in = carry;
      const float2 pc = summary[s2 * CT + c];
      carry = fmaf(pc.x, carry, pc.y);
    }
    // the segment's steps again, from the end, from c_in
    if (ts < T && cv) {
#pragma unroll
      for (int j = L - 1; j >= 0; --j) {
        if (ts + j >= T) continue;  // a pad: the carry passes unchanged
        const int o = s * Lo::SEG + j * CT + c;
        const float dh = g[j] + c_in;
        const float uf = __bfloat162float(su[o]);
        const float one_e = 1.f - e[j];
        const float sq = sqrtf(fmaxf(one_e, 1e-12f));
        const float dsq = one_e > 1e-12f ? -e[j] / sq : 0.f;
        const float dla = dh * hs[j] * a[j] + dh * in[j] * uf * dsq;
        const long long at = (row0 + ts + j) * d + cg;
        dga[at] = dla * k * r[j] * (1.f - r[j]);
        dgx[at] = dh * sq * uf * in[j] * (1.f - in[j]);
        du[at] = __float2bfloat16(dh * sq * in[j]);
        dgate[at] = __float2bfloat16(sdy[o] * hs[j + 1]);
        dlam_acc += dla * r[j];
        c_in = a[j] * dh;
      }
    }
  }
  if (s == 0 && cv && dh0 != nullptr) dh0[static_cast<long long>(b) * d + cg] = carry;
  // dlam: the channel's 16 segment sums in segment order, into row b
  __syncthreads();
  float* part = reinterpret_cast<float*>(summary);
  part[s * CT + c] = dlam_acc;
  __syncthreads();
  if (s == 0 && cv) {
    float tot = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < SEGS; ++s2) tot += part[s2 * CT + c];
    dlam_part[static_cast<long long>(b) * d + cg] = tot;
  }
}

// dlam[c] = -8 sigmoid(lam[c]) * sum over b of part[b][c], in batch order
__global__ void rglru_dlam_kernel(const float* __restrict__ part, const float* __restrict__ lam,
                                  float* __restrict__ dlam, int B, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float tot = 0.f;
  for (int b = 0; b < B; ++b) tot += part[static_cast<long long>(b) * d + c];
  dlam[c] = tot * -RGLRU_C * sigmoid(lam[c]);
}

template <int L>
cudaError_t launch(cudaStream_t stream, const __nv_bfloat16* u, const float* ga,
                   const float* gx, const float* lam, const __nv_bfloat16* gate,
                   const float* h_seg, const float* dy, const float* dh_last, __nv_bfloat16* du,
                   float* dga, float* dgx, __nv_bfloat16* dgate, float* dh0, float* dlam_part,
                   float* dlam, int B, int T, int d) {
  constexpr int bytes = Layout<L>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(rglru_bwd_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  rglru_bwd_kernel<L><<<dim3((d + CT - 1) / CT, B), THREADS, bytes, stream>>>(
      u, ga, gx, lam, gate, h_seg, dy, dh_last, du, dga, dgx, dgate, dh0, dlam_part, T, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rglru_dlam_kernel<<<(d + 255) / 256, 256, 0, stream>>>(dlam_part, lam, dlam, B, d);
  return cudaGetLastError();
}

}  // namespace

// The shared memory of one block at L steps a segment, in bytes (for the
// build log); -1 for an L the kernel is not built for.
extern "C" int rglru_bwd_smem(int L) {
  switch (L) {
    case 4: return Layout<4>::BYTES;
    case 8: return Layout<8>::BYTES;
    default: return -1;
  }
}

// u, gate: (B, T, d) bf16; ga, gx, dy: (B, T, d) fp32; lam: (d,) fp32;
// h_seg: (B, ceil(T / (16 L)) 16, d) fp32, the segments' h_in that
// rglru_chunked_fwd wrote at the same L; dh_last: (B, d) fp32 or null
// (zeros). Writes du, dgate (B, T, d) bf16, dga, dgx (B, T, d) fp32, dlam
// (d,) fp32, dh0 (B, d) fp32 unless null; dlam_part: (B, d) fp32 scratch.
// All contiguous, d a multiple of 8, the (B, T, d) inputs 16-byte aligned.
// L: 4 or 8. Two launches; returns cudaGetLastError() of the first that
// fails, or 0.
extern "C" int rglru_bwd(const void* u, const void* ga, const void* gx, const void* lam,
                         const void* gate, const void* h_seg, const void* dy,
                         const void* dh_last, void* du, void* dga, void* dgx, void* dgate,
                         void* dh0, void* dlam_part, void* dlam, int B, int T, int d, int L,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* fu = static_cast<const __nv_bfloat16*>(u);
  const auto* fg = static_cast<const __nv_bfloat16*>(gate);
  const auto* fa = static_cast<const float*>(ga);
  const auto* fx = static_cast<const float*>(gx);
  const auto* fl = static_cast<const float*>(lam);
  const auto* fs = static_cast<const float*>(h_seg);
  const auto* fd = static_cast<const float*>(dy);
  const auto* fh = static_cast<const float*>(dh_last);
  auto* odu = static_cast<__nv_bfloat16*>(du);
  auto* oga = static_cast<float*>(dga);
  auto* ogx = static_cast<float*>(dgx);
  auto* ogt = static_cast<__nv_bfloat16*>(dgate);
  auto* oh0 = static_cast<float*>(dh0);
  auto* opt = static_cast<float*>(dlam_part);
  auto* olm = static_cast<float*>(dlam);
  switch (L) {
    case 4:
      return static_cast<int>(launch<4>(st, fu, fa, fx, fl, fg, fs, fd, fh, odu, oga, ogx, ogt,
                                        oh0, opt, olm, B, T, d));
    case 8:
      return static_cast<int>(launch<8>(st, fu, fa, fx, fl, fg, fs, fd, fh, odu, oga, ogx, ogt,
                                        oh0, opt, olm, B, T, d));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
