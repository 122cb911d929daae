// RG-LRU scan of Griffin (recurrentgemma), for Hopper (sm_90a).
//
// A kernel the port adds: the JAX package computes this recurrence in XLA,
// the gates in repro/models/recurrent.py::_rglru_gates and the scan with
// lax.associative_scan in rglru_apply (and one step in rglru_decode_step).
// Per (batch b, channel c), for t < lengths[b]:
//   r = sigmoid(ga_t), i = sigmoid(gx_t), log a = -8 r softplus(lam),
//   h_t = a h_{t-1} + sqrt(max(1 - a^2, 1e-12)) i u_t,
// from h_{-1} = h0 (or 0), and y_t = gate_t h_t, all in fp32; ga = u @ w_a
// and gx = u @ w_x come in from two fp32 GEMMs, u and the GELU gate in bf16.
// Steps at or past lengths[b] leave h as it is (y there is gate * that h),
// so a right-padded prompt's h is that of its real tokens only; h_out gets h
// after the last real step.
//
// Why CUDA C++ and not Triton: the work is a sequential loop over T with a
// carried state, one independent chain per channel; Triton's block model
// has no carried loop state of its own to offer here, and the plain loop
// with per-thread registers is what the recurrence is.
//
// Bound on an H100: bytes. Each (b, t, c) reads u and the gate (2 bytes
// each), ga and gx (4 each) and writes y (4): 16 bytes for about 20 fp32
// operations, and two exponentials. At the served wave (8, 512, 2560) that
// is 168 MB, 0.050 ms at 3.35 TB/s.
//
// Design (simple first). One thread per (b, c), 64 to a block, the loop
// over T inside the thread; neighbouring threads read neighbouring channels,
// so every load and store is coalesced. Only the h update is a chain from
// step to step; the inputs of a step do not depend on h. So a thread loads
// the inputs of CH = 16 steps into registers (pads' values too, read and
// discarded) before it uses any, and then runs the 16 steps: 64 loads in
// flight a thread. Loading step by step left one device-memory latency per
// step (about 1.05 us a step at the served wave and at a batch-1 refill
// alike, chip_smoke.py on an H100 80GB HBM3 at 700 W). B d threads are all
// the parallelism this form has: at the served wave 20480 threads, about
// 155 an SM. Since then every call of more than one step runs on the
// chunked scan over T, csrc/rglru_chunked.cu; this kernel keeps the decode
// step (T = 1, h in place), where it is the faster of the two, and calls
// the chunked one cannot copy (kernels/rglru/kernel.py::picks_chunked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int CH = 16;  // steps whose inputs a thread loads before it uses any
constexpr float RGLRU_C = 8.f;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const __nv_bfloat16* __restrict__ u, const float* __restrict__ ga,
             const float* __restrict__ gx, const float* __restrict__ lam,
             const __nv_bfloat16* __restrict__ gate, const float* h0,
             const int* __restrict__ lengths, float* __restrict__ y, float* h_out, int T,
             int d) {
  const int c = blockIdx.x * THREADS + threadIdx.x, b = blockIdx.y;
  if (c >= d) return;
  const int len = lengths != nullptr ? min(max(lengths[b], 0), T) : T;
  const float l = lam[c];
  const float k = -RGLRU_C * (log1pf(expf(-fabsf(l))) + fmaxf(l, 0.f));  // -8 softplus(lam)
  // read before anything is written: h_out may be h0 (the decode step's cache)
  float h = h0 != nullptr ? h0[static_cast<long long>(b) * d + c] : 0.f;
  const long long base = static_cast<long long>(b) * T * d + c;
  for (int t0 = 0; t0 < T; t0 += CH) {
    const int n = min(CH, T - t0);
    float ra[CH], rx[CH], ru[CH], rg[CH];
#pragma unroll
    for (int s = 0; s < CH; ++s) {
      if (s < n) {
        const long long e = base + static_cast<long long>(t0 + s) * d;
        ra[s] = ga[e];
        rx[s] = gx[e];
        ru[s] = __bfloat162float(u[e]);
        rg[s] = __bfloat162float(gate[e]);
      }
    }
#pragma unroll
    for (int s = 0; s < CH; ++s) {
      if (s < n) {
        const float log_a = k * sigmoid(ra[s]);
        const float bt =
            sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f)) * (sigmoid(rx[s]) * ru[s]);
        if (t0 + s < len) h = fmaf(expf(log_a), h, bt);
        y[base + static_cast<long long>(t0 + s) * d] = rg[s] * h;
      }
    }
  }
  h_out[static_cast<long long>(b) * d + c] = h;
}

}  // namespace

// u, gate: (B, T, d) bf16; ga, gx: (B, T, d) fp32; lam: (d,) fp32; h0: (B, d)
// fp32 or null (zeros); lengths: (B,) int32 or null (T everywhere); y:
// (B, T, d) fp32; h_out: (B, d) fp32, which may be h0. All contiguous.
// Returns cudaGetLastError().
extern "C" int rglru_fwd(const void* u, const void* ga, const void* gx, const void* lam,
                         const void* gate, const void* h0, const void* lengths, void* y,
                         void* h_out, int B, int T, int d, void* stream) {
  const dim3 grid((d + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(u), static_cast<const float*>(ga),
      static_cast<const float*>(gx), static_cast<const float*>(lam),
      static_cast<const __nv_bfloat16*>(gate), static_cast<const float*>(h0),
      static_cast<const int*>(lengths), static_cast<float*>(y), static_cast<float*>(h_out), T,
      d);
  return static_cast<int>(cudaGetLastError());
}
