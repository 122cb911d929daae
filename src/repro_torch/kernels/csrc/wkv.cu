// RWKV6 WKV recurrence, for Hopper (sm_90a).
//
// Replaces repro/kernels/wkv/kernel.py::wkv_pallas. Per (batch b, head h),
// with an N x N fp32 state S (row i: key channel, column j: value channel),
// for t < lengths[b]:
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = S[i][j] * w_t[i] + k_t[i] * v_t[j]
// the step of repro/models/recurrent.py::_wkv_step. Steps at or past
// lengths[b] leave S as it is and give a zero output (the identity step with
// which the TPU op pads a ragged chunk), so a right-padded prompt's state is
// that of its real tokens only. Unlike the TPU kernel, u is per head (H, N)
// and the state may start from state0.
//
// Bound on an H100 at the served prefill (B, T, H, N) = (8, <=512, 64, 64):
// bytes. The step factors as
//   out_t[j] = sum_i r_t[i] * S[i][j] + v_t[j] * sum_i r_t[i] * u[i] * k_t[i]
// so it needs 5 fp32 operations per state element (an FMA for r.S, a
// multiply and an FMA for the update) and 2 N for the bonus dot, 5 N^2 + 2 N
// in all, on the 20 N bytes of its four input vectors and its output
// vector: 16 operations per byte at N = 64, below the 20 at which 67 TFLOP/s
// of fp32 and 3.35 TB/s meet; the products cannot go to the tensor cores in
// this sequential form. At decode (T = 1) it is bytes too: the 16 KiB state
// of each (b, h) is read and written once and used for one step.
//
// Design (simple first). The TPU kernel carries S in VMEM scratch across a
// sequential grid axis over time chunks; Hopper's blocks run in no order, so
// the time loop runs inside the block. One block of N threads per (h, b);
// thread j keeps column j of S in N registers for the whole sequence. A
// chunk of CH steps of r, k, w and v is staged in shared memory by coalesced
// row loads; then thread s < CH computes the bonus dot of step s of the
// chunk in four partial sums of float4 reads (rotated by 4 s words, so that
// the threads of a quarter-warp hit distinct banks), three __syncthreads a
// chunk in all, none per step. Each step then reads r, k and
// w as float4 broadcasts and v[j] from its own column, and issues an FMA, a
// multiply and an FMA per element. The sum over i runs in four interleaved
// partial sums, whose order differs from the reference's by fp32 rounding
// only. The inputs are read through their (batch, time, head) strides with a
// unit stride along N, so the model's (B, T, H, N) views need no transpose.
//
// Decode in place: state_out may be state0 itself. Each thread reads its own
// column of state0 into registers before the first step and writes the same
// column of state_out after the last; no thread touches another's column and
// no block another's (b, h), so nothing is read after it was written.
//
// Occupancy is low at the served shapes (512 blocks of 2 warps, about 4 per
// SM); the chunked-parallel form with tensor-core products within a chunk is
// the known next step.
//
// N = 128 (no served model; every call at that head size, any T, runs
// here, since wkv_chunked.cu's layout stops at 64): a thread keeps its
// column of 128 state values in registers, and a chunk stages 16 steps, so
// the four staged inputs take 32 KB of the 48 KB of static shared memory.

#include <cuda_runtime.h>

namespace {

// time steps staged in shared memory at a time: 4 CH N floats
template <int N>
__host__ __device__ constexpr int chunk_steps() { return N == 128 ? 16 : 32; }

struct Strides {
  long long b, t, h;  // element strides of a (B, T, H, N) input; N contiguous
};

template <int N>
__global__ void __launch_bounds__(N)
wkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* state0,
               const int* __restrict__ lengths, float* __restrict__ out, float* state_out,
               int T, int H, Strides sr, Strides sk, Strides sv, Strides sw) {
  constexpr int CH = chunk_steps<N>();
  static_assert(N >= CH, "a thread computes each staged step's bonus dot");
  __shared__ __align__(16) float s_r[CH][N];
  __shared__ __align__(16) float s_k[CH][N];
  __shared__ __align__(16) float s_w[CH][N];
  __shared__ __align__(16) float s_v[CH][N];
  __shared__ __align__(16) float s_u[N];
  __shared__ float s_ruk[CH];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int len = lengths != nullptr ? min(max(lengths[b], 0), T) : T;
  const long long sbase = ((long long)b * H + h) * N * N;

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = state0 != nullptr ? state0[sbase + (long long)i * N + j] : 0.f;
  s_u[j] = u[(long long)h * N + j];

  const float* rb = r + b * sr.b + h * sr.h + j;
  const float* kb = k + b * sk.b + h * sk.h + j;
  const float* vb = v + b * sv.b + h * sv.h + j;
  const float* wb = w + b * sw.b + h * sw.h + j;
  const long long out_t = (long long)H * N;  // out is contiguous (B, T, H, N)
  float* ob = out + ((long long)b * T * H + h) * N + j;

  for (int t0 = 0; t0 < len; t0 += CH) {
    const int n = min(CH, len - t0);
    __syncthreads();  // the previous chunk has been consumed (and s_u written)
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const long long t = t0 + s;
      s_r[s][j] = rb[t * sr.t];
      s_k[s][j] = kb[t * sk.t];
      s_w[s][j] = wb[t * sw.t];
      s_v[s][j] = vb[t * sv.t];
    }
    __syncthreads();
    if (j < n) {  // the bonus dot of step j of the chunk
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
      for (int c = 0; c < N; c += 4) {
        const int i = (c + 4 * j) % N;
        const float4 r4 = *reinterpret_cast<const float4*>(&s_r[j][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&s_k[j][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&s_u[i]);
        d0 = fmaf(r4.x * u4.x, k4.x, d0);
        d1 = fmaf(r4.y * u4.y, k4.y, d1);
        d2 = fmaf(r4.z * u4.z, k4.z, d2);
        d3 = fmaf(r4.w * u4.w, k4.w, d3);
      }
      s_ruk[j] = (d0 + d1) + (d2 + d3);
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float vj = s_v[s][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&s_r[s][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&s_k[s][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&s_w[s][i]);
        a0 = fmaf(r4.x, S[i], a0);
        S[i] = fmaf(S[i], w4.x, k4.x * vj);
        a1 = fmaf(r4.y, S[i + 1], a1);
        S[i + 1] = fmaf(S[i + 1], w4.y, k4.y * vj);
        a2 = fmaf(r4.z, S[i + 2], a2);
        S[i + 2] = fmaf(S[i + 2], w4.z, k4.z * vj);
        a3 = fmaf(r4.w, S[i + 3], a3);
        S[i + 3] = fmaf(S[i + 3], w4.w, k4.w * vj);
      }
      ob[(t0 + s) * out_t] = fmaf(vj, s_ruk[s], (a0 + a1) + (a2 + a3));
    }
  }
  for (int t = len; t < T; ++t) ob[t * out_t] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) state_out[sbase + (long long)i * N + j] = S[i];
}

template <int N>
cudaError_t launch(cudaStream_t st, const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* state0, const int* lengths,
                   float* out, float* state_out, int B, int T, int H, Strides sr, Strides sk,
                   Strides sv, Strides sw) {
  wkv_fwd_kernel<N><<<dim3(H, B), N, 0, st>>>(r, k, v, w, u, state0, lengths, out, state_out,
                                              T, H, sr, sk, sv, sw);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w: (B, T, H, N) fp32 with element strides (batch, time, head) and a
// contiguous last axis; u: (H, N) fp32 contiguous; state0: (B, H, N, N) fp32
// contiguous, or null for a zero state; lengths: (B,) int32, or null for T
// steps everywhere; out: (B, T, H, N) fp32 contiguous; state_out: (B, H, N, N)
// fp32 contiguous, which may be state0 (updated in place). N in {32, 64, 128}.
// Returns cudaGetLastError().
extern "C" int wkv_fwd(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* state0, const void* lengths, void* out,
                       void* state_out, int B, int T, int H, int N, long long srb, long long srt,
                       long long srh, long long skb, long long skt, long long skh,
                       long long svb, long long svt, long long svh, long long swb,
                       long long swt, long long swh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sr{srb, srt, srh}, sk{skb, skt, skh}, sv{svb, svt, svh}, sw{swb, swt, swh};
  const float *fr = static_cast<const float*>(r), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fw = static_cast<const float*>(w),
              *fu = static_cast<const float*>(u), *fs = static_cast<const float*>(state0);
  const int* lens = static_cast<const int*>(lengths);
  float* fo = static_cast<float*>(out);
  float* fso = static_cast<float*>(state_out);
  cudaError_t err;
  switch (N) {
    case 32:
      err = launch<32>(st, fr, fk, fv, fw, fu, fs, lens, fo, fso, B, T, H, sr, sk, sv, sw);
      break;
    case 64:
      err = launch<64>(st, fr, fk, fv, fw, fu, fs, lens, fo, fso, B, T, H, sr, sk, sv, sw);
      break;
    case 128:
      err = launch<128>(st, fr, fk, fv, fw, fu, fs, lens, fo, fso, B, T, H, sr, sk, sv, sw);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
