// tanh-GELU, for Hopper (sm_90a).
//
// Replaces repro/kernels/gelu/kernel.py::gelu_pallas, elementwise, in fp32
// and rounded once to the input's dtype (bf16 or fp32):
//   gelu(x) = 0.5 x (1 + tanh z) = x sigmoid(2 z) = x / (1 + e^{-2 z}),
//   z = sqrt(2/pi) (x + 0.044715 x^3).
// The sigmoid form does not cancel where tanh z nears -1, and saturates
// cleanly: for large |x|, e^{-2z} is 0 or inf and the quotient x or 0.
//
// Bound on an H100: bytes (each element read once and written once; about
// 10 fp32 operations an element against 2-4 bytes). The Triton kernel this
// replaces streamed at 88% of 3.35 TB/s, as F.gelu does; what is left is in
// the instruction stream and the access pattern:
//  * e^{-2z} by __expf (one MUFU.EX2 and a multiply) and the quotient by
//    __fdividef (one MUFU.RCP and a multiply), no full-precision division.
//    Their error of a few fp32 ulps lies far inside one bf16 rounding and
//    the fp32 gate of 2e-5.
//  * One 16-byte load (through the read-only path, ld.global.nc) and one
//    16-byte store a thread, 8 bf16 or 4 fp32 elements, in blocks of 512
//    threads that each cover 8 KB of bf16, one block a tile, as many
//    blocks as tiles; the ragged tail (fewer elements than one access) is
//    handled in the kernel. A base off 16 bytes takes a scalar variant.
//    Measured on the card against this form, each of these cost time at
//    (4096, 49152) bf16: a grid of 8 blocks an SM striding over the tensor,
//    2 or 4 accesses in flight a thread, and the streaming hints
//    ld.global.nc.L1::no_allocate with st.global.cs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr float K2 = 1.5957691216057308f;  // 2 sqrt(2/pi)

__device__ __forceinline__ float gelu(float x) {
  const float m = x * fmaf(-K2 * 0.044715f, x * x, -K2);  // -2 z
  return __fdividef(x, 1.f + __expf(m));
}

__device__ __forceinline__ uint4 load_ro(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t gelu_bf16x2(uint32_t a) {
  const float lo = gelu(__uint_as_float(a << 16)), hi = gelu(__uint_as_float(a & 0xffff0000u));
  const __nv_bfloat162 y = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&y);
}

__device__ __forceinline__ uint32_t gelu_f32(uint32_t a) {
  return __float_as_uint(gelu(__uint_as_float(a)));
}

template <bool BF16>
__device__ __forceinline__ uint4 gelu_vec(uint4 v) {
  if constexpr (BF16) return make_uint4(gelu_bf16x2(v.x), gelu_bf16x2(v.y), gelu_bf16x2(v.z), gelu_bf16x2(v.w));
  return make_uint4(gelu_f32(v.x), gelu_f32(v.y), gelu_f32(v.z), gelu_f32(v.w));
}

template <bool BF16>
__device__ __forceinline__ void gelu_one(const void* x, void* o, long long e) {
  if constexpr (BF16) {
    const __nv_bfloat16 y = __float2bfloat16_rn(gelu(__bfloat162float(
        static_cast<const __nv_bfloat16*>(x)[e])));
    static_cast<__nv_bfloat16*>(o)[e] = y;
  } else {
    static_cast<float*>(o)[e] = gelu(static_cast<const float*>(x)[e]);
  }
}

// n elements; x and o 16-byte aligned. One 16-byte vector a thread; the
// last n % (16 / element size) elements by the first threads of block 0.
template <bool BF16>
__global__ void __launch_bounds__(THREADS) gelu_vec_kernel(const void* x, void* o, long long n) {
  constexpr int E = BF16 ? 8 : 4;
  const long long nvec = n / E, i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < nvec)
    static_cast<uint4*>(o)[i] = gelu_vec<BF16>(load_ro(static_cast<const uint4*>(x) + i));
  if (blockIdx.x == 0 && threadIdx.x < n - nvec * E) gelu_one<BF16>(x, o, nvec * E + threadIdx.x);
}

// Any alignment: one element a thread.
template <bool BF16>
__global__ void __launch_bounds__(THREADS) gelu_scalar_kernel(const void* x, void* o, long long n) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e < n) gelu_one<BF16>(x, o, e);
}

template <bool BF16>
cudaError_t launch(cudaStream_t st, const void* x, void* o, long long n) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o) % 16 == 0;
  const long long work = aligned ? n / (BF16 ? 8 : 4) : n;
  const long long grid = work > 0 ? (work + THREADS - 1) / THREADS : 1;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (aligned)
    gelu_vec_kernel<BF16><<<static_cast<unsigned>(grid), THREADS, 0, st>>>(x, o, n);
  else
    gelu_scalar_kernel<BF16><<<static_cast<unsigned>(grid), THREADS, 0, st>>>(x, o, n);
  return cudaGetLastError();
}

}  // namespace

// x, out: n contiguous elements, bf16 (bf16 != 0) or fp32. Returns
// cudaGetLastError().
extern "C" int gelu_fwd(const void* x, void* out, long long n, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch<true>(st, x, out, n) : launch<false>(st, x, out, n));
}
