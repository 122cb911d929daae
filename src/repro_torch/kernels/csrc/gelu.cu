// tanh-GELU, and the gated-GELU product gelu(g) * u, for Hopper (sm_90a).
//
// Replaces repro/kernels/gelu/kernel.py::gelu_pallas, elementwise, in fp32
// and rounded once to the input's dtype (bf16 or fp32):
//   gelu(x) = 0.5 x (1 + tanh z) = x sigmoid(2 z) = x / (1 + e^{-2 z}),
//   z = sqrt(2/pi) (x + 0.044715 x^3).
// The gated mode (gelu_mul_fwd) computes gelu(g) * u in fp32 with one
// rounding: the gated-GELU MLP of recurrentgemma, which the JAX model
// computes in repro/models/layers.py::mlp_apply with jax.nn.gelu outside any
// Pallas kernel. It reads two elements and writes one, and runs the same
// loop with a second 16-byte load.
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

// gelu of the low and high bf16 of a, each times that of b in the gated mode
template <bool GATED>
__device__ __forceinline__ uint32_t gelu_bf16x2(uint32_t a, uint32_t b) {
  float lo = gelu(__uint_as_float(a << 16)), hi = gelu(__uint_as_float(a & 0xffff0000u));
  if constexpr (GATED) {
    lo *= __uint_as_float(b << 16);
    hi *= __uint_as_float(b & 0xffff0000u);
  }
  const __nv_bfloat162 y = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&y);
}

template <bool GATED>
__device__ __forceinline__ uint32_t gelu_f32(uint32_t a, uint32_t b) {
  const float y = gelu(__uint_as_float(a));
  return __float_as_uint(GATED ? y * __uint_as_float(b) : y);
}

template <bool BF16, bool GATED>
__device__ __forceinline__ uint4 gelu_vec(uint4 v, uint4 w) {
  if constexpr (BF16)
    return make_uint4(gelu_bf16x2<GATED>(v.x, w.x), gelu_bf16x2<GATED>(v.y, w.y),
                      gelu_bf16x2<GATED>(v.z, w.z), gelu_bf16x2<GATED>(v.w, w.w));
  return make_uint4(gelu_f32<GATED>(v.x, w.x), gelu_f32<GATED>(v.y, w.y),
                    gelu_f32<GATED>(v.z, w.z), gelu_f32<GATED>(v.w, w.w));
}

template <bool BF16, bool GATED>
__device__ __forceinline__ void gelu_one(const void* x, const void* u, void* o, long long e) {
  if constexpr (BF16) {
    float y = gelu(__bfloat162float(static_cast<const __nv_bfloat16*>(x)[e]));
    if constexpr (GATED) y *= __bfloat162float(static_cast<const __nv_bfloat16*>(u)[e]);
    static_cast<__nv_bfloat16*>(o)[e] = __float2bfloat16_rn(y);
  } else {
    float y = gelu(static_cast<const float*>(x)[e]);
    if constexpr (GATED) y *= static_cast<const float*>(u)[e];
    static_cast<float*>(o)[e] = y;
  }
}

// n elements; x, u (gated mode) and o 16-byte aligned. One 16-byte vector
// (of each input) a thread; the last n % (16 / element size) elements by the
// first threads of block 0.
template <bool BF16, bool GATED>
__global__ void __launch_bounds__(THREADS)
gelu_vec_kernel(const void* x, const void* u, void* o, long long n) {
  constexpr int E = BF16 ? 8 : 4;
  const long long nvec = n / E, i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < nvec) {
    const uint4 v = load_ro(static_cast<const uint4*>(x) + i);
    const uint4 w = GATED ? load_ro(static_cast<const uint4*>(u) + i) : v;
    static_cast<uint4*>(o)[i] = gelu_vec<BF16, GATED>(v, w);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - nvec * E)
    gelu_one<BF16, GATED>(x, u, o, nvec * E + threadIdx.x);
}

// Any alignment: one element a thread.
template <bool BF16, bool GATED>
__global__ void __launch_bounds__(THREADS)
gelu_scalar_kernel(const void* x, const void* u, void* o, long long n) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e < n) gelu_one<BF16, GATED>(x, u, o, e);
}

template <bool BF16, bool GATED>
cudaError_t launch(cudaStream_t st, const void* x, const void* u, void* o, long long n) {
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool aligned = a16(x) && a16(o) && (!GATED || a16(u));
  const long long work = aligned ? n / (BF16 ? 8 : 4) : n;
  const long long grid = work > 0 ? (work + THREADS - 1) / THREADS : 1;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (aligned)
    gelu_vec_kernel<BF16, GATED><<<static_cast<unsigned>(grid), THREADS, 0, st>>>(x, u, o, n);
  else
    gelu_scalar_kernel<BF16, GATED><<<static_cast<unsigned>(grid), THREADS, 0, st>>>(x, u, o, n);
  return cudaGetLastError();
}

}  // namespace

// x, out: n contiguous elements, bf16 (bf16 != 0) or fp32. Returns
// cudaGetLastError().
extern "C" int gelu_fwd(const void* x, void* out, long long n, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch<true, false>(st, x, nullptr, out, n)
                               : launch<false, false>(st, x, nullptr, out, n));
}

// out = gelu(g) * u: g, u, out n contiguous elements of one dtype, bf16
// (bf16 != 0) or fp32. Returns cudaGetLastError().
extern "C" int gelu_mul_fwd(const void* g, const void* u, void* out, long long n, int bf16,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch<true, true>(st, g, u, out, n)
                               : launch<false, true>(st, g, u, out, n));
}
