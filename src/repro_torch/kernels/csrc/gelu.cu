// tanh-GELU, and the gated-GELU product gelu(g) * u, for Hopper (sm_90a),
// and their backward (below the forward).
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

// ---------------------------------------------------------------------------
// Backward: gelu_bwd (dx = dy gelu'(x)) and gelu_mul_bwd (dg = dy u gelu'(g),
// du = dy gelu(g)).
//
// No TPU kernel is replaced: jax.grad differentiates the JAX model's
// jax.nn.gelu(approximate=True) in XLA. A train step of gpt3 and whisper
// needs the plain mode; the gated mode is recurrentgemma's and grok's.
//
// gelu'(x) = s + x d(2z)/dx s (1 - s), s = sigmoid(2z), d(2z)/dx = K2 (1 +
// 3 a x^2), in fp32 with one rounding an output. As in the forward, nothing
// cancels: s and 1 - s both come from e = e^{-2|z|} <= 1, r = 1 / (1 + e)
// and q = e r, as (r, q) for z >= 0 and (q, r) below; e never overflows. x
// is clamped to [-20, 20] in gelu' only: past it the fp32 derivative is
// exactly 1 (s = 1, 1 - s = 0) or 0 (s = 0), and x^3 would otherwise reach
// inf * 0. A NaN input gives a NaN gradient.
//
// Bound on an H100: bytes. The plain mode reads two elements and writes
// one, the gated mode reads three and writes two, with about 20 fp32
// operations an element. The forward's design: one 16-byte load of each
// input and one 16-byte store of each output a thread, blocks of 512
// threads, one block a tile; a scalar variant for bases off 16 bytes.

__device__ __forceinline__ float gelu_grad(float x) {
  const float c = fminf(fmaxf(x, -20.f), 20.f);
  const float c2 = c * c;
  const float z2 = c * fmaf(K2 * 0.044715f, c2, K2);  // 2 z
  const float e = __expf(-fabsf(z2));
  const float r = __fdividef(1.f, 1.f + e), q = e * r;
  const float s = z2 >= 0.f ? r : q, t = z2 >= 0.f ? q : r;  // s, 1 - s
  const float d = fmaf(c * fmaf(3.f * 0.044715f * K2, c2, K2), s * t, s);
  return x != x ? x : d;
}

// (dx, unused) in the plain mode, (dg, du) in the gated one, for one element
template <bool GATED>
__device__ __forceinline__ float2 gelu_bwd_elem(float x, float u, float dy) {
  if constexpr (GATED) return make_float2(dy * u * gelu_grad(x), dy * gelu(x));
  return make_float2(dy * gelu_grad(x), 0.f);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 y = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&y);
}

// one 32-bit word of each input: two bf16 lanes or one fp32; the outputs'
// words in o1 (dx or dg) and o2 (du)
template <bool BF16, bool GATED>
__device__ __forceinline__ void gelu_bwd_word(uint32_t a, uint32_t b, uint32_t d, uint32_t& o1,
                                              uint32_t& o2) {
  if constexpr (BF16) {
    const float2 lo = gelu_bwd_elem<GATED>(__uint_as_float(a << 16), __uint_as_float(b << 16),
                                           __uint_as_float(d << 16));
    const float2 hi = gelu_bwd_elem<GATED>(__uint_as_float(a & 0xffff0000u),
                                           __uint_as_float(b & 0xffff0000u),
                                           __uint_as_float(d & 0xffff0000u));
    o1 = pack_bf16x2(lo.x, hi.x);
    o2 = pack_bf16x2(lo.y, hi.y);
  } else {
    const float2 y = gelu_bwd_elem<GATED>(__uint_as_float(a), __uint_as_float(b),
                                          __uint_as_float(d));
    o1 = __float_as_uint(y.x);
    o2 = __float_as_uint(y.y);
  }
}

template <bool BF16, bool GATED>
__device__ __forceinline__ void gelu_bwd_one(const void* x, const void* u, const void* dy,
                                             void* o1, void* o2, long long e) {
  if constexpr (BF16) {
    const auto ld = [e](const void* p) {
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[e]);
    };
    const float2 y = gelu_bwd_elem<GATED>(ld(x), GATED ? ld(u) : 0.f, ld(dy));
    static_cast<__nv_bfloat16*>(o1)[e] = __float2bfloat16_rn(y.x);
    if constexpr (GATED) static_cast<__nv_bfloat16*>(o2)[e] = __float2bfloat16_rn(y.y);
  } else {
    const auto ld = [e](const void* p) { return static_cast<const float*>(p)[e]; };
    const float2 y = gelu_bwd_elem<GATED>(ld(x), GATED ? ld(u) : 0.f, ld(dy));
    static_cast<float*>(o1)[e] = y.x;
    if constexpr (GATED) static_cast<float*>(o2)[e] = y.y;
  }
}

// n elements; every pointer 16-byte aligned. One 16-byte vector of each
// input and output a thread; the last n % (16 / element size) elements by
// the first threads of block 0.
template <bool BF16, bool GATED>
__global__ void __launch_bounds__(THREADS)
gelu_bwd_vec_kernel(const void* x, const void* u, const void* dy, void* o1, void* o2,
                    long long n) {
  constexpr int E = BF16 ? 8 : 4;
  const long long nvec = n / E, i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < nvec) {
    const uint4 a = load_ro(static_cast<const uint4*>(x) + i);
    const uint4 b = GATED ? load_ro(static_cast<const uint4*>(u) + i) : a;
    const uint4 d = load_ro(static_cast<const uint4*>(dy) + i);
    uint4 r1, r2;
    gelu_bwd_word<BF16, GATED>(a.x, b.x, d.x, r1.x, r2.x);
    gelu_bwd_word<BF16, GATED>(a.y, b.y, d.y, r1.y, r2.y);
    gelu_bwd_word<BF16, GATED>(a.z, b.z, d.z, r1.z, r2.z);
    gelu_bwd_word<BF16, GATED>(a.w, b.w, d.w, r1.w, r2.w);
    static_cast<uint4*>(o1)[i] = r1;
    if constexpr (GATED) static_cast<uint4*>(o2)[i] = r2;
  }
  if (blockIdx.x == 0 && threadIdx.x < n - nvec * E)
    gelu_bwd_one<BF16, GATED>(x, u, dy, o1, o2, nvec * E + threadIdx.x);
}

// Any alignment: one element a thread.
template <bool BF16, bool GATED>
__global__ void __launch_bounds__(THREADS)
gelu_bwd_scalar_kernel(const void* x, const void* u, const void* dy, void* o1, void* o2,
                       long long n) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e < n) gelu_bwd_one<BF16, GATED>(x, u, dy, o1, o2, e);
}

template <bool BF16, bool GATED>
cudaError_t launch_bwd(cudaStream_t st, const void* x, const void* u, const void* dy, void* o1,
                       void* o2, long long n) {
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool aligned = a16(x) && a16(dy) && a16(o1) && (!GATED || (a16(u) && a16(o2)));
  const long long work = aligned ? n / (BF16 ? 8 : 4) : n;
  const long long grid = work > 0 ? (work + THREADS - 1) / THREADS : 1;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (aligned)
    gelu_bwd_vec_kernel<BF16, GATED>
        <<<static_cast<unsigned>(grid), THREADS, 0, st>>>(x, u, dy, o1, o2, n);
  else
    gelu_bwd_scalar_kernel<BF16, GATED>
        <<<static_cast<unsigned>(grid), THREADS, 0, st>>>(x, u, dy, o1, o2, n);
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

// dx = dy gelu'(x): x, dy, dx n contiguous elements of one dtype, bf16
// (bf16 != 0) or fp32. Returns cudaGetLastError().
extern "C" int gelu_bwd(const void* x, const void* dy, void* dx, long long n, int bf16,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_bwd<true, false>(st, x, nullptr, dy, dx, nullptr, n)
                               : launch_bwd<false, false>(st, x, nullptr, dy, dx, nullptr, n));
}

// dg = dy u gelu'(g), du = dy gelu(g): every tensor n contiguous elements of
// one dtype, bf16 (bf16 != 0) or fp32. Returns cudaGetLastError().
extern "C" int gelu_mul_bwd(const void* g, const void* u, const void* dy, void* dg, void* du,
                            long long n, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_bwd<true, true>(st, g, u, dy, dg, du, n)
                               : launch_bwd<false, true>(st, g, u, dy, dg, du, n));
}
