// LayerNorm backward for Hopper (sm_90a): (dx, dg, db) of x and dy (R, C)
// in bf16 or fp32, with g (C,) in fp32.
//
// Replaces no TPU kernel: it is the gradient of
// repro/kernels/rmsnorm/kernel.py:48::layernorm_pallas, which the JAX
// package differentiates in XLA (jax.grad of its LayerNorm). With mean and
// the biased variance of the centred row (never E[x^2] - mean^2), rstd =
// rsqrt(var + eps), xh = (x - mean) rstd and w = g dy, in fp32 and dx
// rounded once to x's dtype:
//   dx = (w - mean(w) - xh mean(w xh)) rstd,
//   dg = sum over rows of dy xh,   db = sum over rows of dy   (fp32),
// mean(w xh) taken as rstd mean(w (x - mean)), the same sum with rstd
// factored out. kernels/rmsnorm/ref.py::layernorm_bwd_ref is this
// arithmetic in PyTorch.
//
// Bound on an H100: bytes. x and dy are read once and dx written once (6
// bytes an element in bf16) with about 15 fp32 operations an element; no
// tensor cores are needed. At stablelm-1.6b's (4096, 2048) that is 0.0150
// ms at 3.35 TB/s, at gpt3-175b's (4096, 12288) 0.0902 ms.
//
// The Triton design this replaces as the rule (rmsnorm/kernel.py::
// layernorm_bwd_triton, kept as the route for the rows this kernel does not
// take, and for bf16 rows of 2049 to 4096, where its one chunk a row ran
// faster: 0.049 ms against 0.056 at rwkv6-7b's (4096, 4096)) ran at 42.6% of the bound at (4096, 2048) and 34.8% at (4096,
// 12288) (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, L2 flushed):
// its column sum was a launch of its own, one program an SM kept about 16 KB
// of loads in flight, and a row wider than 2048 crossed the memory hierarchy
// three times. Here:
//  * Persistent blocks, one an SM: block b walks rows [b R / nb, (b+1) R /
//    nb), a range the shape alone fixes. Its 512 consumer threads form
//    `groups` groups of `tg` threads (tg a multiple of 32), a row a group at
//    a time; a thread owns VPT 16-byte vectors of a row, the same columns
//    for every row of the block (a warp a row at whisper's 384, four rows of
//    128 threads at stablelm's 2048, the whole block on a row at gpt3's
//    12288; the host-side plan is kernels/rmsnorm/kernel.py::ring_shape).
//  * A ring of `stages` stages in shared memory, a stage a row of x and of
//    dy for each group. One producer thread, in a warp of its own, keeps the
//    ring full by bulk copies (cp.async.bulk) that complete on the stage's
//    mbarrier; each consumer warp releases the stage (its empty mbarrier) as
//    soon as its row is in registers, before it computes. g is copied once
//    into shared memory.
//  * Each element crosses device memory once each way at every width: the
//    row is read from shared memory once, into registers, where the two
//    group sums (sum x; then sum (x - mean)^2, sum w and sum w (x - mean))
//    and dx are computed. dx is stored from registers as 16-byte vectors.
//    Holding the rows in registers, not shared memory, keeps a thread under
//    96 registers, so that 16 consumer warps fit an SM.
//  * dg and db build up in registers; at the end the groups' sums are added
//    in group order (in the drained ring) into one fp32 partial row of dg
//    and db a block.
//  * The column sum has no launch of its own and uses no floating-point
//    atomics: the launch is cooperative (every block resident), the blocks
//    meet at a grid barrier on a counter, and block b then sums its stripe
//    of the 2C columns over the nb partial rows in block order. The order of
//    every sum depends on the shape alone, so dg and db are the same bits
//    from run to run; the counters are back at 0 when the launch ends.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int MAX_STAGES = 8;            // stages the ring holds, at most
constexpr int BAR_BYTES = 144;           // 2 MAX_STAGES + 1 mbarriers, 16-byte rounded
constexpr int RED_BYTES = 512;           // 2 slots x 16 warps x 4 floats
constexpr int MAX_THREADS = 512 + 32;    // consumers, and the producer's warp
constexpr int MAX_SLICES = 64;           // threads summing one column quad

struct Params {
  const void* x;
  const void* dy;
  const float* g;
  void* dx;
  float* part;      // (nb, 2C): each block's dg row, then its db row
  float* dgb;       // (2C,): dg, then db
  unsigned* counter;  // 2 counters, 0 between launches
  long long sx, sdy;  // row strides in elements
  int R, C, nb, tg, groups, stages, whole;
  float eps;
};

// element e of a 16-byte vector of bf16 (8) or fp32 (4) values
template <bool BF16>
__device__ __forceinline__ float elem(const uint4& v, int e) {
  if constexpr (BF16) {
    const uint32_t w = (&v.x)[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __uint_as_float((&v.x)[e]);
  }
}

template <bool BF16, int E>
__device__ __forceinline__ uint4 pack(const float (&d)[E]) {
  if constexpr (BF16) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  return make_uint4(__float_as_uint(d[0]), __float_as_uint(d[1]), __float_as_uint(d[2]),
                    __float_as_uint(d[3]));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The N (1 or 3) sums of a group of gw warps (warps first .. first + gw -
// 1), in every lane: a butterfly in each warp (every lane gets the same
// bits), then the warps' sums added in warp order behind the group's named
// barrier. `red` is one of two slots, used in turn, so that a slot is
// rewritten only after every warp of the group has passed the other slot's
// barrier.
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N], float* red, int first, int gw,
                                          int warp, int lane, int bar) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int m = 16; m; m >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], m);
  if (gw == 1) return;
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp * 4 + i] = v[i];
  bar_sync(bar, gw * 32);
  if constexpr (N == 1) {
    float s = red[first * 4];
    for (int w = 1; w < gw; ++w) s += red[(first + w) * 4];
    v[0] = s;
  } else {
    const float4* r4 = reinterpret_cast<const float4*>(red) + first;
    float4 s = r4[0];
    for (int w = 1; w < gw; ++w) s = add4(s, r4[w]);
    v[0] = s.x;
    v[1] = s.y;
    v[2] = s.z;
  }
}

// A wait that has lasted 2^32 cycles (about 2 s) traps, a fault the next
// synchronise reports, where a fault in the ring's or the barrier's
// bookkeeping would otherwise hang the card.
constexpr long long WAIT_LIMIT = 1ll << 32;

// until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

// every block of the cooperative launch past this point once all have reached it
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    // the block's writes (ordered before this thread's by the barrier above)
    // released with the count
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
    const long long t0 = clock64();
    unsigned seen = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
      if (seen >= n) break;
      if (clock64() - t0 > WAIT_LIMIT) __trap();
    }
  }
  __syncthreads();
}

// Block b's stripe of the 2C columns, as float4 quads [q0, q1), summed over
// the nb partial rows: `width` quads at a time, each by up to MAX_SLICES
// threads, slice s summing rows s, s + ns, ... in order (two loads in
// flight); then the slices added in slice order, in runs of 8 and then the
// runs. The order depends on (C, nb, threads) alone.
__device__ void column_sum(const float* part, float* out, int C, int nb, int b, int tid,
                           int threads, float4* scratch) {
  const int Q = C / 2;
  const int q0 = static_cast<int>(static_cast<long long>(b) * Q / nb);
  const int q1 = static_cast<int>(static_cast<long long>(b + 1) * Q / nb);
  const int nq = q1 - q0, qw = (Q + nb - 1) / nb;
  const int width = min(qw, threads), ns = min(MAX_SLICES, threads / width);
  const int s = tid / width, jj = tid % width;
  const float4* p4 = reinterpret_cast<const float4*>(part) + q0;
  float4* o4 = reinterpret_cast<float4*>(out) + q0;
  for (int j0 = 0; j0 < qw; j0 += width) {
    const int j = j0 + jj;
    if (s < ns && j < nq) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      int r = s;
      for (; r + ns < nb; r += 2 * ns) {
        const float4 a0 = __ldcg(p4 + static_cast<size_t>(r) * Q + j);
        const float4 a1 = __ldcg(p4 + static_cast<size_t>(r + ns) * Q + j);
        acc = add4(add4(acc, a0), a1);
      }
      if (r < nb) acc = add4(acc, __ldcg(p4 + static_cast<size_t>(r) * Q + j));
      scratch[s * width + jj] = acc;
    }
    __syncthreads();
    const int runs = (ns + 7) / 8;
    if (s < runs && j < nq) {  // run s: slices 8 s .. 8 s + 7
      float4 t = scratch[8 * s * width + jj];
      for (int k = 8 * s + 1; k < min(ns, 8 * s + 8); ++k) t = add4(t, scratch[k * width + jj]);
      scratch[(ns + s) * width + jj] = t;
    }
    __syncthreads();
    if (s == 0 && j < nq) {
      float4 t = scratch[ns * width + jj];
      for (int k = 1; k < runs; ++k) t = add4(t, scratch[(ns + k) * width + jj]);
      o4[j] = t;
    }
    __syncthreads();
  }
}

// A row of a group: dx stored from registers, the row's shares of dg and
// db added to the thread's sums. xv, dv: the thread's vectors of x and dy.
template <bool BF16, int VPT>
__device__ __forceinline__ void row_math(const uint4 (&xv)[VPT], const uint4 (&dv)[VPT],
                                         char* out, const float* gs,
                                         float (&acc_g)[VPT][BF16 ? 8 : 4],
                                         float (&acc_b)[VPT][BF16 ? 8 : 4], float* red, int t,
                                         int tg, int cvec, float inv_c, float eps, int first,
                                         int gw, int warp, int lane, int bar) {
  constexpr int E = BF16 ? 8 : 4;
  float s1[1] = {0.f};
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    if (t + k * tg < cvec)
#pragma unroll
      for (int e = 0; e < E; ++e) s1[0] += elem<BF16>(xv[k], e);
  group_sum(s1, red, first, gw, warp, lane, bar);
  const float mean = s1[0] * inv_c;
  float s3[3] = {0.f, 0.f, 0.f};  // sum (x - mean)^2, sum w, sum w (x - mean)
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = t + k * tg;
    if (v < cvec) {
      const float* gv = gs + v * E;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xc = elem<BF16>(xv[k], e) - mean, w = gv[e] * elem<BF16>(dv[k], e);
        s3[0] = fmaf(xc, xc, s3[0]);
        s3[1] += w;
        s3[2] = fmaf(w, xc, s3[2]);
      }
    }
  }
  group_sum(s3, red + 64, first, gw, warp, lane, bar);
  const float rstd = 1.f / sqrtf(s3[0] * inv_c + eps);
  const float c1 = s3[1] * inv_c, c2 = s3[2] * rstd * inv_c;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = t + k * tg;
    if (v < cvec) {
      const float* gv = gs + v * E;
      float d[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float dyv = elem<BF16>(dv[k], e), xh = (elem<BF16>(xv[k], e) - mean) * rstd;
        d[e] = (gv[e] * dyv - c1 - xh * c2) * rstd;
        acc_g[k][e] = fmaf(dyv, xh, acc_g[k][e]);
        acc_b[k][e] += dyv;
      }
      *reinterpret_cast<uint4*>(out + v * 16) = pack<BF16, E>(d);
    }
  }
}

// The row pass, and with p.whole the column sum (else the partial rows are
// left in p.part, for timing the row pass apart).
template <bool BF16, int VPT>
__global__ void __launch_bounds__(MAX_THREADS, 1) ln_bwd_ring(const Params p) {
  constexpr int E = BF16 ? 8 : 4;
  constexpr int ESZ = BF16 ? 2 : 4;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* gbar = empty + MAX_STAGES;
  float* red = reinterpret_cast<float*>(smem + BAR_BYTES);
  const float* gs = reinterpret_cast<const float*>(smem + BAR_BYTES + RED_BYTES);
  unsigned char* ring = smem + BAR_BYTES + RED_BYTES + 4 * p.C;

  const int nt = p.groups * p.tg;  // consumer threads
  const int tid = threadIdx.x, b = blockIdx.x;
  const int row_bytes = p.C * ESZ, cvec = row_bytes / 16;
  const int lo = static_cast<int>(static_cast<long long>(b) * p.R / p.nb);
  const int hi = static_cast<int>(static_cast<long long>(b + 1) * p.R / p.nb);
  const int n_rows = hi - lo;
  const int n_steps = (n_rows + p.groups - 1) / p.groups;  // stages the block walks
  const size_t stage_bytes = static_cast<size_t>(p.groups) * 2 * row_bytes;

  if (tid < p.stages) {
    mbar_init(&full[tid], 1);
    mbar_init(&empty[tid], nt / 32);
  }
  if (tid == 0) mbar_init(gbar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  float acc_g[VPT][E], acc_b[VPT][E];
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) acc_g[k][e] = acc_b[k][e] = 0.f;
  const int grp = tid / p.tg, t = tid % p.tg;

  if (tid == nt) {
    // the producer: stage i (rows lo + i groups + j, j < groups) into slot
    // i % stages once every consumer warp has released it
    const char* xrows = static_cast<const char*>(p.x);
    const char* dyrows = static_cast<const char*>(p.dy);
    mbar_expect_tx(gbar, 4 * p.C);
    bulk_load(const_cast<float*>(gs), p.g, 4 * p.C, gbar);
    for (int i = 0; i < n_steps; ++i) {
      const int slot = i % p.stages, r0 = i * p.groups, rows = min(p.groups, n_rows - r0);
      if (i >= p.stages) wait_phase(&empty[slot], ((i / p.stages) - 1) & 1);
      mbar_expect_tx(&full[slot], rows * 2 * row_bytes);
      for (int j = 0; j < rows; ++j) {
        unsigned char* dst = ring + slot * stage_bytes + static_cast<size_t>(j) * 2 * row_bytes;
        const long long r = lo + r0 + j;
        bulk_load(dst, xrows + r * p.sx * ESZ, row_bytes, &full[slot]);
        bulk_load(dst + row_bytes, dyrows + r * p.sdy * ESZ, row_bytes, &full[slot]);
      }
    }
  } else if (tid < nt) {
    // the consumers: at step i, group grp takes row i groups + grp of the
    // stage in slot i % stages
    const int warp = tid >> 5, lane = tid & 31, gw = p.tg >> 5, first = grp * gw;
    const float inv_c = 1.f / static_cast<float>(p.C);
    wait_phase(gbar, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int slot = i % p.stages, row = i * p.groups + grp;
      wait_phase(&full[slot], (i / p.stages) & 1);
      const unsigned char* src =
          ring + slot * stage_bytes + static_cast<size_t>(grp) * 2 * row_bytes;
      uint4 xv[VPT], dv[VPT];
      if (row < n_rows) {
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          const int v = t + k * p.tg;
          if (v < cvec) {
            xv[k] = *reinterpret_cast<const uint4*>(src + v * 16);
            dv[k] = *reinterpret_cast<const uint4*>(src + row_bytes + v * 16);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);  // the row is in registers
      if (row < n_rows)  // the same for the whole group
        row_math<BF16, VPT>(xv, dv,
                            static_cast<char*>(p.dx) + static_cast<long long>(lo + row) * row_bytes,
                            gs, acc_g, acc_b, red, t, p.tg, cvec, inv_c, p.eps, first, gw, warp,
                            lane, 1 + grp);
    }
  }
  __syncthreads();  // every row consumed: the ring is free

  // the block's partial rows of dg and db: the groups' sums in group order
  float* part = p.part + static_cast<size_t>(b) * 2 * p.C;
  if (p.groups == 1) {
    if (tid < nt)
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int v = t + k * p.tg;
        if (v < cvec)
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            *reinterpret_cast<float4*>(part + v * E + e) =
                make_float4(acc_g[k][e], acc_g[k][e + 1], acc_g[k][e + 2], acc_g[k][e + 3]);
            *reinterpret_cast<float4*>(part + p.C + v * E + e) =
                make_float4(acc_b[k][e], acc_b[k][e + 1], acc_b[k][e + 2], acc_b[k][e + 3]);
          }
      }
  } else {
    float* comb = reinterpret_cast<float*>(ring);  // (groups, 2C)
    if (tid < nt) {
      float* mine = comb + static_cast<size_t>(grp) * 2 * p.C;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int v = t + k * p.tg;
        if (v < cvec)
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            *reinterpret_cast<float4*>(mine + v * E + e) =
                make_float4(acc_g[k][e], acc_g[k][e + 1], acc_g[k][e + 2], acc_g[k][e + 3]);
            *reinterpret_cast<float4*>(mine + p.C + v * E + e) =
                make_float4(acc_b[k][e], acc_b[k][e + 1], acc_b[k][e + 2], acc_b[k][e + 3]);
          }
      }
    }
    __syncthreads();
    const float4* c4 = reinterpret_cast<const float4*>(comb);
    const int Q = p.C / 2;
    for (int q = tid; q < Q; q += blockDim.x) {
      float4 s = c4[q];
      for (int j = 1; j < p.groups; ++j) s = add4(s, c4[j * Q + q]);
      reinterpret_cast<float4*>(part)[q] = s;
    }
  }
  if (!p.whole) return;
  grid_barrier(p.counter, p.nb);
  column_sum(p.part, p.dgb, p.C, p.nb, b, tid, blockDim.x, reinterpret_cast<float4*>(ring));
  __syncthreads();
  // the last block out sets both counters back to 0: every block has left
  // the barrier before it counts itself here
  if (tid == 0 && atomicAdd(&p.counter[1], 1u) == static_cast<unsigned>(p.nb - 1)) {
    atomicExch(&p.counter[0], 0u);
    atomicExch(&p.counter[1], 0u);
  }
}

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block can have on an H100
constexpr int MAX_DEVICES = 64;

template <bool BF16, int VPT>
cudaError_t launch(const Params& p, int threads, int smem, cudaStream_t st) {
  const auto kernel = ln_bwd_ring<BF16, VPT>;
  // the kernel's shared-memory limit raised once a device, to what a block can have
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  void* args[] = {const_cast<Params*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(p.nb),
                                     dim3(threads), args, smem, st);
}

using Launch = cudaError_t (*)(const Params&, int, int, cudaStream_t);

// the instantiations: (bf16, vectors a thread)
Launch pick(int bf16, int vpt) {
#define LN_BWD_PICK(B, V) \
  if ((bf16 != 0) == B && vpt == V) return launch<B, V>;
  LN_BWD_PICK(true, 1) LN_BWD_PICK(true, 2) LN_BWD_PICK(true, 3)
  LN_BWD_PICK(false, 1) LN_BWD_PICK(false, 2) LN_BWD_PICK(false, 3) LN_BWD_PICK(false, 4)
#undef LN_BWD_PICK
  return nullptr;
}

}  // namespace

// x, dy (R, C) of one dtype, bf16 (bf16 != 0) or fp32, unit column stride,
// row strides sx and sdy elements, 16-byte aligned rows; g (C,) fp32; dx
// (R, C) contiguous in x's dtype; part (nb, 2C) fp32 scratch; dgb (2C,) fp32
// (dg, then db); counter two zeroed unsigned ints, left at 0. The plan
// (vpt, tg, groups, stages, nb, smem) is ring_shape's in
// kernels/rmsnorm/kernel.py; threads = groups tg + 32. whole == 0 runs the
// row pass alone (dx and the partial rows, no dg or db). One cooperative
// launch; returns its error.
extern "C" int layernorm_bwd_ring(const void* x, const void* dy, const void* g, void* dx,
                                  void* part, void* dgb, void* counter, long long sx,
                                  long long sdy, int R, int C, int bf16, int vpt, int tg,
                                  int groups, int stages, int nb, int smem, int whole, float eps,
                                  void* stream) {
  const Launch fn = pick(bf16, vpt);
  const int threads = groups * tg + 32;
  if (fn == nullptr || stages > MAX_STAGES || stages < 1 || tg % 32 != 0 ||
      threads > MAX_THREADS || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dy, static_cast<const float*>(g), dx, static_cast<float*>(part),
           static_cast<float*>(dgb), static_cast<unsigned*>(counter), sx, sdy, R, C, nb, tg,
           groups, stages, whole, eps};
  return static_cast<int>(fn(p, threads, smem, static_cast<cudaStream_t>(stream)));
}
