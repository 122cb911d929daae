// Candidate tables of the analytical mapper, for Hopper (sm_90a).
//
// Replaces repro/core/mapper_jax.py::_tables_kernel, the jitted XLA pass of
// the JAX package's mapper that prices every candidate row of a chunk. A row
// is one (tile, subtile) mapping of one (hardware, GEMM shape) pair; its
// tables are ~60 int64 and float64 operations with no reduction across rows
// (repro_torch/core/mapper.py::_tables, which this kernel follows statement
// for statement): the subtile's systolic cycles, the two level-1 schedules
// under both pipeline options, the level-2 steps and traffic, and the four
// pipeline totals (inf where the option does not fit the buffers).
//
// Every output must be numpy's, bit for bit, so:
//   * each value keeps numpy's type: the shape and tile columns are int64,
//     and the four byte columns are int64, or float64 where a sub-byte width
//     made numpy promote them (the template's TA, TB, TO, TC; the 16 type
//     mixes are all instantiated). An int64 product meets a float64 width as
//     numpy meets it, converted where C++ converts it, left to right;
//   * -(-a // b) is a ceiling: int64 floor division as Python defines it,
//     and for float64 the algorithm of numpy's npy_divmod (fmod, then the
//     quotient snapped to an integer), which torch's floor division shares;
//   * np.round is rint (half to even), np.sqrt and '/' are IEEE (no
//     fast-math), and the build passes -fmad=false (kernels/_build.py), so
//     no a*b + c is contracted into an FMA that numpy does not do;
//   * np.maximum / np.minimum of mixed types compare in the common type.
//
// Bound on an H100: bytes. A row reads its six tile sizes (48 bytes) and its
// four pipeline flags (4) and writes 98 bytes: four totals, two tile times,
// the step time and write-back time (8 each), the steps and three tile
// counts (8 each) and two scheme flags (1 each). 150 bytes a row, e.g.
// 65536 rows (the mapper's chunk budget) in 2.9 us at 3.35 TB/s. The
// per-pair scalars (hardware and shape, ~150 bytes a pair) are negligible.
// The arithmetic is int64 division, which Hopper runs as a software
// sequence of ~100 instructions: ~20 divisions a row make the kernel bound
// by issue, not by bytes, at any chunk the mapper builds.
//
// Design (simple first). One thread a row, 256 to a block. The device and
// shape scalars stay per pair (the gather's collapsed columns are not
// densified): a thread finds its pair by a binary search of the chunk's row
// offsets and reads the pair's scalars, which all its neighbours share
// (broadcast loads from L1). The tile columns are column-major, so a warp
// reads each of them coalesced; the outputs are numpy's row-major arrays
// packed into one buffer, so the wrapper copies them back in one transfer.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int N_INT = 11;  // sa_rows sa_cols lanes cores gb_bw_cyc vec_tp m k n batch b_shared
constexpr int N_FLT = 3;   // freq mem_bw mac_scale

// Python's floor division of int64.
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  const int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}

// numpy's npy_floor_divide of float64 (npy_divmod's quotient).
__device__ __forceinline__ double floordiv(double a, double b) {
  if (b == 0.0) return a / b;
  double mod = fmod(a, b);
  double div = (a - mod) / b;
  if (mod != 0.0) {
    if ((b < 0.0) != (mod < 0.0)) {
      mod += b;
      div -= 1.0;
    }
  }
  double fl;
  if (div != 0.0) {
    fl = floor(div);
    if (div - fl > 0.5) fl += 1.0;
  } else {
    fl = copysign(0.0, a / b);
  }
  return fl;
}

// a // b in numpy's common type of a and b.
template <class A, class B>
__device__ __forceinline__ auto fdiv(A a, B b) {
  using R = decltype(a + b);
  return floordiv(static_cast<R>(a), static_cast<R>(b));
}

// -(-a // b): the tables' ceiling division.
template <class A, class B>
__device__ __forceinline__ auto cdiv(A a, B b) {
  return -fdiv(-a, b);
}

// np.maximum / np.minimum in the common type.
template <class A, class B>
__device__ __forceinline__ auto vmax(A a, B b) {
  using R = decltype(a + b);
  const R x = static_cast<R>(a), y = static_cast<R>(b);
  return x >= y ? x : y;
}

template <class A, class B>
__device__ __forceinline__ auto vmin(A a, B b) {
  using R = decltype(a + b);
  const R x = static_cast<R>(a), y = static_cast<R>(b);
  return x <= y ? x : y;
}

// A byte-width column: int64 values, or float64 bits kept in an int64 slot.
template <class T>
__device__ __forceinline__ T width(int64_t bits) {
  if constexpr (std::is_same_v<T, double>) {
    return __longlong_as_double(bits);
  } else {
    return bits;
  }
}

// systolic.py::gemm_cycles_array for one subtile.
__device__ __forceinline__ int64_t gemm_cycles(int64_t m, int64_t k, int64_t n, int64_t rows,
                                               int64_t cols) {
  const int64_t full_r = floordiv(m, rows), rem_r = m - full_r * rows;
  const int64_t full_c = floordiv(n, cols), rem_c = n - full_c * cols;
  auto pc = [k](int64_t r_occ, int64_t c_occ) { return 2 * r_occ + c_occ + k - 2; };
  int64_t total = full_r * full_c * pc(rows, cols);
  total = total + (rem_r > 0 ? full_c * pc(rem_r, cols) : 0);
  total = total + (rem_c > 0 ? full_r * pc(rows, rem_c) : 0);
  total = total + ((rem_r > 0 && rem_c > 0) ? pc(rem_r, rem_c) : 0);
  return total;
}

template <class TA, class TB, class TO, class TC>
__global__ void __launch_bounds__(THREADS)
mapper_tables_kernel(const int64_t* __restrict__ cols, const uint32_t* __restrict__ p_ok,
                     const int64_t* __restrict__ offs, const int64_t* __restrict__ pint,
                     const double* __restrict__ pflt, const int64_t* __restrict__ pbytes,
                     uint8_t* __restrict__ out, int64_t rows, int pairs) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (r >= rows) return;
  // the pair whose rows hold r: the last p with offs[p] <= r (an empty pair
  // shares its offset with the next one and is never found)
  int lo = 0, hi = pairs;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid] <= r) lo = mid; else hi = mid;
  }
  const int64_t* pi = pint + static_cast<int64_t>(lo) * N_INT;
  const double* pf = pflt + static_cast<int64_t>(lo) * N_FLT;
  const int64_t* pb = pbytes + static_cast<int64_t>(lo) * 4;
  const int64_t sa_rows = pi[0], sa_cols = pi[1], lanes = pi[2], cores = pi[3];
  const int64_t gb_bw_cyc = pi[4], vec_tp = pi[5];
  const int64_t m_v = pi[6], k_v = pi[7], n_v = pi[8], batch_v = pi[9];
  const bool bshared_v = pi[10] != 0;
  const double freq = pf[0], mem_bw = pf[1], mac_scale_v = pf[2];
  const TA bytes_a_v = width<TA>(pb[0]);
  const TB bytes_b_v = width<TB>(pb[1]);
  const TO bytes_out_v = width<TO>(pb[2]);
  const TC bytes_acc_v = width<TC>(pb[3]);

  const int64_t TM_ = cols[r], TK_ = cols[rows + r], TN_ = cols[2 * rows + r];
  const int64_t SM_ = cols[3 * rows + r], SK_ = cols[4 * rows + r], SN_ = cols[5 * rows + r];
  const uint32_t ok = p_ok[r];

  // ---------------- level 0: core compute time for one subtile ----------
  const int64_t sn_lane = cdiv(SN_, lanes);
  int64_t subtile_cyc = gemm_cycles(SM_, SK_, sn_lane, sa_rows, sa_cols);
  subtile_cyc = static_cast<int64_t>(ceil(static_cast<double>(subtile_cyc) / mac_scale_v));

  // ---------------- level 1: schedule subtiles across cores -------------
  const int64_t n_sub_m = cdiv(TM_, SM_);
  const int64_t n_sub_n = cdiv(TN_, SN_);
  const int64_t n_sub_k = cdiv(TK_, SK_);

  // -- scheme 1: distinct C subtiles per core, k-loop inside core --------
  const int64_t out_subtiles = n_sub_m * n_sub_n;
  const int64_t waves = cdiv(out_subtiles, cores);
  const int64_t w = vmin(out_subtiles, cores);
  const int64_t gm = vmin(n_sub_m, static_cast<int64_t>(vmax(1.0, rint(sqrt(static_cast<double>(w))))));
  const int64_t gn = vmin(n_sub_n, vmax(int64_t{1}, cdiv(w, gm)));
  const auto wave_traffic = gm * SM_ * TK_ * bytes_a_v + gn * TK_ * SN_ * bytes_b_v
      + gm * gn * SM_ * SN_ * bytes_out_v;
  const auto wave_mem_cyc = cdiv(wave_traffic, gb_bw_cyc);
  const int64_t wave_cmp_cyc = n_sub_k * subtile_cyc;
  const auto s1_db0 = waves * (wave_mem_cyc + wave_cmp_cyc);
  const auto s1_db1 = waves * vmax(wave_mem_cyc, wave_cmp_cyc) + vmin(wave_mem_cyc, wave_cmp_cyc);

  // -- scheme 2: split K of each C subtile across spare cores ------------
  const int64_t ck = vmax(int64_t{1}, vmin(fdiv(cores, vmax(out_subtiles, int64_t{1})), n_sub_k));
  const int64_t k_per_core = cdiv(n_sub_k, ck);
  const int64_t s2_cmp_cyc = k_per_core * subtile_cyc;
  const auto red_traffic = (2 * (ck - 1)) * SM_ * SN_ * bytes_acc_v;
  const auto red_cyc = cdiv(red_traffic, gb_bw_cyc)
      + cdiv((ck - 1) * SM_ * SN_, vmax(vec_tp * cores, int64_t{1}));
  const int64_t s2_waves = cdiv(out_subtiles * ck, cores);
  const auto s2_traffic = SM_ * TK_ * bytes_a_v + TK_ * SN_ * bytes_b_v;
  const auto s2_mem_cyc = cdiv(fdiv(s2_traffic * out_subtiles, vmax(s2_waves, int64_t{1})), gb_bw_cyc);
  const auto s2_db0 = s2_waves * (s2_mem_cyc + s2_cmp_cyc) + red_cyc;
  const auto s2_db1 = s2_waves * vmax(s2_mem_cyc, s2_cmp_cyc) + red_cyc;

  const bool use0 = s2_db0 < s1_db0, use1 = s2_db1 < s1_db1;
  using R0 = decltype(s2_db0 + s1_db0);
  using R1 = decltype(s2_db1 + s1_db1);
  const double tt0 = static_cast<double>(use0 ? static_cast<R0>(s2_db0) : static_cast<R0>(s1_db0)) / freq;
  const double tt1 = static_cast<double>(use1 ? static_cast<R1>(s2_db1) : static_cast<R1>(s1_db1)) / freq;

  // ---------------- level 2: main memory <-> global buffer --------------
  const int64_t n_t_m = cdiv(m_v, vmin(TM_, m_v));
  const int64_t n_t_n = cdiv(n_v, vmin(TN_, n_v));
  const int64_t n_t_k = cdiv(k_v, vmin(TK_, k_v));
  const int64_t steps = batch_v * n_t_m * n_t_n * n_t_k;
  const auto a_bytes_step = TM_ * TK_ * bytes_a_v;
  const auto b_bytes_step = TK_ * TN_ * bytes_b_v;
  const auto c_bytes_tile = TM_ * TN_ * bytes_out_v;
  // B re-read only once per k-sweep regardless of batch when b_shared
  const double step_mem_t = (bshared_v && batch_v > 1)
      ? (a_bytes_step + static_cast<double>(b_bytes_step) / static_cast<double>(batch_v)) / mem_bw
      : static_cast<double>(a_bytes_step + b_bytes_step) / mem_bw;
  const double c_mem_t = static_cast<double>(c_bytes_tile) / mem_bw;
  const double c_total_t = batch_v * n_t_m * n_t_n * c_mem_t;

  // outputs, numpy's row-major arrays packed one after another
  double* totals = reinterpret_cast<double*>(out);
  double* tile_time = totals + 4 * rows;
  double* o_step_mem_t = tile_time + 2 * rows;
  double* o_c_total_t = o_step_mem_t + rows;
  int64_t* o_steps = reinterpret_cast<int64_t*>(o_c_total_t + rows);
  int64_t* o_n_t_m = o_steps + rows;
  int64_t* o_n_t_n = o_n_t_m + rows;
  int64_t* o_n_t_k = o_n_t_n + rows;
  uint8_t* use_s2 = reinterpret_cast<uint8_t*>(o_n_t_k + rows);

  const double tt[2] = {tt0, tt1};
#pragma unroll
  for (int p = 0; p < 4; ++p) {  // _DB_OPTIONS: (db2, db1) = (p >> 1, p & 1)
    const double t = tt[p & 1];
    double tot;
    if (p >> 1) {
      tot = steps * vmax(step_mem_t, t) + c_total_t + vmin(step_mem_t, t);
    } else {
      tot = steps * (step_mem_t + t) + c_total_t;
    }
    totals[4 * r + p] = ((ok >> (8 * p)) & 0xffu) ? tot : __longlong_as_double(0x7ff0000000000000LL);
  }
  tile_time[2 * r] = tt0;
  tile_time[2 * r + 1] = tt1;
  o_step_mem_t[r] = step_mem_t;
  o_c_total_t[r] = c_total_t;
  o_steps[r] = steps;
  o_n_t_m[r] = n_t_m;
  o_n_t_n[r] = n_t_n;
  o_n_t_k[r] = n_t_k;
  use_s2[2 * r] = use0;
  use_s2[2 * r + 1] = use1;
}

template <class TA, class TB, class TO, class TC>
void launch(const int64_t* cols, const uint32_t* p_ok, const int64_t* offs, const int64_t* pint,
            const double* pflt, const int64_t* pbytes, uint8_t* out, int64_t rows, int pairs,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + THREADS - 1) / THREADS);
  mapper_tables_kernel<TA, TB, TO, TC><<<blocks, THREADS, 0, stream>>>(
      cols, p_ok, offs, pint, pflt, pbytes, out, rows, pairs);
}

template <class... Ts>
void dispatch(int mask, int bit, const int64_t* cols, const uint32_t* p_ok, const int64_t* offs,
              const int64_t* pint, const double* pflt, const int64_t* pbytes, uint8_t* out,
              int64_t rows, int pairs, cudaStream_t stream) {
  if constexpr (sizeof...(Ts) == 4) {
    launch<Ts...>(cols, p_ok, offs, pint, pflt, pbytes, out, rows, pairs, stream);
  } else {
    if (mask & (1 << bit)) {
      dispatch<Ts..., double>(mask, bit + 1, cols, p_ok, offs, pint, pflt, pbytes, out, rows,
                              pairs, stream);
    } else {
      dispatch<Ts..., int64_t>(mask, bit + 1, cols, p_ok, offs, pint, pflt, pbytes, out, rows,
                               pairs, stream);
    }
  }
}

}  // namespace

// cols: int64 [6, rows] (tm tk tn sm sk sn); p_ok: [rows] x 4 bytes (one a
// pipeline option); offs: int64 [pairs + 1], the pairs' first rows; pint:
// int64 [pairs, 11]; pflt: float64 [pairs, 3]; pbytes: [pairs, 4] byte
// widths (a, b, out, acc), float64 bits where bit i of float_mask is set,
// else int64; out: 98 bytes a row (see the kernel). rows >= 1, pairs >= 1.
extern "C" int mapper_tables(const void* cols, const void* p_ok, const void* offs,
                             const void* pint, const void* pflt, const void* pbytes, void* out,
                             long long rows, int pairs, int float_mask, void* stream) {
  dispatch<>(float_mask, 0, static_cast<const int64_t*>(cols),
             static_cast<const uint32_t*>(p_ok), static_cast<const int64_t*>(offs),
             static_cast<const int64_t*>(pint), static_cast<const double*>(pflt),
             static_cast<const int64_t*>(pbytes), static_cast<uint8_t*>(out), rows, pairs,
             static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
