// Montgomery products of 11-bit-limb field elements, on 32-bit words, for
// Hopper (sm_90a): K4 the product fused, K5 and K6 its two halves.
//
// K4 replaces the TPU kernel K4 of bellman_mpc_tpu/ops/pallas_kernels.py:
//   bmt_mont_mul <- _jit_mont_mul_pallas (body _mont_mul_block).
// Every LimbField.mul of the port on a CUDA tensor launches it
// (ops/mont_kernels.py): the h(x) pipeline's NTT stages, scalings and
// coset product, Montgomery conversions, and the Fermat inversions of
// decode.  The plain PyTorch version is LimbField.mul_plain; raw output
// limbs equal it.
//
// K4's function.  a, b are lazy (< 2p) with canonical 11-bit digits, L of
// them; R = 2^(11L).  The plain version (and the reference) computes
//   out = the canonical 11-bit digits of (a b + M p) / R,
//   M = -a b p^-1 mod R, taken in [0, R), with no final subtraction:
// its word-by-word reduction picks L digits m_i in [0, 2^11), so its M lies
// in [0, R) and solves a b + M p = 0 mod R, which makes it THE solution
// there; its folds and carry pass then give the canonical digits of that
// value, which is below 2p < R.  So any exact reduction that ends at the
// same R gives the same limbs, whatever its word size.  This kernel:
//   1. packs the limbs of a and b into N 32-bit words (N = 8 for Fr, 12 for
//      Fp; a value below 2p fits);
//   2. runs CIOS Montgomery over S = floor(11L / 32) whole words (S = N for
//      Fr and Fp), m_i = -t_0 p^-1 mod 2^32, each row a carry chain of
//      64-bit accumulators (mul.wide.u32);
//   3. takes one final step over the remaining 11L - 32S bits (Fr 8, Fp 12,
//      the mock field's L = 2: all 22, S = 0), m' = -t_0 p^-1 mod 2^(11L-32S),
//      so M = sum m_i 2^(32 i) + m' 2^(32 S) lies in [0, R);
//   4. unpacks the result into L canonical 11-bit digits.
// Bounds: t < 3p < 2^(32N + 1) after the whole-word steps, so N + 1 words
// hold it; every 64-bit accumulator stays below 2^64.
//
// What bounded the first design: it ran the TPU kernel's algorithm, about
// 1,650 integer operations per lane on 11-bit limbs at L = 24, one thread
// per lane in 256-thread blocks: 32 blocks for 132 SMs at the h(x)
// pipeline's 8192 lanes, half of one warp at decode's 16.  What this
// design does: a product on 32-bit words needs about 560 operations at
// L = 24 (2 N^2 word products with their carries), and blocks of 64
// threads spread 8192 lanes over 128 blocks.  What bounds it now is one
// lane's latency (the loads, the carry chains, the store) plus the launch:
// on the H100 it takes about 0.003 ms at 512 lanes and barely more at
// 16384.  Two designs measured against it were slower at every shape of
// the port (PERF.md, K4's findings): 2, 4 or 8 threads per lane, each
// owning a few words of the accumulator and passing m, the shifted word
// and carries with __shfl_sync; and PTX carry-flag chains (mad.lo.cc /
// madc.hi.cc) in place of the 64-bit accumulators.
//
// Operands are read through a limb stride and a two-level lane index with
// strides (0 broadcasts), so the call sites' views and broadcast constants
// need no copy; the output is a contiguous (L, n) tensor.
//
// The lazy Montgomery columns (fields/limb.py LazyCols): the same product
// split in two, with integer column arithmetic between the halves.
//
//   bmt_lazy_cols (K5), lazy_cols_kernel<L>: the schoolbook product columns
//     of two (L, n) digit tensors; plain version LimbField.mul_cols.
//   bmt_lazy_redc (K6), lazy_redc_kernel<L>: one Montgomery reduction of
//     (2L, n) non-negative int32 columns; plain version
//     LimbField.lazy_redc_plain (the carry folds of _reduce_plan, then
//     LimbField.redc_cols).
// K4 is the product fused; K5 and K6 are its split form, for the callers
// that add, subtract and scale columns before one reduction.  All three
// share the operand geometry, the modulus words and the final step.
//
// No TPU kernel is replaced by K5 or K6: the reference leaves the lazy
// columns to XLA's fusion, which makes each product and each reduction one fused
// program.  Eager PyTorch ran them as Python loops over the L limbs, about
// 220 tensor operations per stacked product and 550 per reduction at
// L = 36, each a tiny kernel of a few thousand lanes: the host's launch rate
// bounded every curve operation on the limb path (the proof assembly, the
// CRS ladders, the table build's bucket chains, the pairing's tower).
//
// K5's function: cols[c] = sum_{i+j=c} a_i b_j, column 2L - 1 zero, in
// 32-bit arithmetic that wraps as the plain int32 version does (the host's
// _product_hi proves that no column passes 2^31 - 1, also for operands
// that are raw digit sums).
//
// K6's function.  T = sum_c cols[c] 2^(11c), 0 <= T < 3pR (the host's
// _reduce_plan proves T < pR, or 3pR for wide reductions; R = 2^(11L)).
// Out: the canonical 11-bit digits of (T + M p) / R, M in [0, R) the unique
// value with T + M p = 0 mod R.  The plain version's word-by-word REDC picks
// L 11-bit digits m_i, so its M lies in [0, R) and is THAT value; its folds
// and carry passes keep the value, which is below 4p < R.  So any exact
// reduction to the same R gives the same limbs.  This kernel:
//   1. one carry pass over the 2L columns (column + carry < 2^31 + 2^21),
//      packing the canonical digits of T into TW = ceil(22L / 32) words;
//   2. S = floor(11L / 32) whole-word REDC rows: m = t_i (-p^-1) mod 2^32,
//      t += m p 2^(32 i), the row's carry and a one-bit carry that moves
//      up one word per row;
//   3. K4's final step over the remaining 11L - 32S bits (Fr 8, Fp 12, the
//      mock field's L = 2: all 22, S = 0), so M lies in [0, R);
//   4. the L digits of t >> 11L.
// t <= T + M p < 4pR < 2^(22L) all along, so TW words hold it and the top
// word never carries out.
//
// What bounds them on this card: the launch and one lane's latency.  The
// proof step calls them at about 1.5k lanes (k stacked products of a few
// points per proof), where every lane has its own thread and a few dozen
// 64-thread blocks cover the call; at the CRS ladders' and the table
// build's widths (10^4 to 10^6 lanes) the integer work does: L^2 32-bit
// multiply-adds per lane in K5 (1296 at L = 36) and S N 32x32-bit products
// with their carries in K6 (144 at L = 36).  The essential traffic is small
// (K5: 2L words in, 2L out; K6: 2L in, L out, per lane).  The design: one
// thread per lane, limb-major (column c of lane i at c n + i) so that
// neighbouring threads read and write neighbouring words; operands read in
// place through a limb stride and a two-level lane index, as K4's; K5 holds
// both operands in registers and stores each column as soon as it is
// summed, K6 holds T in TW registers; nothing goes through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t LIMB_MASK = (1u << 11) - 1;
constexpr int MAX_N = 12;
constexpr int BLOCK = 64;

struct Modulus {
  uint32_t p[MAX_N];  // words of p, low first
  uint32_t n0;        // -p^-1 mod 2^32
  uint32_t nr;        // -p^-1 mod 2^(11L - 32S)
};

// element offsets of one operand: limb l of lane i = i1 n0 + i0 lies at
// l ls + i1 s1 + i0 s0
struct Operand {
  long long ls, n0, s1, s0;
};

template <int L>
struct Shape {
  static constexpr int S = 11 * L / 32;               // whole-word CIOS / REDC steps
  static constexpr int R_BITS = 11 * L - 32 * S;      // the final step's bits
  static constexpr int N = S > 0 ? S : 1;             // words of p, and of a value below 2p
  static constexpr int TW = (22 * L + 31) / 32;       // words of a value below 2^(22L)
  static_assert(R_BITS > 0 && R_BITS < 32, "the final step takes 1-31 bits");
  static_assert(S == N || (S == 0 && N == 1), "whole-word steps cover the input words");
  static_assert(S + N == TW - 1, "K6's final carry lands in its top word");
};

__device__ __forceinline__ long long lane_offset(const Operand& o, int lane) {
  const int n0 = (int)o.n0;
  const int i1 = lane / n0;
  return i1 * o.s1 + (lane - i1 * n0) * o.s0;
}

// the L limbs at p (stride ls) packed into N words
template <int L, int N>
__device__ __forceinline__ void load_words(const int* __restrict__ p, long long ls, uint32_t (&w)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) w[k] = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint32_t v = (uint32_t)__ldg(p + l * ls);
    const int k = 11 * l / 32, sh = 11 * l % 32;
    if (k < N) w[k] |= v << sh;
    if (sh > 21 && k + 1 < N) w[k + 1] |= v >> (32 - sh);
  }
}

// x += a b over N words; returns the carry out of the top word
template <int N>
__device__ __forceinline__ uint32_t mac_row(uint32_t (&x)[N], const uint32_t (&a)[N], uint32_t b) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint64_t s = (uint64_t)a[k] * b + x[k] + c;
    x[k] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  return c;
}

// the final step over RB bits at word O: t += m' p 2^(32 O),
// m' = -t_O p^-1 mod 2^RB, which clears bits 32 O .. 32 O + RB - 1 of t;
// returns the carry out of word O + N - 1
template <int N, int RB, int O, int W>
__device__ __forceinline__ uint32_t final_step(uint32_t (&t)[W], const Modulus& mod) {
  const uint32_t mr = (t[O] * mod.nr) & ((1u << RB) - 1);
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint64_t s = (uint64_t)mr * mod.p[k] + t[O + k] + c;
    t[O + k] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  return c;
}

template <int L>
__global__ void __launch_bounds__(BLOCK)
mont_mul_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                const Modulus mod, const Operand oa, const Operand ob, int n) {
  using Sh = Shape<L>;
  constexpr int N = Sh::N, RB = Sh::R_BITS;
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= n) return;
  uint32_t aw[N], bw[N];
  load_words<L, N>(a + lane_offset(oa, lane), oa.ls, aw);
  load_words<L, N>(b + lane_offset(ob, lane), ob.ls, bw);

  uint32_t t[N + 1];  // t in N + 1 words
  if constexpr (Sh::S == 0) {
    const uint64_t ab = (uint64_t)aw[0] * bw[0];
    t[0] = (uint32_t)ab;
    t[1] = (uint32_t)(ab >> 32);
  } else {
    uint32_t p[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      p[k] = mod.p[k];
      t[k] = 0;
    }
    t[N] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {  // t = (t + a b_i + m p) / 2^32
      uint32_t x[N];
#pragma unroll
      for (int k = 0; k < N; ++k) x[k] = t[k];
      const uint32_t ca = mac_row<N>(x, aw, bw[i]);
      const uint32_t m = x[0] * mod.n0;
      const uint32_t cb = mac_row<N>(x, p, m);
      const uint64_t top = (uint64_t)t[N] + ca + cb;
#pragma unroll
      for (int k = 0; k + 1 < N; ++k) t[k] = x[k + 1];
      t[N - 1] = (uint32_t)top;
      t[N] = (uint32_t)(top >> 32);
    }
  }

  // the final step over RB bits, then t >>= RB
  t[N] += final_step<N, RB, 0>(t, mod);
  uint32_t r[N];
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = (t[k] >> RB) | (t[k + 1] << (32 - RB));

#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int k = 11 * l / 32, sh = 11 * l % 32;
    uint32_t v = k < N ? r[k] >> sh : 0u;
    if (sh > 21 && k + 1 < N) v |= r[k + 1] << (32 - sh);
    out[(size_t)l * n + lane] = (int)(v & LIMB_MASK);
  }
}

template <int L>
__global__ void __launch_bounds__(BLOCK)
lazy_cols_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                 const Operand oa, const Operand ob, int n) {
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= n) return;
  const int* pa = a + lane_offset(oa, lane);
  const int* pb = b + lane_offset(ob, lane);
  uint32_t x[L], y[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    x[l] = (uint32_t)__ldg(pa + l * oa.ls);
    y[l] = (uint32_t)__ldg(pb + l * ob.ls);
  }
#pragma unroll
  for (int c = 0; c < 2 * L - 1; ++c) {
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (c - i >= 0 && c - i < L) s += x[i] * y[c - i];  // decided at compile time
    out[(size_t)c * n + lane] = (int)s;
  }
  out[(size_t)(2 * L - 1) * n + lane] = 0;
}

template <int L>
__global__ void __launch_bounds__(BLOCK)
lazy_redc_kernel(const int* __restrict__ cols, int* __restrict__ out, const Modulus mod,
                 const Operand oc, int n) {
  using Sh = Shape<L>;
  constexpr int N = Sh::N, S = Sh::S, RB = Sh::R_BITS, TW = Sh::TW;
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= n) return;
  const int* src = cols + lane_offset(oc, lane);

  uint32_t t[TW];  // T, then T + M p, in TW words
#pragma unroll
  for (int k = 0; k < TW; ++k) t[k] = 0;
  uint32_t carry = 0;
#pragma unroll
  for (int c = 0; c < 2 * L; ++c) {
    const uint32_t v = (uint32_t)__ldg(src + c * oc.ls) + carry;
    const uint32_t d = v & LIMB_MASK;
    carry = v >> 11;
    const int k = 11 * c / 32, sh = 11 * c % 32;
    t[k] |= d << sh;
    if (sh > 21 && k + 1 < TW) t[k + 1] |= d >> (32 - sh);
  }

  uint32_t top = 0;  // the carry out of word i + N, owed to word i + N + 1
#pragma unroll
  for (int i = 0; i < S; ++i) {  // t += m p 2^(32 i), which clears word i
    const uint32_t m = t[i] * mod.n0;
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint64_t s = (uint64_t)m * mod.p[k] + t[i + k] + c;
      t[i + k] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    const uint64_t s = (uint64_t)t[i + N] + c + top;
    t[i + N] = (uint32_t)s;
    top = (uint32_t)(s >> 32);
  }

  // K4's final step at word S, which clears t's low 11L bits
  t[S + N] += final_step<N, RB, S>(t, mod) + top;

#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int q = 11 * (L + l), k = q / 32, sh = q % 32;
    uint32_t v = t[k] >> sh;
    if (sh > 21 && k + 1 < TW) v |= t[k + 1] << (32 - sh);
    out[(size_t)l * n + lane] = (int)(v & LIMB_MASK);
  }
}

template <typename Kernel>
int wave_lanes(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
  return sms * per_sm * BLOCK;
}

// consts -> mod for an instantiated L whose word count N matches consts[0];
// false otherwise
bool read_modulus(const unsigned* consts, int L, Modulus& mod) {
  const int N = L == 2 ? Shape<2>::N : L == 24 ? Shape<24>::N : L == 36 ? Shape<36>::N : -1;
  if (N < 0 || (int)consts[0] != N) return false;
  for (int k = 0; k < N; ++k) mod.p[k] = consts[1 + k];
  mod.n0 = consts[1 + N];
  mod.nr = consts[2 + N];
  return true;
}

Operand read_operand(const long long* g) { return {g[0], g[1], g[2], g[3]}; }

}  // namespace

// Lanes that one full wave of each kernel's blocks covers on the current
// device (SMs x resident blocks per SM x 64); 0 for an L that is not
// instantiated.
#define BMT_WAVE_LANES(name, kernel)                 \
  extern "C" int name(int L) {                       \
    switch (L) {                                     \
      case 2: return wave_lanes(kernel<2>);          \
      case 24: return wave_lanes(kernel<24>);        \
      case 36: return wave_lanes(kernel<36>);        \
      default: return 0;                             \
    }                                                \
  }
BMT_WAVE_LANES(bmt_mont_mul_wave_lanes, mont_mul_kernel)
BMT_WAVE_LANES(bmt_lazy_cols_wave_lanes, lazy_cols_kernel)
BMT_WAVE_LANES(bmt_lazy_redc_wave_lanes, lazy_redc_kernel)

// Plain C entry points: each launches on `stream`, does not synchronise,
// and returns cudaGetLastError() right after its launch (0 and no launch
// when n == 0).  consts: host words [N, p_0 .. p_{N-1}, -p^-1 mod 2^32,
// -p^-1 mod 2^(11L-32S)] (ops/mont_kernels.word_consts); geo: host
// [ls, n0, s1, s0] per operand (a, then b); L must be one of the
// instantiated widths (2, 24, 36).

extern "C" int bmt_mont_mul(const int* a, const int* b, int* out, const unsigned* consts,
                            const long long* geo, int L, int n, void* stream) {
  if (n == 0) return 0;
  Modulus mod = {};
  if (n < 0 || !read_modulus(consts, L, mod) || geo[1] <= 0 || geo[5] <= 0)
    return (int)cudaErrorInvalidValue;
  const Operand oa = read_operand(geo), ob = read_operand(geo + 4);
  const dim3 grid((n + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 2: mont_mul_kernel<2><<<grid, BLOCK, 0, s>>>(a, b, out, mod, oa, ob, n); break;
    case 24: mont_mul_kernel<24><<<grid, BLOCK, 0, s>>>(a, b, out, mod, oa, ob, n); break;
    case 36: mont_mul_kernel<36><<<grid, BLOCK, 0, s>>>(a, b, out, mod, oa, ob, n); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int bmt_lazy_cols(const int* a, const int* b, int* out, const long long* geo, int L, int n,
                             void* stream) {
  if (n == 0) return 0;
  if (n < 0 || geo[1] <= 0 || geo[5] <= 0) return (int)cudaErrorInvalidValue;
  const Operand oa = read_operand(geo), ob = read_operand(geo + 4);
  const dim3 grid((n + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 2: lazy_cols_kernel<2><<<grid, BLOCK, 0, s>>>(a, b, out, oa, ob, n); break;
    case 24: lazy_cols_kernel<24><<<grid, BLOCK, 0, s>>>(a, b, out, oa, ob, n); break;
    case 36: lazy_cols_kernel<36><<<grid, BLOCK, 0, s>>>(a, b, out, oa, ob, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int bmt_lazy_redc(const int* cols, int* out, const unsigned* consts, const long long* geo,
                             int L, int n, void* stream) {
  if (n == 0) return 0;
  Modulus mod = {};
  if (n < 0 || !read_modulus(consts, L, mod) || geo[1] <= 0) return (int)cudaErrorInvalidValue;
  const Operand oc = read_operand(geo);
  const dim3 grid((n + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 2: lazy_redc_kernel<2><<<grid, BLOCK, 0, s>>>(cols, out, mod, oc, n); break;
    case 24: lazy_redc_kernel<24><<<grid, BLOCK, 0, s>>>(cols, out, mod, oc, n); break;
    case 36: lazy_redc_kernel<36><<<grid, BLOCK, 0, s>>>(cols, out, mod, oc, n); break;
  }
  return (int)cudaGetLastError();
}
