// Montgomery multiply of 11-bit-limb field elements for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K4 of bellman_mpc_tpu/ops/pallas_kernels.py:
//   bmt_mont_mul <- _jit_mont_mul_pallas (body _mont_mul_block), which the
//   h(x) pipeline runs for its coset pointwise product.
// The plain PyTorch version is LimbField.mul (fields/limb.py), which
// ops/mont_kernels.py takes for CPU tensors; raw output limbs equal it.
//
// Layout: a, b, out are (L, n) int32 limb tensors, limb-major, lazy values
// (< 2p) with canonical 11-bit digits.  The arithmetic is the reference's:
// full schoolbook product columns, L word-by-word reduction steps (the m of
// each step keeps only its low 11 bits, so the product that wraps in int32
// in the reference is taken in uint32 here: no signed overflow), 4 flat carry
// folds that drop the top limb's carry, then a generate/propagate carry pass.
// Every column stays below L (2^11-1)^2 + L (2^11-1)^2 < 2^31.
//
// What bounds it on this card: per lane 3 L int32 words move (a, b in, out).
// This 11-bit-limb algorithm spends about 1,650 integer operations per lane
// at L = 24, but a Montgomery product of 8 32-bit words needs a few hundred,
// so the function is bound by memory; at the prover's shapes (16384 lanes)
// the launch itself dominates.
//
// What the design does about it: one thread per lane, so each limb row's
// loads and stores are coalesced across a warp; the kernel is templated on
// L and fully unrolled, so the 2L product columns and the L limbs of b stay
// in registers and nothing but the output is written.  The carry pass is a
// sequential ripple per lane, which gives the same digits as the
// reference's log-depth prefix scan.  Faster variants (several lanes per
// thread, 32-bit limbs) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t LIMB_BITS = 11;
constexpr uint32_t LIMB_MASK = (1u << LIMB_BITS) - 1;
constexpr int THREADS = 256;
constexpr int MAX_L = 36;

struct Modulus {
  uint32_t p[MAX_L];  // limbs of p, low first
  uint32_t n0inv;     // -p^-1 mod 2^11
};

template <int L>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                const Modulus mod, int n) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  uint32_t bj[L];
#pragma unroll
  for (int j = 0; j < L; ++j) bj[j] = (uint32_t)b[(size_t)j * n + lane];

  // schoolbook product columns t[c] = sum_{i+j=c} a_i b_j
  uint32_t t[2 * L];
#pragma unroll
  for (int c = 0; c < 2 * L; ++c) t[c] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = (uint32_t)a[(size_t)i * n + lane];
#pragma unroll
    for (int j = 0; j < L; ++j) t[i + j] += ai * bj[j];
  }

  // word-by-word Montgomery reduction
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t ti = t[i] + carry;
    const uint32_t m = (ti * mod.n0inv) & LIMB_MASK;
    carry = (ti + m * mod.p[0]) >> LIMB_BITS;
#pragma unroll
    for (int j = 1; j < L; ++j) t[i + j] += m * mod.p[j];
  }
  t[L] += carry;

  // 4 flat carry folds on r = t[L:]; the top limb's carry is dropped
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int k = L - 1; k > 0; --k) t[L + k] = (t[L + k] & LIMB_MASK) + (t[L + k - 1] >> LIMB_BITS);
    t[L] &= LIMB_MASK;
  }

  // generate/propagate carry pass: carry_out = g | (p & carry_in)
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const uint32_t r = t[L + k];
    out[(size_t)k * n + lane] = (int)((r + c) & LIMB_MASK);
    c = (uint32_t)(r > LIMB_MASK) | ((uint32_t)(r == LIMB_MASK) & c);
  }
}

}  // namespace

// Plain C entry point: launches on `stream`, does not synchronise, and
// returns cudaGetLastError() right after its launch.  p_limbs is a HOST
// array of L limbs; L must be one of the instantiated widths (2, 24, 36).

extern "C" int bmt_mont_mul(const int* a, const int* b, int* out, const int* p_limbs, int L,
                            int n0inv, int n, void* stream) {
  if (n <= 0) return 0;
  if (L <= 0 || L > MAX_L) return (int)cudaErrorInvalidValue;
  Modulus mod = {};
  for (int j = 0; j < L; ++j) mod.p[j] = (uint32_t)p_limbs[j];
  mod.n0inv = (uint32_t)n0inv;
  const dim3 grid((n + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 2: mont_mul_kernel<2><<<grid, THREADS, 0, s>>>(a, b, out, mod, n); break;
    case 24: mont_mul_kernel<24><<<grid, THREADS, 0, s>>>(a, b, out, mod, n); break;
    case 36: mont_mul_kernel<36><<<grid, THREADS, 0, s>>>(a, b, out, mod, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
