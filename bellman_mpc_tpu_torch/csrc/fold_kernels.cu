// Window-fold kernels of the batched Groth16 prover for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of bellman_mpc_tpu/ops/pallas_kernels.py:
//   bmt_rns_mul  (K3) <- _jit_rns_mul_pallas; its body _rns_mul_block is
//                        TcCtx::mul_many below, the one RNS multiply of this
//                        file (the standalone kernel batches 6 lane tiles)
//   bmt_fold_g1  (K1) <- _jit_mixed_add_pallas   (one G1 fold window)
//   bmt_fold_g2  (K2) <- _jit_mixed_add_pallas_g2 (one G2 fold window)
//   bmt_tree_add_g1, bmt_tree_add_g2 (K7): one level of the tree reduction
//                        that sums each MSM's folded accumulator; no TPU
//                        kernel (the reference leaves rns_point.tree_reduce
//                        to XLA), added because the same level on PyTorch's
//                        own operators is some 330 (G1) and 950 (G2)
//                        launches, each paid for on the host
// The plain PyTorch versions sit beside the wrappers in ops/fold_kernels.py.
//
// What bounds K1 and K2: a fold window is a dependent chain of RNS
// Montgomery multiplies, each with two cross-channel base extensions (36 x
// 35 dot products per lane): K1 runs 11 per lane, K2 33 (Karatsuba makes
// each of its 11 Fp2 products three Fp products).  Their essential HBM
// traffic is small (accumulator in/out plus the gathered table points: 8 x
// 71 int32 per lane for K1, 16 x 71 for K2), so both are bound by latency:
// the extension dot products and the block barriers between the stages of
// each multiply.
//
// What TcCtx::mul_many does about it:
//   * The extensions run on the FP64 tensor cores: each is a (40 targets x
//     36 sources) x (36 x 8 lanes) product, 5 warp tiles of 9 mma.m8n8k4
//     f64 steps.  Residues, W entries and every partial sum are integers
//     below 35 * 4095^2 < 2^30 < 2^53, so every product and sum is exact in
//     double and any summation order gives the same value; no operand split
//     and no recombination are needed.
//   * A block covers 8 lanes x 80 padded rows (640 threads, 20 warps).
//     Thread (x, r) owns lane x, row r, and every RnsVal intermediate is
//     one register per thread; channelwise work (products, K*p adds,
//     scales) is per thread, with the exact 32-bit Barrett reduction.
//   * Independent products run as one batch of at most NMAX = 6: their
//     extension tiles spread over the 20 warps and the batch shares three
//     block barriers.  K1 batches the 5, then 6 products of a mixed addition
//     (6 barriers per window).  K2's 15, then 18 Fp products go in batches
//     of two whole Karatsuba triples, each batch followed by its triples'
//     subs (18 barriers per window); products consume no K*p row, so the
//     subs still take the rows in the reference's order.
//   * The warp that computes an extension tile also finishes its 8 targets
//     x 8 lanes in registers (reduction, r', xi2, the Shenoy-Kumaresan
//     alpha on the m_r target), so nothing else waits on a barrier for it.
//   * Blocks are persistent: a grid of one wave (the occupancy API's blocks
//     per SM x SMs) loops over 8-lane tiles, and each block loads the W
//     tables, already in A-fragment order (ops/fold_kernels.py
//     ext_fragments_np), into shared memory once.
// What bounds them now (scripts/probe_torch_fold_parts.py, PERF.md): not the
// tensor cores (double FMAs in place of the mma steps change K1's time by a
// few percent) but the integer work and latency of the channelwise stages
// and of the extension epilogues, with part of the 20 warps taking one
// extension tile more than the rest in each stage while those wait at the
// barrier.
// The K of every sub/neg is NOT derived here: the host replays the
// reference bookkeeping (ops/fold_kernels.py fold_schedule) and passes the
// K*p residues as a table consumed in call order, so the residues equal the
// plain versions' bit for bit.  The identity sentinel is read before the
// sign flip; lanes past the ragged edge compute on zeros and store nothing.
//
// K7 is the same design on the complete addition (RCB15 Algorithm 7): an
// output lane sums two accumulator lanes of one level with 12 RNS products
// (G1, batches of 6 and 6) or 12 Fp2 products (G2, 36 Fp products in
// batches of two Karatsuba triples); it is bound like K1 and K2, by the
// multiplies' latency, and reads and writes 9 coordinates per lane.  The
// schedule of its K*p rows comes from ops/fold_kernels.tree_schedule, the
// plain level replayed on the host (G2 in rns_point's stacked Fp2
// bookkeeping: one K for both components of a sub, given twice).
//
// Left for later: fewer integer instructions per lane (the 9 pad rows
// still run the channelwise ops; FP32 for the small reductions), warp
// specialisation, the larger f64 mma shapes of sm_90, the int8 tensor
// cores (6-bit split on mma.sync or wgmma) should the extensions become the
// limit, and CUDA graphs over the window loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PB = 40;        // B block rows [0, 40): 35 real + 5 pad
constexpr int PC = 80;        // all rows: Hi block [40, 80) = B' (35) + m_r + 4 pad
constexpr int KB = 35;        // channels per base
constexpr int NT = KB + 1;    // extension targets (a base plus m_r)
constexpr int ROW_MR = PB + KB;  // padded row of m_r (75)
// Constant block written by kernel_consts_np (uint32 words, in this order).
struct Consts {
  uint32_t m[PC], mu[PC], kappa[PC], minv[PC], ifac2[PC], mpmod[PC];
  uint32_t mr, mpinv_mr;
};

// ------------------------------------------------------ the RNS multiply
constexpr int TC_LANES = 8;                // lanes per block
constexpr int TC_THREADS = TC_LANES * PC;  // 640: warp w holds rows 4w..4w+3
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int EXT_T = 40;                  // extension targets: 36 padded to 5 tiles of 8
constexpr int EXT_S = 36;                  // extension sources: 35 padded to 9 k-steps of 4
constexpr int EXT_TILES = EXT_T / 8;
constexpr int EXT_KSTEPS = EXT_S / 4;
constexpr int FRAG = 32;                   // an A fragment: one double per lane
constexpr int W_FRAGS = EXT_TILES * EXT_KSTEPS * FRAG;
constexpr int NMAX = 6;                    // products per batch (G1: 5, then 6; G2: 2 triples)

// Shared memory of a block (dynamic, 74916 bytes: two blocks fit an SM).
// Index j is the product of a batch.
struct TcSmem {
  double W[2][W_FRAGS];                 // W1, W2 in A-fragment order [tile][k-step][lane]
  double xi[NMAX][TC_LANES][EXT_S];     // ext1 sources [lane][B row]; row 35 holds 0
  double xi2[NMAX][TC_LANES][EXT_S];    // ext2 sources [lane][Hi-local row]; m_r holds 0
  uint32_t t[NMAX][EXT_T][TC_LANES];    // the Hi rows' products a b, unreduced
  uint32_t res[NMAX][EXT_T][TC_LANES];  // r' on the Hi rows
  uint32_t ext[NMAX][EXT_T][TC_LANES];  // ext2 on the B rows
  uint32_t alpha[NMAX][TC_LANES];
  int flag[TC_LANES];
  uint32_t m1[EXT_T], mu1[EXT_T], minv1[EXT_T], ifac21[EXT_T];  // ext1 targets (Hi rows)
  uint32_t m2[EXT_T], mu2[EXT_T];  // ext2 targets: B rows 0..34, m_r at 35
  uint32_t mpinv_mr;
};

__device__ __forceinline__ uint32_t mod_by(uint32_t t, uint32_t m, uint32_t mu) {
  // exact for every uint32 t: q is floor(t/m) or one less
  const uint32_t q = __umulhi(t, mu);
  const uint32_t v = t - q * m;
  return v >= m ? v - m : v;
}

// C (8 x 8) += A (8 x 4) B (4 x 8) in double on the tensor cores; the whole
// warp calls it.  Fragments (PTX ISA, mma.m8n8k4 .f64): a = A[l/4][l%4],
// b = B[l%4][l/4], c_j = C[l/4][2 (l%4) + j] for lane l.
__device__ __forceinline__ void dmma(double& c0, double& c1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// One 8-target tile of an extension: c_j = sum_i W[8 tile + l/4][i] *
// src[2 (l%4) + j][i].  Every partial sum is an integer below 2^30, exact
// in double.
__device__ __forceinline__ void ext_tile(const double* W, const double (*src)[EXT_S], int tile,
                                         int l, double& c0, double& c1) {
  const double* w = W + tile * EXT_KSTEPS * FRAG + l;
  const double* b = src[l >> 2] + (l & 3);
  c0 = c1 = 0.0;
#pragma unroll
  for (int k = 0; k < EXT_KSTEPS; ++k) dmma(c0, c1, w[k * FRAG], b[4 * k]);
}

// Per-thread context of the multiply: this thread's row constants, its
// warp and lane, the K*p schedule and the block's buffers.
struct TcCtx {
  int r, x, warp, lane;
  uint32_t m, mu, kappa, mpmod;
  const int* kp;  // (num_K, 80) K*p residues, consumed in call order
  int kidx;
  TcSmem* s;

  __device__ __forceinline__ uint32_t mod(uint32_t t) const { return mod_by(t, m, mu); }
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    uint32_t v = a + b;
    return v >= m ? v - m : v;
  }
  __device__ __forceinline__ uint32_t next_kp() {
    return (uint32_t)__ldg(kp + (kidx++) * PC + r);
  }
  // RnsVal.__sub__: a - b + K*p, canonical
  __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
    int v = (int)a - (int)b + (int)next_kp();
    if (v >= (int)m) v -= (int)m;
    if (v < 0) v += (int)m;
    return (uint32_t)v;
  }
  // RnsVal.neg: K*p - a, canonical
  __device__ __forceinline__ uint32_t neg(uint32_t a) {
    int v = (int)next_kp() - (int)a;
    if (v >= (int)m) v -= (int)m;
    if (v < 0) v += (int)m;
    return (uint32_t)v;
  }
  __device__ __forceinline__ uint32_t scale(uint32_t a, uint32_t k) const {
    return mod(a * k);  // a, k < 2^12
  }

  // Extension B -> B' + m_r of product j on target tile w, then r' = (t +
  // q^p) M^-1 and xi2 = r' (M'/m'_j)^-1 for its 8 targets x 8 lanes.  The
  // Hi rows left the unreduced products a b (< 2^24) in s->t, so t + q^p
  // is one reduction of a sum below 2^24 + 2^30.
  __device__ __forceinline__ void ext1_tile(int j, int w) {
    double c0, c1;
    ext_tile(s->W[0], s->xi[j], w, lane, c0, c1);
    const int tg = w * 8 + (lane >> 2), x0 = 2 * (lane & 3);
    if (tg >= NT) return;
    const uint32_t mt = s->m1[tg], mut = s->mu1[tg], minv = s->minv1[tg], if2 = s->ifac21[tg];
    const uint2 ab = *reinterpret_cast<const uint2*>(&s->t[j][tg][x0]);
    const uint32_t sv0 = mod_by(ab.x + __double2uint_rz(c0), mt, mut);
    const uint32_t sv1 = mod_by(ab.y + __double2uint_rz(c1), mt, mut);
    const uint32_t r0 = mod_by(sv0 * minv, mt, mut), r1 = mod_by(sv1 * minv, mt, mut);
    *reinterpret_cast<uint2*>(&s->res[j][tg][x0]) = make_uint2(r0, r1);
    s->xi2[j][x0][tg] = (double)mod_by(r0 * if2, mt, mut);  // m_r: if2 = 0
    s->xi2[j][x0 + 1][tg] = (double)mod_by(r1 * if2, mt, mut);
  }

  // Exact extension B' -> B + m_r of product j on target tile w; on the m_r
  // target the Shenoy-Kumaresan count alpha' = (ext_mr - r'_mr) M'^-1 mod m_r.
  __device__ __forceinline__ void ext2_tile(int j, int w) {
    double c0, c1;
    ext_tile(s->W[1], s->xi2[j], w, lane, c0, c1);
    const int tg = w * 8 + (lane >> 2), x0 = 2 * (lane & 3);
    if (tg >= NT) return;
    const uint32_t mt = s->m2[tg], mut = s->mu2[tg];
    const uint32_t e0 = mod_by(__double2uint_rz(c0), mt, mut);
    const uint32_t e1 = mod_by(__double2uint_rz(c1), mt, mut);
    if (tg < KB) {
      *reinterpret_cast<uint2*>(&s->ext[j][tg][x0]) = make_uint2(e0, e1);
      return;
    }
    const uint2 rr = *reinterpret_cast<const uint2*>(&s->res[j][KB][x0]);
    int d0 = (int)e0 - (int)rr.x, d1 = (int)e1 - (int)rr.y;
    if (d0 < 0) d0 += (int)mt;
    if (d1 < 0) d1 += (int)mt;
    s->alpha[j][x0] = mod_by((uint32_t)d0 * s->mpinv_mr, mt, mut);
    s->alpha[j][x0 + 1] = mod_by((uint32_t)d1 * s->mpinv_mr, mt, mut);
  }

  // N independent RNS Montgomery multiplies out[j] = a[j] b[j] (the
  // reference's _rns_mul_block for this thread's channel), batched so that
  // their N x 5 extension tiles spread over the 20 warps and the batch
  // shares three block barriers.  Every thread of the block calls it
  // together.
  template <int N>
  __device__ __forceinline__ void mul_many(const uint32_t* a, const uint32_t* b, uint32_t* out) {
    static_assert(N <= NMAX, "batch larger than the shared buffers");
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint32_t ab = a[j] * b[j];  // < 2^24
      if (r < EXT_S) {  // B rows; pad row 35 has kappa 0
        s->xi[j][x][r] = (double)mod(mod(ab) * kappa);
      } else if (r >= PB && r <= ROW_MR) {
        s->t[j][r - PB][x] = ab;
      }
    }
    __syncthreads();
    for (int i = warp; i < N * EXT_TILES; i += TC_WARPS) ext1_tile(i / EXT_TILES, i % EXT_TILES);
    __syncthreads();
    for (int i = warp; i < N * EXT_TILES; i += TC_WARPS) ext2_tile(i / EXT_TILES, i % EXT_TILES);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (r < KB) {
        const uint32_t corr = mod(s->alpha[j][x] * mpmod);
        const int v = (int)s->ext[j][r][x] - (int)corr;
        out[j] = (uint32_t)(v < 0 ? v + (int)m : v);
      } else {
        out[j] = r >= PB && r <= ROW_MR ? s->res[j][r - PB][x] : 0u;  // pad rows stay 0
      }
    }
  }
};

__device__ __forceinline__ void init_tc(TcCtx& c, const Consts* K, const double* wf,
                                        const int* kp, TcSmem* s) {
  c.x = threadIdx.x;
  c.r = threadIdx.y;
  const int tid = c.r * TC_LANES + c.x;
  c.warp = tid >> 5;
  c.lane = tid & 31;
  c.m = K->m[c.r];
  c.mu = K->mu[c.r];
  c.kappa = K->kappa[c.r];
  c.mpmod = K->mpmod[c.r];
  c.kp = kp;
  c.kidx = 0;
  c.s = s;
  for (int i = tid; i < 2 * W_FRAGS; i += TC_THREADS) (&s->W[0][0])[i] = wf[i];
  if (tid < EXT_T) {
    s->m1[tid] = K->m[PB + tid];
    s->mu1[tid] = K->mu[PB + tid];
    s->minv1[tid] = K->minv[PB + tid];
    s->ifac21[tid] = K->ifac2[PB + tid];
    const int row2 = tid == KB ? ROW_MR : tid;
    s->m2[tid] = K->m[row2];
    s->mu2[tid] = K->mu[row2];
  }
  if (tid == 0) s->mpinv_mr = K->mpinv_mr;
}

// ---------------------------------------------------------------- Fp ops
struct G1Ops {
  using V = uint32_t;
  static constexpr int COMPS = 1;  // (80, lanes) tiles
  TcCtx& c;
  uint32_t b3;
  static __device__ V load(const int* t, size_t i, int) { return (uint32_t)t[i]; }
  static __device__ void store(int* t, size_t i, int, V v) { t[i] = (int)v; }
  static __device__ uint32_t bits(V v) { return v; }
  __device__ V add(V a, V b) { return c.add(a, b); }
  __device__ V sub(V a, V b) { return c.sub(a, b); }
  __device__ V neg(V a) { return c.neg(a); }
  __device__ V mul_b3(V a) { return c.scale(a, b3); }
  __device__ V scale3(V a) { return c.scale(a, 3); }
  template <int N>
  __device__ void mul_many(const V* a, const V* b, V* out) {
    c.template mul_many<N>(a, b, out);
  }
};

// ---------------------------------------------------------------- Fp2 ops
// The reference's _ShimG2Ops: per-component RnsVals, b3 = b3c (1 + u),
// Karatsuba products (a0 b0, a1 b1, (a0 + a1)(b0 + b1)).  Statements are
// sequential so the K*p rows are consumed in Python's evaluation order.
struct Fp2 {
  uint32_t c0, c1;
};

struct G2Ops {
  using V = Fp2;
  static constexpr int COMPS = 2;  // (80, 2, lanes): component 1 sits `lanes` words after 0
  TcCtx& c;
  uint32_t b3c;
  static __device__ V load(const int* t, size_t i, int lanes) {
    return {(uint32_t)t[i], (uint32_t)t[i + lanes]};
  }
  static __device__ void store(int* t, size_t i, int lanes, V v) {
    t[i] = (int)v.c0;
    t[i + lanes] = (int)v.c1;
  }
  static __device__ uint32_t bits(V v) { return v.c0 | v.c1; }
  __device__ V add(V a, V b) { return {c.add(a.c0, b.c0), c.add(a.c1, b.c1)}; }
  __device__ V sub(V a, V b) {
    V o;
    o.c0 = c.sub(a.c0, b.c0);
    o.c1 = c.sub(a.c1, b.c1);
    return o;
  }
  __device__ V neg(V a) {
    V o;
    o.c0 = c.neg(a.c0);
    o.c1 = c.neg(a.c1);
    return o;
  }
  __device__ V mul_b3(V a) {
    const uint32_t d = c.sub(a.c0, a.c1);
    const uint32_t s = c.add(a.c0, a.c1);
    return {c.scale(d, b3c), c.scale(s, b3c)};
  }
  __device__ V scale3(V a) { return {c.scale(a.c0, 3), c.scale(a.c1, 3)}; }
  // N Fp2 products, NMAX / 3 at a time: the Karatsuba triples of a chunk
  // run as one batched multiply, then the chunk's subs.  Products consume
  // no K*p row, so the subs take the rows in the reference's order.
  template <int N>
  __device__ void mul_many(const V* a, const V* b, V* out) {
    constexpr int M = N < NMAX / 3 ? N : NMAX / 3;
    uint32_t x[3 * M], y[3 * M], t[3 * M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      x[3 * i] = a[i].c0;
      y[3 * i] = b[i].c0;
      x[3 * i + 1] = a[i].c1;
      y[3 * i + 1] = b[i].c1;
      x[3 * i + 2] = c.add(a[i].c0, a[i].c1);
      y[3 * i + 2] = c.add(b[i].c0, b[i].c1);
    }
    c.template mul_many<3 * M>(x, y, t);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      out[i].c0 = c.sub(t[3 * i], t[3 * i + 1]);
      const uint32_t u = c.sub(t[3 * i + 2], t[3 * i]);
      out[i].c1 = c.sub(u, t[3 * i + 1]);
    }
    if constexpr (N > M) mul_many<N - M>(a + M, b + M, out + M);
  }
};

// Complete mixed addition P + (x2, y2), RCB15 Algorithm 8 (a = 0): the
// statement order of curves/rns_point.point_add_mixed.
template <class Ops, class V = typename Ops::V>
__device__ __forceinline__ void point_add_mixed(Ops& o, V X1, V Y1, V Z1, V X2, V Y2,
                                                V& X3, V& Y3, V& Z3) {
  V a1[5] = {X1, Y1, o.add(X1, Y1), Y2, X2};
  V b1[5] = {X2, Y2, o.add(X2, Y2), Z1, Z1};
  V p1[5];
  o.template mul_many<5>(a1, b1, p1);
  const V t0 = p1[0], t1 = p1[1], t3p = p1[2], t4p = p1[3], y3p = p1[4];
  const V u = o.sub(t3p, t0);
  const V t3 = o.sub(u, t1);
  const V t4 = o.add(t4p, Y1);
  const V y3b = o.mul_b3(o.add(y3p, X1));
  const V t0_3 = o.scale3(t0);
  const V t2 = o.mul_b3(Z1);
  const V Z3m = o.add(t1, t2);
  const V t1m = o.sub(t1, t2);
  V a2[6] = {t3, t4, y3b, t1m, Z3m, t0_3};
  V b2[6] = {t1m, y3b, t0_3, Z3m, t4, t3};
  V q[6];
  o.template mul_many<6>(a2, b2, q);
  X3 = o.sub(q[0], q[1]);
  Y3 = o.add(q[2], q[3]);
  Z3 = o.add(q[4], q[5]);
}

// Complete addition P + Q, RCB15 Algorithm 7 (a = 0): the statement order of
// curves/rns_point.point_add, so the K*p rows are consumed in its order.
template <class Ops, class V = typename Ops::V>
__device__ __forceinline__ void point_add(Ops& o, V X1, V Y1, V Z1, V X2, V Y2, V Z2,
                                          V& X3, V& Y3, V& Z3) {
  V a1[6] = {X1, Y1, Z1, o.add(X1, Y1), o.add(Y1, Z1), o.add(X1, Z1)};
  V b1[6] = {X2, Y2, Z2, o.add(X2, Y2), o.add(Y2, Z2), o.add(X2, Z2)};
  V p[6];
  o.template mul_many<6>(a1, b1, p);
  const V t0 = p[0], t1 = p[1], t2 = p[2];
  const V u3 = o.sub(p[3], t0);
  const V t3 = o.sub(u3, t1);
  const V u4 = o.sub(p[4], t1);
  const V t4 = o.sub(u4, t2);
  const V u5 = o.sub(p[5], t0);
  const V y3 = o.sub(u5, t2);
  const V y3b = o.mul_b3(y3);
  const V t0_3 = o.scale3(t0);
  const V t2b = o.mul_b3(t2);
  const V Z3m = o.add(t1, t2b);
  const V t1m = o.sub(t1, t2b);
  V a2[6] = {t4, t3, y3b, t1m, t0_3, Z3m};
  V b2[6] = {y3b, t1m, t0_3, Z3m, t3, t4};
  V q[6];
  o.template mul_many<6>(a2, b2, q);
  X3 = o.sub(q[1], q[0]);
  Y3 = o.add(q[3], q[2]);
  Z3 = o.add(q[5], q[4]);
}

// Per-lane identity flag: every B row of the given tiles exactly zero.
// `nonzero` is this thread's "some tile is nonzero here" bit.
__device__ __forceinline__ bool lane_is_sentinel(TcCtx& c, bool nonzero) {
  if (c.r == 0) c.s->flag[c.x] = 0;
  __syncthreads();
  if (c.r < KB && nonzero) c.s->flag[c.x] = 1;
  __syncthreads();
  return c.s->flag[c.x] == 0;
}

// The kernels are persistent: blockIdx.x walks the work units (K1, K2: one
// 8-lane tile; K3: NMAX consecutive tiles, one batched multiply) with
// stride gridDim.x.  Every thread of a block takes the same units, so the
// barriers stay uniform.
extern __shared__ __align__(16) unsigned char tc_smem[];

__global__ void __launch_bounds__(TC_THREADS, 2) rns_mul_kernel(
    const int* __restrict__ xs, const int* __restrict__ ys, int* __restrict__ out,
    const Consts* __restrict__ K, const double* __restrict__ wf, int lanes) {
  TcSmem& s = *reinterpret_cast<TcSmem*>(tc_smem);
  TcCtx c;
  init_tc(c, K, wf, nullptr, &s);
  __syncthreads();
  const int units = (lanes + NMAX * TC_LANES - 1) / (NMAX * TC_LANES);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    uint32_t a[NMAX], b[NMAX], v[NMAX];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      const int lane = (u * NMAX + j) * TC_LANES + c.x;
      const size_t idx = (size_t)c.r * lanes + lane;
      a[j] = lane < lanes ? (uint32_t)xs[idx] : 0u;
      b[j] = lane < lanes ? (uint32_t)ys[idx] : 0u;
    }
    c.mul_many<NMAX>(a, b, v);
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      const int lane = (u * NMAX + j) * TC_LANES + c.x;
      if (lane < lanes) out[(size_t)c.r * lanes + lane] = (int)v[j];
    }
  }
}

// One fold window, acc (+)= sign * q on every lane: K1 with G1Ops, K2 with
// G2Ops.  Every point argument is an (80, COMPS, lanes) tensor: component
// c of row r, lane l sits at (COMPS r + c) lanes + l.
template <class Ops>
__global__ void __launch_bounds__(TC_THREADS, 2) fold_kernel(
    const int* __restrict__ ax, const int* __restrict__ ay, const int* __restrict__ az,
    const int* __restrict__ qx, const int* __restrict__ qy, const int* __restrict__ sg,
    int* __restrict__ ox, int* __restrict__ oy, int* __restrict__ oz,
    const int* __restrict__ kp, const Consts* __restrict__ K, const double* __restrict__ wf,
    int lanes, int b3) {
  using V = typename Ops::V;
  TcSmem& s = *reinterpret_cast<TcSmem*>(tc_smem);
  TcCtx c;
  init_tc(c, K, wf, kp, &s);
  Ops o{c, (uint32_t)b3};
  const int tiles = (lanes + TC_LANES - 1) / TC_LANES;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    c.kidx = 0;
    const int lane = tile * TC_LANES + c.x;
    const bool valid = lane < lanes;
    const size_t idx = (size_t)c.r * Ops::COMPS * lanes + lane;
    auto load = [&](const int* t) { return valid ? Ops::load(t, idx, lanes) : V{}; };
    const V X1 = load(ax), Y1 = load(ay), Z1 = load(az), X2 = load(qx), Y2 = load(qy);
    const bool neg_sign = valid && sg[lane] == 1;
    // identity sentinel BEFORE the sign flip (neg adds K*p to the exact 0);
    // on the first tile its barriers also publish what init_tc loaded
    const bool inf = lane_is_sentinel(c, (Ops::bits(X2) | Ops::bits(Y2)) != 0u);
    const V Yn = o.neg(Y2);
    const V Ys = neg_sign ? Yn : Y2;
    V X3, Y3, Z3;
    point_add_mixed(o, X1, Y1, Z1, X2, Ys, X3, Y3, Z3);
    if (valid) {
      Ops::store(ox, idx, lanes, inf ? X1 : X3);
      Ops::store(oy, idx, lanes, inf ? Y1 : Y3);
      Ops::store(oz, idx, lanes, inf ? Z1 : Z3);
    }
  }
}

// One level of the tree reduction, K7 with G1Ops or G2Ops: output lane
// (o, i) of an (80, COMPS, outer, half) tensor is the complete sum of lanes
// (o, i) and (o, half + i) of the (80, COMPS, outer, 2 half) input; as in
// fold_kernel, component c of row r, lane l sits at (COMPS r + c) n + l for
// a tensor of n lanes.  Every coordinate is below cap p in and out (the
// host's schedule asserts it).
template <class Ops>
__global__ void __launch_bounds__(TC_THREADS, 2) tree_add_kernel(
    const int* __restrict__ ax, const int* __restrict__ ay, const int* __restrict__ az,
    int* __restrict__ ox, int* __restrict__ oy, int* __restrict__ oz,
    const int* __restrict__ kp, const Consts* __restrict__ K, const double* __restrict__ wf,
    int outer, int half, int b3) {
  using V = typename Ops::V;
  TcSmem& s = *reinterpret_cast<TcSmem*>(tc_smem);
  TcCtx c;
  init_tc(c, K, wf, kp, &s);
  __syncthreads();
  Ops o{c, (uint32_t)b3};
  const int lanes = outer * half;  // output lanes; the input holds twice as many
  const int tiles = (lanes + TC_LANES - 1) / TC_LANES;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    c.kidx = 0;
    const int lane = tile * TC_LANES + c.x;
    const bool valid = lane < lanes;
    // input lane of (o, i) = o 2 half + i = lane + o half
    const size_t in = (size_t)c.r * Ops::COMPS * 2 * lanes + (size_t)lane + (size_t)(lane / half) * half;
    const size_t out = (size_t)c.r * Ops::COMPS * lanes + lane;
    auto load = [&](const int* t, size_t i) { return valid ? Ops::load(t, i, 2 * lanes) : V{}; };
    const V X1 = load(ax, in), Y1 = load(ay, in), Z1 = load(az, in);
    const V X2 = load(ax, in + half), Y2 = load(ay, in + half), Z2 = load(az, in + half);
    V X3, Y3, Z3;
    point_add(o, X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3);
    if (valid) {
      Ops::store(ox, out, lanes, X3);
      Ops::store(oy, out, lanes, Y3);
      Ops::store(oz, out, lanes, Z3);
    }
  }
}

// Blocks of one full wave of a persistent kernel on the current device:
// resident blocks per SM (occupancy API) x SMs, cached per device, after
// allowing the kernel its dynamic shared memory on that device.
struct Wave {
  int dev = -1, blocks = 0;
};
Wave mul_wave;

template <class Kern>
int wave_blocks(Kern kern, Wave& w) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (w.dev != dev) {
    int sms = 0, per_sm = 0;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(TcSmem));
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TC_THREADS, sizeof(TcSmem));
    w.blocks = sms * (per_sm > 0 ? per_sm : 1);
    w.dev = dev;
  }
  return w.blocks;
}

inline int tc_grid(int wave, int units) { return units < wave ? units : wave; }

template <class Ops>
int fold_wave_blocks() {
  static Wave w;
  return wave_blocks(fold_kernel<Ops>, w);
}

template <class Ops>
int launch_fold(const int* ax, const int* ay, const int* az, const int* qx, const int* qy,
                const int* sg, int* ox, int* oy, int* oz, const int* kp, const void* consts,
                const void* wf, int lanes, int b3, void* stream) {
  if (lanes <= 0) return 0;
  const int grid = tc_grid(fold_wave_blocks<Ops>(), (lanes + TC_LANES - 1) / TC_LANES);
  fold_kernel<Ops><<<grid, dim3(TC_LANES, PC), sizeof(TcSmem), (cudaStream_t)stream>>>(
      ax, ay, az, qx, qy, sg, ox, oy, oz, kp, (const Consts*)consts, (const double*)wf, lanes, b3);
  return (int)cudaGetLastError();
}

template <class Ops>
int tree_wave_blocks() {
  static Wave w;
  return wave_blocks(tree_add_kernel<Ops>, w);
}

template <class Ops>
int launch_tree(const int* ax, const int* ay, const int* az, int* ox, int* oy, int* oz,
                const int* kp, const void* consts, const void* wf, int outer, int half, int b3,
                void* stream) {
  if (outer <= 0 || half <= 0) return 0;
  const int grid = tc_grid(tree_wave_blocks<Ops>(), (outer * half + TC_LANES - 1) / TC_LANES);
  tree_add_kernel<Ops><<<grid, dim3(TC_LANES, PC), sizeof(TcSmem), (cudaStream_t)stream>>>(
      ax, ay, az, ox, oy, oz, kp, (const Consts*)consts, (const double*)wf, outer, half, b3);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ C entry points
// All pointers are device pointers; `stream` is a cudaStream_t.  Each
// launch returns cudaGetLastError() right after it.  `wf` is the
// ext_fragments_np table (2 x 1440 doubles).

extern "C" int bmt_rns_mul(const int* xs, const int* ys, int* out, const void* consts,
                           const void* wf, int lanes, void* stream) {
  if (lanes <= 0) return 0;
  const int units = (lanes + NMAX * TC_LANES - 1) / (NMAX * TC_LANES);
  const int grid = tc_grid(wave_blocks(rns_mul_kernel, mul_wave), units);
  rns_mul_kernel<<<grid, dim3(TC_LANES, PC), sizeof(TcSmem), (cudaStream_t)stream>>>(
      xs, ys, out, (const Consts*)consts, (const double*)wf, lanes);
  return (int)cudaGetLastError();
}

// The G1 window: every point argument is an (80, lanes) tile.
extern "C" int bmt_fold_g1(const int* ax, const int* ay, const int* az, const int* qx,
                           const int* qy, const int* sg, int* ox, int* oy, int* oz,
                           const int* kp, const void* consts, const void* wf, int lanes,
                           int b3, void* stream) {
  return launch_fold<G1Ops>(ax, ay, az, qx, qy, sg, ox, oy, oz, kp, consts, wf, lanes, b3, stream);
}

// The G2 window: every point argument is an (80, 2, lanes) tensor.
extern "C" int bmt_fold_g2(const int* ax, const int* ay, const int* az, const int* qx,
                           const int* qy, const int* sg, int* ox, int* oy, int* oz,
                           const int* kp, const void* consts, const void* wf, int lanes,
                           int b3c, void* stream) {
  return launch_fold<G2Ops>(ax, ay, az, qx, qy, sg, ox, oy, oz, kp, consts, wf, lanes, b3c, stream);
}

// One level of the G1 tree reduction: a* are (80, outer, 2 half) tiles, o*
// (80, outer, half).
extern "C" int bmt_tree_add_g1(const int* ax, const int* ay, const int* az, int* ox, int* oy,
                               int* oz, const int* kp, const void* consts, const void* wf,
                               int outer, int half, int b3, void* stream) {
  return launch_tree<G1Ops>(ax, ay, az, ox, oy, oz, kp, consts, wf, outer, half, b3, stream);
}

// The same on G2: a* are (80, 2, outer, 2 half) tensors, o* (80, 2, outer, half).
extern "C" int bmt_tree_add_g2(const int* ax, const int* ay, const int* az, int* ox, int* oy,
                               int* oz, const int* kp, const void* consts, const void* wf,
                               int outer, int half, int b3c, void* stream) {
  return launch_tree<G2Ops>(ax, ay, az, ox, oy, oz, kp, consts, wf, outer, half, b3c, stream);
}

// Lanes that one full wave of K1's, K2's or K7's (8-lane tiles) or K3's
// (NMAX tiles per unit) persistent blocks covers.
extern "C" int bmt_fold_g1_wave_lanes() { return fold_wave_blocks<G1Ops>() * TC_LANES; }
extern "C" int bmt_fold_g2_wave_lanes() { return fold_wave_blocks<G2Ops>() * TC_LANES; }
extern "C" int bmt_tree_g1_wave_lanes() { return tree_wave_blocks<G1Ops>() * TC_LANES; }
extern "C" int bmt_tree_g2_wave_lanes() { return tree_wave_blocks<G2Ops>() * TC_LANES; }
extern "C" int bmt_rns_mul_wave_lanes() {
  return wave_blocks(rns_mul_kernel, mul_wave) * NMAX * TC_LANES;
}
