// Window-fold kernels of the batched Groth16 prover for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of bellman_mpc_tpu/ops/pallas_kernels.py:
//   bmt_rns_mul  (K3) <- _jit_rns_mul_pallas; its body _rns_mul_block is
//                        rns_mul() below, the inner multiply of K1 and K2
//   bmt_fold_g1  (K1) <- _jit_mixed_add_pallas   (one G1 fold window)
//   bmt_fold_g2  (K2) <- _jit_mixed_add_pallas_g2 (one G2 fold window)
// The plain PyTorch versions sit beside the wrappers in ops/fold_kernels.py.
//
// What bounds it on this card: a fold window is a long DEPENDENT chain of
// 11 RNS Montgomery multiplies (33 Fp products for G2), each with two
// cross-channel base extensions (35-term dot products over 71 channels).
// The essential HBM traffic is small (accumulator in/out plus the gathered
// table points: 5 x 80 x lanes int32 for G1), so the kernel is bound by
// integer multiply-add work and by the block barriers between extension
// stages, not by memory, provided no intermediate leaves the chip.
//
// What the design does about it: one block covers TL lanes with the 80
// padded channel rows across threads (thread (x, r) owns lane x, row r).
// Every RnsVal intermediate is ONE register per thread; channelwise work
// (products, K*p adds, scales) is per-thread and the reduction mod m is an
// exact 32-bit Barrett step (__umulhi with floor(2^32/m), one fixup).  Only
// the base extensions cross threads: sources go to shared memory, each
// target thread runs its 35-term dot in exact uint32 (sum < 35*4095^2 <
// 2^30), three barriers per multiply.  Nothing but the final coordinates is
// written to global memory.  The K of every sub/neg is NOT derived here:
// the host replays the reference bookkeeping (ops/fold_kernels.py
// fold_schedule) and passes the K*p residues as a table consumed in call
// order, so the residues equal the plain versions' bit for bit.
// Not done yet (later work): int8 mma for the extensions, the table gather
// inside the kernel, persistent blocks, CUDA graphs over the window loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PB = 40;        // B block rows [0, 40): 35 real + 5 pad
constexpr int PC = 80;        // all rows: Hi block [40, 80) = B' (35) + m_r + 4 pad
constexpr int KB = 35;        // channels per base
constexpr int NT = KB + 1;    // extension targets (a base plus m_r)
constexpr int ROW_MR = PB + KB;  // padded row of m_r (75)
constexpr int TL = 4;         // lanes per block
constexpr int THREADS = TL * PC;

// Constant block written by kernel_consts_np (uint32 words, in this order).
struct Consts {
  uint32_t m[PC], mu[PC], kappa[PC], minv[PC], ifac2[PC], mpmod[PC];
  uint32_t W1[KB * NT];  // [B source i][Hi target t]: ((M/m_i) p) mod m_t
  uint32_t W2[KB * NT];  // [B' source j][target t: B 0..34, m_r 35]: (M'/m'_j) mod m_t
  uint32_t mr, mpinv_mr;
};

struct Smem {
  uint32_t W1[KB * NT];
  uint32_t W2[KB * NT];
  uint32_t xi[KB][TL];
  uint32_t xi2[KB][TL];
  uint32_t alpha[TL];
  int flag[TL];
};

// Per-thread context: this thread's row constants and the K*p schedule.
struct Ctx {
  int r, x;
  uint32_t m, mu, kappa, minv, ifac2, mpmod, mr, mpinv_mr;
  bool isB, isHi, isMr;
  const int* kp;  // (num_K, 80) K*p residues, consumed in call order
  int kidx;
  Smem* s;

  __device__ __forceinline__ uint32_t mod(uint32_t t) const {
    // exact for every uint32 t: q is floor(t/m) or one less
    uint32_t q = __umulhi(t, mu);
    uint32_t v = t - q * m;
    return v >= m ? v - m : v;
  }
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

  // One RNS Montgomery multiply (the reference's _rns_mul_block for this
  // thread's channel).  Every thread of the block must call it together.
  __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    uint32_t t = mod(a * b);
    if (isB) s->xi[r][x] = mod(t * kappa);
    __syncthreads();
    uint32_t res = 0, ext = 0;
    if (isHi) {  // extension B -> B' + m_r, then r' = (t + q^p) M^-1
      const int tg = r - PB;
      uint32_t acc = 0;
#pragma unroll 7
      for (int i = 0; i < KB; ++i) acc += s->xi[i][x] * s->W1[i * NT + tg];
      uint32_t sv = add(t, mod(acc));
      res = mod(sv * minv);
      if (!isMr) s->xi2[tg][x] = mod(res * ifac2);
    }
    __syncthreads();
    if (isB || isMr) {  // exact extension B' -> B + m_r
      const int tg = isMr ? KB : r;
      uint32_t acc = 0;
#pragma unroll 7
      for (int j = 0; j < KB; ++j) acc += s->xi2[j][x] * s->W2[j * NT + tg];
      ext = mod(acc);
      if (isMr) {  // Shenoy-Kumaresan count alpha' = (ext_mr - r'_mr) M'^-1
        int d = (int)ext - (int)res;
        if (d < 0) d += (int)m;
        s->alpha[x] = mod((uint32_t)d * mpinv_mr);
      }
    }
    __syncthreads();
    if (isB) {
      uint32_t corr = mod(s->alpha[x] * mpmod);
      int v = (int)ext - (int)corr;
      if (v < 0) v += (int)m;
      res = (uint32_t)v;
    }
    return res;
  }
};

__device__ __forceinline__ void init_ctx(Ctx& c, const Consts* K, const int* kp, Smem* s) {
  c.x = threadIdx.x;
  c.r = threadIdx.y;
  const int r = c.r;
  c.m = K->m[r];
  c.mu = K->mu[r];
  c.kappa = K->kappa[r];
  c.minv = K->minv[r];
  c.ifac2 = K->ifac2[r];
  c.mpmod = K->mpmod[r];
  c.mr = K->mr;
  c.mpinv_mr = K->mpinv_mr;
  c.isB = r < KB;
  c.isHi = r >= PB && r <= ROW_MR;
  c.isMr = r == ROW_MR;
  c.kp = kp;
  c.kidx = 0;
  c.s = s;
  const int tid = r * TL + c.x;
  for (int i = tid; i < KB * NT; i += THREADS) {
    s->W1[i] = K->W1[i];
    s->W2[i] = K->W2[i];
  }
}

// ---------------------------------------------------------------- Fp ops
struct G1Ops {
  using V = uint32_t;
  Ctx& c;
  uint32_t b3;
  __device__ V add(V a, V b) { return c.add(a, b); }
  __device__ V sub(V a, V b) { return c.sub(a, b); }
  __device__ V neg(V a) { return c.neg(a); }
  __device__ V mul_b3(V a) { return c.scale(a, b3); }
  __device__ V scale3(V a) { return c.scale(a, 3); }
  template <int N>
  __device__ void mul_many(const V* a, const V* b, V* out) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = c.mul(a[i], b[i]);
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
  Ctx& c;
  uint32_t b3c;
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
  template <int N>
  __device__ void mul_many(const V* a, const V* b, V* out) {
    uint32_t t[3 * N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      t[3 * i] = c.mul(a[i].c0, b[i].c0);
      t[3 * i + 1] = c.mul(a[i].c1, b[i].c1);
      t[3 * i + 2] = c.mul(c.add(a[i].c0, a[i].c1), c.add(b[i].c0, b[i].c1));
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      out[i].c0 = c.sub(t[3 * i], t[3 * i + 1]);
      const uint32_t u = c.sub(t[3 * i + 2], t[3 * i]);
      out[i].c1 = c.sub(u, t[3 * i + 1]);
    }
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

// Per-lane identity flag: every B row of the given tiles exactly zero.
// `nonzero` is this thread's "some tile is nonzero here" bit.
__device__ __forceinline__ bool lane_is_sentinel(Ctx& c, bool nonzero) {
  if (c.r == 0) c.s->flag[c.x] = 0;
  __syncthreads();
  if (c.isB && nonzero) c.s->flag[c.x] = 1;
  __syncthreads();
  return c.s->flag[c.x] == 0;
}

__global__ void __launch_bounds__(THREADS) rns_mul_kernel(const int* __restrict__ xs,
                                                          const int* __restrict__ ys,
                                                          int* __restrict__ out,
                                                          const Consts* __restrict__ K,
                                                          int lanes) {
  __shared__ Smem s;
  Ctx c;
  init_ctx(c, K, nullptr, &s);
  __syncthreads();
  const int lane = blockIdx.x * TL + c.x;
  const bool valid = lane < lanes;
  const size_t idx = (size_t)c.r * lanes + lane;
  const uint32_t a = valid ? (uint32_t)xs[idx] : 0u;
  const uint32_t b = valid ? (uint32_t)ys[idx] : 0u;
  const uint32_t v = c.mul(a, b);
  if (valid) out[idx] = (int)v;
}

__global__ void __launch_bounds__(THREADS) fold_g1_kernel(
    const int* __restrict__ ax, const int* __restrict__ ay, const int* __restrict__ az,
    const int* __restrict__ qx, const int* __restrict__ qy, const int* __restrict__ sg,
    int* __restrict__ ox, int* __restrict__ oy, int* __restrict__ oz,
    const int* __restrict__ kp, const Consts* __restrict__ K, int lanes, int b3) {
  __shared__ Smem s;
  Ctx c;
  init_ctx(c, K, kp, &s);
  const int lane = blockIdx.x * TL + c.x;
  const bool valid = lane < lanes;
  const size_t idx = (size_t)c.r * lanes + lane;
  const uint32_t X1 = valid ? (uint32_t)ax[idx] : 0u;
  const uint32_t Y1 = valid ? (uint32_t)ay[idx] : 0u;
  const uint32_t Z1 = valid ? (uint32_t)az[idx] : 0u;
  const uint32_t X2 = valid ? (uint32_t)qx[idx] : 0u;
  const uint32_t Y2 = valid ? (uint32_t)qy[idx] : 0u;
  const bool neg_sign = valid && sg[lane] == 1;
  // identity sentinel BEFORE the sign flip (neg adds K*p to the exact 0);
  // its barriers also publish the W tables loaded by init_ctx
  const bool inf = lane_is_sentinel(c, (X2 | Y2) != 0u);
  G1Ops o{c, (uint32_t)b3};
  const uint32_t Yn = o.neg(Y2);
  const uint32_t Ys = neg_sign ? Yn : Y2;
  uint32_t X3, Y3, Z3;
  point_add_mixed(o, X1, Y1, Z1, X2, Ys, X3, Y3, Z3);
  if (valid) {
    ox[idx] = (int)(inf ? X1 : X3);
    oy[idx] = (int)(inf ? Y1 : Y3);
    oz[idx] = (int)(inf ? Z1 : Z3);
  }
}

struct G2Ptrs {
  const int* in[10];  // X0 X1 Y0 Y1 Z0 Z1 | x0 x1 y0 y1
  int* out[6];
};

__global__ void __launch_bounds__(THREADS) fold_g2_kernel(G2Ptrs P, const int* __restrict__ sg,
                                                          const int* __restrict__ kp,
                                                          const Consts* __restrict__ K,
                                                          int lanes, int b3c) {
  __shared__ Smem s;
  Ctx c;
  init_ctx(c, K, kp, &s);
  const int lane = blockIdx.x * TL + c.x;
  const bool valid = lane < lanes;
  const size_t idx = (size_t)c.r * lanes + lane;
  uint32_t v[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) v[i] = valid ? (uint32_t)P.in[i][idx] : 0u;
  const bool neg_sign = valid && sg[lane] == 1;
  const bool inf = lane_is_sentinel(c, (v[6] | v[7] | v[8] | v[9]) != 0u);
  G2Ops o{c, (uint32_t)b3c};
  const Fp2 X1{v[0], v[1]}, Y1{v[2], v[3]}, Z1{v[4], v[5]};
  const Fp2 X2{v[6], v[7]}, Y2{v[8], v[9]};
  const Fp2 Yn = o.neg(Y2);
  const Fp2 Ys = neg_sign ? Yn : Y2;
  Fp2 X3, Y3, Z3;
  point_add_mixed(o, X1, Y1, Z1, X2, Ys, X3, Y3, Z3);
  if (valid) {
    const uint32_t res[6] = {X3.c0, X3.c1, Y3.c0, Y3.c1, Z3.c0, Z3.c1};
#pragma unroll
    for (int i = 0; i < 6; ++i) P.out[i][idx] = (int)(inf ? v[i] : res[i]);
  }
}

inline int blocks_for(int lanes) { return (lanes + TL - 1) / TL; }

}  // namespace

// ------------------------------------------------------------ C entry points
// All pointers are device pointers; `stream` is a cudaStream_t.  Each
// returns cudaGetLastError() right after its launch.

extern "C" int bmt_rns_mul(const int* xs, const int* ys, int* out, const void* consts,
                           int lanes, void* stream) {
  if (lanes <= 0) return 0;
  rns_mul_kernel<<<blocks_for(lanes), dim3(TL, PC), 0, (cudaStream_t)stream>>>(
      xs, ys, out, (const Consts*)consts, lanes);
  return (int)cudaGetLastError();
}

extern "C" int bmt_fold_g1(const int* ax, const int* ay, const int* az, const int* qx,
                           const int* qy, const int* sg, int* ox, int* oy, int* oz,
                           const int* kp, const void* consts, int lanes, int b3,
                           void* stream) {
  if (lanes <= 0) return 0;
  fold_g1_kernel<<<blocks_for(lanes), dim3(TL, PC), 0, (cudaStream_t)stream>>>(
      ax, ay, az, qx, qy, sg, ox, oy, oz, kp, (const Consts*)consts, lanes, b3);
  return (int)cudaGetLastError();
}

extern "C" int bmt_fold_g2(const int* a0, const int* a1, const int* a2, const int* a3,
                           const int* a4, const int* a5, const int* q0, const int* q1,
                           const int* q2, const int* q3, const int* sg, int* o0, int* o1,
                           int* o2, int* o3, int* o4, int* o5, const int* kp,
                           const void* consts, int lanes, int b3c, void* stream) {
  if (lanes <= 0) return 0;
  G2Ptrs P{{a0, a1, a2, a3, a4, a5, q0, q1, q2, q3}, {o0, o1, o2, o3, o4, o5}};
  fold_g2_kernel<<<blocks_for(lanes), dim3(TL, PC), 0, (cudaStream_t)stream>>>(
      P, sg, kp, (const Consts*)consts, lanes, b3c);
  return (int)cudaGetLastError();
}
