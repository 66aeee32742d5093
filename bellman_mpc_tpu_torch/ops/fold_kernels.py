"""The MSM window-fold kernels: plain PyTorch versions and CUDA wrappers.

Counterpart of bellman_mpc_tpu/ops/pallas_kernels.py for the three TPU
kernels on the prover's main path:

  * K3 `rns_mul_many`       <- `_jit_rns_mul_pallas` / `_rns_mul_block`
    (stacked RNS Montgomery multiply on the padded (80, T) layout);
  * K1 `rns_fold_window`    <- `_jit_mixed_add_pallas` (one G1 fold window:
    acc <- acc + sign*Q by the complete mixed addition, b3 = 12);
  * K2 `rns_fold_window_g2` <- `_jit_mixed_add_pallas_g2` (the same on the
    G2 twist over Fp2, b3 = 12(1+u), Karatsuba grouping of `_ShimG2Ops`);

and one kernel the reference leaves to XLA:

  * K7 `rns_tree_level` (one level of the tree reduction that sums each
    MSM's folded accumulator, `rns_point.tree_reduce`'s halving by the
    complete addition, on the padded layout).

Each wrapper takes the plain PyTorch version ONLY for tensors on the CPU; a
CUDA tensor goes to the hand-written kernel (csrc/fold_kernels.cu) or the
wrapper raises.  There is no fallback and no switch around the kernels.
The library, its build and the launch counts are in ops/kernel_lib.py.

The kernels never re-derive the RNS bound bookkeeping.  The K of every
subtraction and negation of the mixed addition (RnsVal.__sub__ / neg add
K*p, K = ceil(bound)) is produced by `fold_schedule`, which runs the very
formula the plain versions run (`rns_point.point_add_mixed` over the padded
shim) on a one-lane host dummy and records each K in call order; K7's comes
from `tree_schedule` the same way (`rns_point.point_add`).  The
kernels consume that K*p table in the same order, so their residues equal
the plain versions' bit for bit.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..curves import rns_point as rpt
from ..curves.rns_point import RnsG1Ops, RnsG2Ops
from ..fields.rns import RnsVal
from .kernel_lib import device_kind, launch_counts, load, plain_counts, raise_on, stream

PAD_B = 40  # B channels at padded rows [0, 40) (35 real + 5 pad)
PAD_C = 80  # B' + m_r at padded rows [40, 80) (36 real + 4 pad)
G1_CAP = 128  # accumulator bound caps of the fold (in units of p)
G2_CAP = 256
# number of K*p residue rows each kernel consumes (one per sub/neg of the
# formula, in csrc/fold_kernels.cu's order); checked against fold_schedule
G1_NUM_K = 5
G2_NUM_K = 45
G1_TREE_NUM_K = 8  # the same for a level of the tree reduction (tree_schedule)
G2_TREE_NUM_K = 54
# base extensions on the tensor cores: targets padded to tiles of 8, sources
# to k-steps of 4 (csrc/fold_kernels.cu EXT_T, EXT_S)
EXT_T = 40
EXT_S = 36

# ----------------------------------------------------------- padded layout


@functools.lru_cache(maxsize=None)
def pad_consts(f) -> Dict[str, np.ndarray]:
    """Constants of the 80-row padded layout (the reference's
    `_rns_pallas_consts` without the int8 split), as numpy int64 arrays.

    B channels at rows [0, 35), B' at [40, 75), m_r at 75; pad rows carry
    modulus 1 (their residues stay 0 through every stage)."""
    k = f.k
    rows = np.concatenate([np.arange(k), PAD_B + np.arange(k + 1)])
    m_pad = np.ones((PAD_C,), np.int64)
    m_pad[rows] = np.asarray(f.moduli, np.int64)
    kappa = np.zeros((PAD_C,), np.int64)
    kappa[:k] = f.kappa_np[:k]
    minv_hi = np.zeros((PAD_B,), np.int64)  # Hi-local: B' at 0..34, m_r at 35
    minv_hi[:k] = f.minv_np[k : 2 * k]
    minv_hi[k] = f.minv_np[2 * k]
    ifac2_hi = np.zeros((PAD_B,), np.int64)
    ifac2_hi[:k] = f.ifac2_np[k : 2 * k]
    mp_mod_b = np.zeros((PAD_B,), np.int64)
    mp_mod_b[:k] = f.mp_mod_np[:k]
    m_e2 = m_pad[:PAD_B].copy()  # ext2 targets [B (35), m_r, pad]
    m_e2[k] = f.mr
    W1p = np.zeros((PAD_B, PAD_B), np.int64)  # [hi-local target, B source]
    W1p[: k + 1, :k] = f.W1_np
    W2p = np.zeros((PAD_B, PAD_B), np.int64)  # [ext2 target, hi-local source]
    W2p[: k + 1, :k] = f.W2_np
    pmod = np.asarray([f.p % int(m) for m in m_pad], np.int64)
    return dict(rows=rows, m_pad=m_pad, kappa=kappa, minv_hi=minv_hi,
                ifac2_hi=ifac2_hi, mp_mod_b=mp_mod_b, m_e2=m_e2, W1p=W1p,
                W2p=W2p, pmod=pmod)


_DEV_CACHE: Dict[tuple, torch.Tensor] = {}


def _dev_const(f, key: str, device) -> torch.Tensor:
    ck = (id(f), key, str(torch.device(device)))
    t = _DEV_CACHE.get(ck)
    if t is None:
        t = torch.from_numpy(pad_consts(f)[key]).to(device)
        _DEV_CACHE[ck] = t
    return t


def rns_pad_rows(f, x: torch.Tensor) -> torch.Tensor:
    """(71, *B) residues -> (80, *B) padded layout (zero pad rows)."""
    rows = _dev_const(f, "rows", x.device)
    out = torch.zeros((PAD_C,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[rows] = x
    return out


def rns_unpad_rows(f, x: torch.Tensor) -> torch.Tensor:
    return x[_dev_const(f, "rows", x.device)]


def pad_rns_table(f, tab):
    """RNS affine tables (x, y) with leading channel axis 71 -> the 80-row
    layout the fold kernels consume (the (0,0) sentinel is preserved)."""
    return tuple(rns_pad_rows(f, t) for t in tab)


# ------------------------------------------------------ plain K3 (the block)


def _col(f, key, like, lo=0, hi=None):
    c = _dev_const(f, key, like.device)[lo:hi]
    return c.reshape((c.shape[0],) + (1,) * (like.dim() - 1))


def rns_mul_block_plain(f, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One RNS Montgomery multiply on padded (80, T) residue tiles: the
    reference's `_rns_mul_block`, stage for stage, with exact integer
    reductions and float64 products for the two base extensions."""
    k = f.k
    m = _col(f, "m_pad", x)
    m_hi = _col(f, "m_pad", x, PAD_B)
    m_b = _col(f, "m_pad", x, 0, PAD_B)
    m_e2 = _col(f, "m_e2", x)
    t = (x.to(torch.int64) * y.to(torch.int64)) % m
    xi = (t * _col(f, "kappa", x)) % m
    W1 = _dev_const(f, "W1p", x.device).to(torch.float64)
    qp = torch.matmul(W1, xi[:PAD_B].to(torch.float64)).to(torch.int64) % m_hi
    sv = t[PAD_B:] + qp
    sv = torch.where(sv >= m_hi, sv - m_hi, sv)
    rp = (sv * _col(f, "minv_hi", x)) % m_hi
    xi2 = (rp * _col(f, "ifac2_hi", x)) % m_hi
    W2 = _dev_const(f, "W2p", x.device).to(torch.float64)
    ext2 = torch.matmul(W2, xi2.to(torch.float64)).to(torch.int64) % m_e2
    d = ext2[k] - rp[k]
    d = torch.where(d < 0, d + f.mr, d)
    alpha = (d * f.mpinv_mr) % f.mr
    corr = (alpha[None] * _col(f, "mp_mod_b", x)) % m_b
    rB = ext2 - corr
    rB = torch.where(rB < 0, rB + m_b, rB)
    rB[k] = 0  # m_r's slot in the B block
    return torch.cat([rB, rp], dim=0).to(torch.int32)


class PadShimField:
    """RnsField facade over the 80-row padded layout (the reference's
    `_PadShimField`): exactly the surface RnsVal and the point formulas
    touch, on flat (80, T) tiles or, for RnsG2Ops, stacked (80, 2, T) Fp2
    tiles.  K*p residues are exact (K * (p mod m)) mod m; `record`, when
    given, collects every K in call order (the kernels' schedule), once per
    component of a stacked tile, as the kernels consume them."""

    C = PAD_C

    def __init__(self, real, device, record: List[int] = None):
        self.real = real
        self.p = real.p
        self.Mmin = real.Mmin
        self.M = real.M
        self.k = real.k
        self._m = _dev_const(real, "m_pad", device)
        self._m32 = self._m.to(torch.int32)
        self._pmod = _dev_const(real, "pmod", device)
        self.record = record

    @staticmethod
    def _bc(col, like):
        return col.reshape((PAD_C,) + (1,) * (like.dim() - 1))

    def m_bc(self, like):
        return self._bc(self._m32, like)

    def reduce(self, t):
        return (t.to(torch.int64) % self._bc(self._m, t)).to(torch.int32)

    def kp_table(self, K: int, like):
        if self.record is not None:
            # the schedules replay one lane: flat (80, 1) tiles and, under
            # RnsG2Ops, stacked (80, 2, 1) Fp2 tiles, whose K the kernels
            # take once per component
            comps = {(PAD_C, 1): 1, (PAD_C, 2, 1): 2}.get(tuple(like.shape))
            assert comps, f"recording on a {tuple(like.shape)} tile, not one lane"
            self.record.extend([K] * comps)
        return self._bc((K * self._pmod) % self._m, like).to(torch.int32)

    def mul_many(self, pairs):
        T = pairs[0][0].res.shape[-1]
        xs = torch.cat([a.res for a, _ in pairs], dim=-1)
        ys = torch.cat([b.res for _, b in pairs], dim=-1)
        res = rns_mul_block_plain(self.real, xs, ys)
        outs = []
        for i, (a, b) in enumerate(pairs):
            bound = a.a * b.a * Fraction(self.p, self.M) + (self.k + 1)
            if bound.denominator != 1:
                bound = Fraction(bound.numerator // bound.denominator + 1)
            outs.append(RnsVal(self, res[..., i * T : (i + 1) * T], bound))
        return outs


class ShimG2Ops:
    """Fp2 coordinate ops over PAIRS of per-component RnsVals (c0, c1) —
    the reference's `_ShimG2Ops` (same Karatsuba grouping, same order)."""

    fp2 = True

    def __init__(self, f, b3c: int):
        self.f = f
        self.b3c = b3c

    def add(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def sub(self, a, b):
        return (a[0] - b[0], a[1] - b[1])

    def neg(self, a):
        return (a[0].neg(), a[1].neg())

    def mul_b3(self, a):
        return ((a[0] - a[1]).scale(self.b3c), (a[0] + a[1]).scale(self.b3c))

    def scale3(self, a):
        return (a[0].scale(3), a[1].scale(3))

    def mul_many(self, pairs):
        sub = []
        for a, b in pairs:
            a0, a1 = a
            b0, b1 = b
            sub += [(a0, b0), (a1, b1), (a0 + a1, b0 + b1)]
        prods = self.f.mul_many(sub)
        out = []
        for i in range(len(pairs)):
            t0, t1, t2 = prods[3 * i : 3 * i + 3]
            out.append((t0 - t1, t2 - t0 - t1))
        return out

    def select(self, cond, a, b):
        return tuple(
            RnsVal(self.f, torch.where(cond[None], x.res, y.res), max(x.a, y.a))
            for x, y in zip(a, b)
        )


def _stored_zero(f, r: torch.Tensor) -> torch.Tensor:
    """(80, T) tile -> (T,) bool: every B row exactly zero."""
    return torch.all(r[: f.k] == 0, dim=0)


def fold_window_g1_plain(f, b3: int, acc, qx, qy, sg, tab_n: int, cap: int, record=None):
    """Plain K1 on flat (80, T) tiles: the body of the reference's
    `_jit_mixed_add_pallas` kernel, formula for formula."""
    shim = PadShimField(f, qx.device, record)
    ops = RnsG1Ops(shim, b3)
    capf, tab_a = Fraction(cap), Fraction(tab_n)
    accv = tuple(RnsVal(shim, r, capf) for r in acc)
    qxv = RnsVal(shim, qx, tab_a)
    qyv0 = RnsVal(shim, qy, tab_a)
    # identity sentinel BEFORE the sign flip (neg adds K*p to the exact 0)
    inf = _stored_zero(f, qx) & _stored_zero(f, qy)
    qyv = ops.select(sg == 1, qyv0.neg(), qyv0)
    added = rpt.point_add_mixed(ops, accv, (qxv, qyv))
    assert max(v.a for v in added) <= capf, "fold bound escape"
    return tuple(torch.where(inf[None], a_in, v.res) for a_in, v in zip(acc, added))


def fold_window_g2_plain(f, b3c: int, acc, q, sg, tab_n: int, cap: int, record=None):
    """Plain K2 on flat (80, T) tiles: acc = 6 tiles (X0, X1, Y0, Y1, Z0,
    Z1), q = 4 tiles (x0, x1, y0, y1) — the body of `_jit_mixed_add_pallas_g2`."""
    shim = PadShimField(f, sg.device, record)
    ops = ShimG2Ops(shim, b3c)
    capf, tab_a = Fraction(cap), Fraction(tab_n)
    accv = tuple((RnsVal(shim, acc[2 * i], capf), RnsVal(shim, acc[2 * i + 1], capf)) for i in range(3))
    qx = (RnsVal(shim, q[0], tab_a), RnsVal(shim, q[1], tab_a))
    qy0 = (RnsVal(shim, q[2], tab_a), RnsVal(shim, q[3], tab_a))
    inf = _stored_zero(f, q[0]) & _stored_zero(f, q[1]) & _stored_zero(f, q[2]) & _stored_zero(f, q[3])
    qy = ops.select(sg == 1, ops.neg(qy0), qy0)
    added = rpt.point_add_mixed(ops, accv, (qx, qy))
    assert max(c.a for v in added for c in v) <= capf, "g2 fold bound escape"
    return tuple(
        torch.where(inf[None], acc[2 * i + c], added[i][c].res) for i in range(3) for c in range(2)
    )


def fold_window_g2_plain_stacked(f, b3c: int, acc, q, sg, tab_n: int, cap: int):
    """fold_window_g2_plain on K2's layout: acc (3) and q (2) are (80, 2,
    *batch) tensors, component axis 1, sg is (*batch); returns the three
    updated (80, 2, *batch) tensors."""
    shape = acc[0].shape
    lanes = int(np.prod(shape[2:]))
    comps = lambda ts: [t[:, c].reshape(PAD_C, lanes) for t in ts for c in range(2)]
    outs = fold_window_g2_plain(f, b3c, comps(acc), comps(q), sg.reshape(lanes).to(torch.int32), tab_n, cap)
    return tuple(torch.stack([outs[2 * i], outs[2 * i + 1]], dim=1).reshape(shape) for i in range(3))


@functools.lru_cache(maxsize=None)
def fold_schedule(f, b, tab_n: int, cap: int, g2: bool) -> Tuple[int, ...]:
    """The K of every sub/neg of one fold window, in call order: the plain
    formula replayed on one host lane (its bookkeeping asserts every bound)."""
    z = torch.zeros((PAD_C, 1), dtype=torch.int32)
    sg = torch.zeros((1,), dtype=torch.int32)
    ks: List[int] = []
    if g2:
        fold_window_g2_plain(f, b, (z,) * 6, (z,) * 4, sg, tab_n, cap, record=ks)
    else:
        fold_window_g1_plain(f, b, (z,) * 3, z, z, sg, tab_n, cap, record=ks)
    return tuple(ks)


# ------------------------------------------------------- the tree reduction


def tree_level_plain(f, b, acc, cap: int, g2: bool, record=None):
    """Plain version of one level of the tree reduction: acc = 3 padded
    (80, [2,] *outer, n) int32 tiles, n even -> 3 tiles (80, [2,] *outer,
    n/2), output lane (o, i) the complete sum (rpt.point_add, RCB15 Alg. 7)
    of the points at (o, i) and (o, n/2 + i), coordinates below cap * p in
    and out (asserted).  The formula runs over the padded shim with
    rns_point's own coordinate ops (for G2 RnsG2Ops's stacked bookkeeping,
    one bound for both components), so its residues are rpt.tree_reduce's."""
    shape = tuple(acc[0].shape)
    lead = shape[:2] if g2 else shape[:1]
    half = shape[-1] // 2
    if acc[0].is_cuda:
        plain_counts["rns_tree_add"] += 1
    shim = PadShimField(f, acc[0].device, record)
    ops = RnsG2Ops(shim, b) if g2 else RnsG1Ops(shim, b)
    capf = Fraction(cap)
    tiles = [t.reshape(lead + (-1, 2 * half)) for t in acc]
    p, q = (tuple(RnsVal(shim, t[..., s].reshape(lead + (-1,)), capf) for t in tiles)
            for s in (slice(0, half), slice(half, None)))
    out = rpt.point_add(ops, p, q)
    assert max(v.a for v in out) <= capf, "tree bound escape"
    return tuple(v.res.reshape(shape[:-1] + (half,)) for v in out)


@functools.lru_cache(maxsize=None)
def tree_schedule(f, b, cap: int, g2: bool) -> Tuple[int, ...]:
    """The K of every sub/neg of one tree level, in the order the kernel
    consumes them (a stacked G2 sub once per component): the plain level
    replayed on one host output lane at input bounds (cap, cap), whose
    bookkeeping asserts the output within cap."""
    z = torch.zeros((PAD_C, 2, 2) if g2 else (PAD_C, 2), dtype=torch.int32)
    ks: List[int] = []
    tree_level_plain(f, b, (z,) * 3, cap, g2, record=ks)
    return tuple(ks)


def _kp_rows(f, ks: Tuple[int, ...], device) -> torch.Tensor:
    """(len(ks), 80) int32 residues of K*p per padded row (exact host ints)."""
    ck = (id(f), ("kp", ks), str(torch.device(device)))
    t = _DEV_CACHE.get(ck)
    if t is None:
        m_pad = pad_consts(f)["m_pad"]
        arr = np.asarray([[(K * f.p) % int(m) for m in m_pad] for K in ks], np.int32)
        t = torch.from_numpy(arr).to(device)
        _DEV_CACHE[ck] = t
    return t


# ------------------------------------------------------ the kernels' constants


def kernel_consts_np(f) -> np.ndarray:
    """The kernels' constant block (uint32 words, see `Consts` in
    csrc/fold_kernels.cu): per padded row m, floor(2^32/m), kappa, M^-1
    (Hi rows), (M'/m'_j)^-1 (B' rows), M' mod m (B rows); then m_r and
    M'^-1 mod m_r.  The W tables go separately, as `ext_fragments_np`."""
    c = pad_consts(f)
    m = c["m_pad"]
    mu = np.asarray([min((1 << 32) // int(x), (1 << 32) - 1) for x in m], np.int64)
    minv = np.zeros(PAD_C, np.int64)
    minv[PAD_B:] = c["minv_hi"]
    ifac2 = np.zeros(PAD_C, np.int64)
    ifac2[PAD_B:] = c["ifac2_hi"]
    mpmod = np.zeros(PAD_C, np.int64)
    mpmod[:PAD_B] = c["mp_mod_b"]
    words = np.concatenate([m, mu, c["kappa"], minv, ifac2, mpmod,
                            np.asarray([f.mr, f.mpinv_mr], np.int64)])
    assert words.shape[0] == 6 * PAD_C + 2
    return words.astype(np.uint32).view(np.int32)


def _kernel_consts(f, device) -> torch.Tensor:
    ck = (id(f), "kernel_consts", str(torch.device(device)))
    t = _DEV_CACHE.get(ck)
    if t is None:
        t = torch.from_numpy(kernel_consts_np(f)).to(device)
        _DEV_CACHE[ck] = t
    return t


def ext_tables_np(f) -> np.ndarray:
    """(2, EXT_T, EXT_S) float64: W1 and W2 ([target][source]) zero-padded to
    the tensor-core tiles of csrc/fold_kernels.cu (36 targets -> 5 tiles of 8,
    35 sources -> 9 k-steps of 4).  Every extension sum is below
    35 * max(m - 1)^2 < 2^30, so the float64 products are exact."""
    assert f.k * (max(f.moduli) - 1) ** 2 < 1 << 30, "extension sums leave the exact range"
    W = np.zeros((2, EXT_T, EXT_S), np.float64)
    W[0, : f.k + 1, : f.k] = f.W1_np
    W[1, : f.k + 1, : f.k] = f.W2_np
    return W


def ext_fragments_np(f) -> np.ndarray:
    """ext_tables_np in the A-fragment order of mma.m8n8k4 .f64, flat:
    [table][8-target tile][k-step][lane], lane l holding W[8 tile + l // 4]
    [4 k + l % 4], so a warp loads each fragment as 32 consecutive doubles."""
    W = ext_tables_np(f).reshape(2, EXT_T // 8, 8, EXT_S // 4, 4)
    return np.ascontiguousarray(W.transpose(0, 1, 3, 2, 4)).reshape(-1)


def _ext_fragments(f, device) -> torch.Tensor:
    ck = (id(f), "ext_fragments", str(torch.device(device)))
    t = _DEV_CACHE.get(ck)
    if t is None:
        t = torch.from_numpy(ext_fragments_np(f)).to(device)
        _DEV_CACHE[ck] = t
    return t


def fold_wave_lanes() -> int:
    """Lanes that one full wave of K1's persistent blocks covers on the
    current CUDA device (blocks per SM x SMs x 8 lanes)."""
    return int(load().bmt_fold_g1_wave_lanes())


def fold_g2_wave_lanes() -> int:
    """Lanes that one full wave of K2's persistent blocks covers on the
    current CUDA device (blocks per SM x SMs x 8 lanes)."""
    return int(load().bmt_fold_g2_wave_lanes())


def tree_wave_lanes(g2: bool = False) -> int:
    """Output lanes that one full wave of the tree kernel's persistent
    blocks covers on the current CUDA device (blocks per SM x SMs x 8)."""
    lib = load()
    return int(lib.bmt_tree_g2_wave_lanes() if g2 else lib.bmt_tree_g1_wave_lanes())


def rns_mul_wave_lanes() -> int:
    """Lanes that one full wave of K3's persistent blocks covers on the
    current CUDA device (blocks per SM x SMs x 6 tiles x 8 lanes)."""
    return int(load().bmt_rns_mul_wave_lanes())


def _check_tiles(tiles, shape, device) -> None:
    for t in tiles:
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("fold kernels take contiguous int32 tensors on one CUDA device")
        if tuple(t.shape) != shape:
            raise ValueError(f"expected a {shape} tile, got {tuple(t.shape)}")


# ----------------------------------------------------------------- wrappers


def rns_mul_many(f, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """K3: stacked RNS Montgomery multiply of (71, *S) canonical residues
    (the reference's `rns_mul_many_pallas`); padded to 80 rows inside."""
    shape = xs.shape
    n = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    xp = rns_pad_rows(f, xs.reshape(f.C, n).to(torch.int32)).contiguous()
    yp = rns_pad_rows(f, ys.reshape(f.C, n).to(torch.int32)).contiguous()
    if device_kind(xp) == "cpu":
        out = rns_mul_block_plain(f, xp, yp)
    else:
        _check_tiles((xp, yp), (PAD_C, n), xp.device)
        out = torch.empty_like(xp)
        lib = load()
        err = lib.bmt_rns_mul(xp.data_ptr(), yp.data_ptr(), out.data_ptr(),
                              _kernel_consts(f, xp.device).data_ptr(),
                              _ext_fragments(f, xp.device).data_ptr(), n, stream(xp.device))
        raise_on(err, "bmt_rns_mul")
        launch_counts["rns_mul_many"] += 1
    return rns_unpad_rows(f, out).reshape(shape)


def _tab_n(tab_bound) -> int:
    tb = Fraction(tab_bound)
    return int(tb) if tb == int(tb) else int(tb) + 1


def rns_fold_window(f, b3: int, acc_res, q, sgn, tab_bound, cap):
    """K1: one G1 fold window, acc (+)= sign * table-point.

    acc_res: 3-tuple of (80, *batch) int32 padded residues; q: (qx, qy)
    padded residues of the gathered affine points; sgn: (*batch) bool.
    Returns the updated 3-tuple (the reference's `rns_fold_window_pallas`)."""
    shape = acc_res[0].shape
    lanes = int(np.prod(shape[1:]))
    flat = [r.reshape(PAD_C, lanes).contiguous() for r in acc_res]
    qf = [r.reshape(PAD_C, lanes).contiguous() for r in q]
    sg = sgn.reshape(lanes).to(torch.int32).contiguous()
    tab_n, cap = _tab_n(tab_bound), int(cap)
    if device_kind(sg) == "cpu":
        outs = fold_window_g1_plain(f, b3, flat, qf[0], qf[1], sg, tab_n, cap)
    else:
        dev = sg.device
        _check_tiles(flat + qf, (PAD_C, lanes), dev)
        ks = fold_schedule(f, b3, tab_n, cap, False)
        assert len(ks) == G1_NUM_K, "G1 schedule does not match the kernel"
        kp = _kp_rows(f, ks, dev)
        outs = tuple(torch.empty_like(flat[0]) for _ in range(3))
        lib = load()
        err = lib.bmt_fold_g1(
            *(t.data_ptr() for t in flat + qf), sg.data_ptr(),
            *(o.data_ptr() for o in outs), kp.data_ptr(), _kernel_consts(f, dev).data_ptr(),
            _ext_fragments(f, dev).data_ptr(), lanes, b3, stream(dev))
        raise_on(err, "bmt_fold_g1")
        launch_counts["rns_fold_window"] += 1
    return tuple(o.reshape(shape) for o in outs)


def rns_fold_window_g2(f, b3c: int, acc_res, q, sgn, tab_bound, cap):
    """K2: one G2 fold window; acc_res / q are tuples of (80, 2, *batch)
    padded residues (component axis 1); sgn (*batch) bool (the reference's
    `rns_fold_window_pallas_g2`).  On the card the kernel reads and writes
    these tensors in place of per-component copies, so they must be
    contiguous."""
    shape = acc_res[0].shape
    lanes = int(np.prod(shape[2:]))
    sg = sgn.reshape(lanes).to(torch.int32).contiguous()
    tab_n, cap = _tab_n(tab_bound), int(cap)
    if device_kind(sg) == "cpu":
        return fold_window_g2_plain_stacked(f, b3c, acc_res, q, sg, tab_n, cap)
    dev = sg.device
    _check_tiles(tuple(acc_res) + tuple(q), tuple(shape), dev)
    ks = fold_schedule(f, b3c, tab_n, cap, True)
    assert len(ks) == G2_NUM_K, "G2 schedule does not match the kernel"
    kp = _kp_rows(f, ks, dev)
    outs = tuple(torch.empty_like(acc_res[0]) for _ in range(3))
    lib = load()
    err = lib.bmt_fold_g2(
        *(t.data_ptr() for t in tuple(acc_res) + tuple(q)), sg.data_ptr(),
        *(o.data_ptr() for o in outs), kp.data_ptr(), _kernel_consts(f, dev).data_ptr(),
        _ext_fragments(f, dev).data_ptr(), lanes, b3c, stream(dev))
    raise_on(err, "bmt_fold_g2")
    launch_counts["rns_fold_window_g2"] += 1
    return outs


def rns_tree_level(f, b, acc_res, cap, g2: bool = False):
    """One level of the RNS tree reduction, one launch of
    `tree_add_kernel<G1Ops>` or `<G2Ops>` on the card: acc_res, 3 contiguous
    padded (80, [2,] *outer, n) int32 tiles (n even; component axis 1 for
    G2) -> 3 tiles (80, [2,] *outer, n/2), lane (o, i) = point (o, i) +
    point (o, n/2 + i) by the complete addition (`tree_level_plain`, taken
    for CPU tensors); coordinates below cap * p in and out.  b is the
    curve's b3 (G1) or b3c (G2)."""
    shape = tuple(acc_res[0].shape)
    n = shape[-1]
    if n < 2 or n % 2:
        raise ValueError(f"a tree level halves an even lane axis, got {n}")
    cap = int(cap)
    if device_kind(acc_res[0]) == "cpu":
        return tree_level_plain(f, b, acc_res, cap, g2)
    dev = acc_res[0].device
    _check_tiles(acc_res, shape, dev)
    if g2 and (len(shape) < 3 or shape[1] != 2):
        raise ValueError(f"G2 tiles are (80, 2, ..., n), got {shape}")
    half = n // 2
    outer = int(np.prod(shape[2 if g2 else 1 : -1]))
    ks = tree_schedule(f, b, cap, g2)
    assert len(ks) == (G2_TREE_NUM_K if g2 else G1_TREE_NUM_K), "tree schedule does not match the kernel"
    kp = _kp_rows(f, ks, dev)
    outs = tuple(torch.empty(shape[:-1] + (half,), dtype=torch.int32, device=dev) for _ in range(3))
    name = "bmt_tree_add_g2" if g2 else "bmt_tree_add_g1"
    err = getattr(load(), name)(
        *(t.data_ptr() for t in acc_res), *(o.data_ptr() for o in outs), kp.data_ptr(),
        _kernel_consts(f, dev).data_ptr(), _ext_fragments(f, dev).data_ptr(), outer, half, b, stream(dev))
    raise_on(err, name)
    launch_counts["rns_tree_add"] += 1
    return outs
