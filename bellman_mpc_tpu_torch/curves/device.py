"""Projective curve ops for G1 (over Fp) and G2 (over Fp2) on limb tensors.

Port of bellman_mpc_tpu/curves/device.py: homogeneous projective (X : Y : Z)
with identity (0 : 1 : 0) and the Renes–Costello–Batina complete formulas
(eprint 2015/1060, Algs 7-9, a = 0), evaluated with the same lazy-column
structure, so raw limbs match the reference.

G1 coordinate = (L, *batch); G2 coordinate = (L, 2, *batch) with axis 1 the
Fp2 component.  Functions that create points take an explicit `device`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fields import bls12_381 as bc
from ..fields.limb import LazyCols, LazyFp2, LimbField
from . import host as chost


# ------------------------------------------------------------- coordinate ops
class DevFp:
    """Fp coordinate ops — thin veneer over LimbField (shape (L, *B))."""

    def __init__(self, field: LimbField, b3: int):
        self.f = field
        self.b3 = b3 % field.p

    def add(self, a, b):
        return self.f.add(a, b)

    def sub(self, a, b):
        return self.f.sub(a, b)

    def mul(self, a, b):
        return self.f.mul(a, b)

    def mul_many(self, pairs):
        lhs = torch.stack([a for a, _ in pairs], dim=1)
        rhs = torch.stack([b for _, b in pairs], dim=1)
        t = self.f.mul(lhs, rhs)
        return [t[:, i] for i in range(len(pairs))]

    def b3_element(self, like):
        """b3 (Montgomery form) broadcast like `like`."""
        f = self.f
        return f.limbs_const(self.b3 * f.R % f.p, like).expand(like.shape)

    def neg(self, a):
        return self.f.neg(a)

    def mul_b3(self, a):
        return self.f.mul_const(a, self.b3)

    def zero(self, batch, device):
        return self.f.zeros(batch, device)

    def one(self, batch, device):
        return self.f.const(1, batch, device=device)

    def select(self, cond, a, b):
        return torch.where(cond[None], a, b)

    def is_zero(self, a):
        return self.f.is_zero(a)

    def eq(self, a, b):
        return self.f.eq(a, b)

    def batch_shape(self, a):
        return tuple(a.shape[1:])

    def inv(self, a):
        return self.f.inv(a)

    # -- lazy-column interface (operands are (tensor, digit-bound vector)) ---
    def lop(self, arr):
        return (arr, self.f._dmax_lazy)

    def ldsum(self, a, b):
        dm = self.f._dmax_lazy
        return (a + b, tuple(2 * d for d in dm))

    def lmul_many(self, pairs):
        return self.f.lazy_mul_many(
            [(a, b) for (a, _), (b, _) in pairs],
            [(da, db) for (_, da), (_, db) in pairs],
        )

    def lreduce_many(self, lcs, wide: bool = False):
        return self.f.lazy_reduce_many(lcs, wide=wide)

    def llift(self, a) -> LazyCols:
        """Lift of a reduced element into columns [L, 2L) (value a*R)."""
        f = self.f
        return LazyCols(f, torch.cat([torch.zeros_like(a), a], dim=0), (0,) * f.L + f._dmax_lazy)

    def lb3(self, lc: LazyCols) -> LazyCols:
        return lc.fold().scale(self.b3)

    def encode(self, vals: Sequence[int], device):
        return self.f.encode(list(vals), device=device)

    def decode(self, arr) -> List[int]:
        return self.f.decode(arr)


class DevFp2:
    """Fp2 = Fp[u]/(u^2+1) coordinate ops on (L, 2, *B) tensors."""

    def __init__(self, field: LimbField, b3c0: int, b3c1: int):
        self.f = field
        self.b3c0 = b3c0 % field.p
        self.b3c1 = b3c1 % field.p

    def add(self, a, b):
        return self.f.add(a, b)

    def sub(self, a, b):
        return self.f.sub(a, b)

    def neg(self, a):
        return self.f.neg(a)

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def mul_many(self, pairs):
        """k Fp2 products via ONE (L, 3k, *B) limb multiply (Karatsuba)."""
        f = self.f
        lhs, rhs = [], []
        for a, b in pairs:
            a0, a1 = a[:, 0], a[:, 1]
            b0, b1 = b[:, 0], b[:, 1]
            lhs += [a0, a1, f.add(a0, a1)]
            rhs += [b0, b1, f.add(b0, b1)]
        prod = f.mul(torch.stack(lhs, dim=1), torch.stack(rhs, dim=1))
        out = []
        for i in range(len(pairs)):
            t0, t1, t2 = prod[:, 3 * i], prod[:, 3 * i + 1], prod[:, 3 * i + 2]
            out.append(torch.stack([f.sub(t0, t1), f.sub(t2, f.add(t0, t1))], dim=1))
        return out

    def b3_element(self, like):
        f = self.f
        c0 = f.limbs_const(self.b3c0 * f.R % f.p, like[:, 0]).expand(like[:, 0].shape)
        c1 = f.limbs_const(self.b3c1 * f.R % f.p, like[:, 0]).expand(like[:, 0].shape)
        return torch.stack([c0, c1], dim=1)

    def mul_b3(self, a):
        f = self.f
        a0, a1 = a[:, 0], a[:, 1]
        re = f.sub(f.mul_const(a0, self.b3c0), f.mul_const(a1, self.b3c1))
        im = f.add(f.mul_const(a0, self.b3c1), f.mul_const(a1, self.b3c0))
        return torch.stack([re, im], dim=1)

    def zero(self, batch, device):
        return self.f.zeros((2,) + tuple(batch), device)

    def one(self, batch, device):
        one = self.f.const(1, batch, device=device)
        return torch.stack([one, self.f.zeros(tuple(batch), device)], dim=1)

    def select(self, cond, a, b):
        return torch.where(cond[None, None], a, b)

    def is_zero(self, a):
        return torch.logical_and(self.f.is_zero(a[:, 0]), self.f.is_zero(a[:, 1]))

    def eq(self, a, b):
        return torch.logical_and(self.f.eq(a[:, 0], b[:, 0]), self.f.eq(a[:, 1], b[:, 1]))

    def batch_shape(self, a):
        return tuple(a.shape[2:])

    def inv(self, a):
        f = self.f
        a0, a1 = a[:, 0], a[:, 1]
        sq = f.mul(torch.stack([a0, a1], dim=1), torch.stack([a0, a1], dim=1))
        d = f.add(sq[:, 0], sq[:, 1])
        dinv = f.inv(d)
        return torch.stack([f.mul(a0, dinv), f.mul(f.neg(a1), dinv)], dim=1)

    # -- lazy-column interface (values are LazyFp2) --------------------------
    def lop(self, arr):
        return (arr, self.f._dmax_lazy)

    def ldsum(self, a, b):
        dm = self.f._dmax_lazy
        return self.f.fold_digits(a + b, tuple(2 * d for d in dm))

    def lmul_many(self, pairs):
        f = self.f
        arrs, dmaxes = [], []
        for (a, da), (b, db) in pairs:
            a0, a1 = a[:, 0], a[:, 1]
            b0, b1 = b[:, 0], b[:, 1]
            da2 = tuple(2 * x for x in da)
            db2 = tuple(2 * x for x in db)
            arrs += [(a0, b0), (a1, b1), (a0 + a1, b0 + b1)]
            dmaxes += [(da, db), (da, db), (da2, db2)]
        prods = f.lazy_mul_many(arrs, dmaxes)
        out = []
        for i in range(len(pairs)):
            t0, t1, t2 = prods[3 * i : 3 * i + 3]
            out.append(LazyFp2(t0 - t1, t2 - t0 - t1))
        return out

    def lreduce_many(self, lfp2s, wide: bool = False):
        flat = []
        for l in lfp2s:
            flat += [l.re, l.im]
        red = self.f.lazy_reduce_many(flat, wide=wide)
        return [torch.stack([red[2 * i], red[2 * i + 1]], dim=1) for i in range(len(lfp2s))]

    def llift(self, a) -> LazyFp2:
        f = self.f

        def lift1(x):
            return LazyCols(f, torch.cat([torch.zeros_like(x), x], dim=0), (0,) * f.L + f._dmax_lazy)

        return LazyFp2(lift1(a[:, 0]), lift1(a[:, 1]))

    def lb3(self, l: LazyFp2) -> LazyFp2:
        assert self.b3c0 == self.b3c1, "lazy b3 assumes b3 = c*(1+u)"
        c = self.b3c0
        re, im = l.re.fold(), l.im.fold()
        return LazyFp2((re - im).scale(c), (re + im).scale(c))

    def encode(self, vals: Sequence[Tuple[int, int]], device):
        c0 = self.f.encode([v[0] for v in vals], device=device)
        c1 = self.f.encode([v[1] for v in vals], device=device)
        return torch.stack([c0, c1], dim=1)

    def decode(self, arr) -> List[Tuple[int, int]]:
        c0 = self.f.decode(arr[:, 0])
        c1 = self.f.decode(arr[:, 1])
        return list(zip(c0, c1))


# ---------------------------------------------------------- point arithmetic
Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (X, Y, Z)


def point_identity(ops, batch, device) -> Point:
    return (ops.zero(batch, device), ops.one(batch, device), ops.zero(batch, device))


def point_add(ops, p: Point, q: Point) -> Point:
    """Complete addition, RCB15 Algorithm 7 (a=0), with lazy reduction."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    el = ops.lop
    t0, t1, t2, m_xy, m_yz, m_xz = ops.lmul_many(
        [
            (el(X1), el(X2)),
            (el(Y1), el(Y2)),
            (el(Z1), el(Z2)),
            (ops.ldsum(X1, Y1), ops.ldsum(X2, Y2)),
            (ops.ldsum(Y1, Z1), ops.ldsum(Y2, Z2)),
            (ops.ldsum(X1, Z1), ops.ldsum(X2, Z2)),
        ]
    )
    t2b = ops.lb3(t2)
    t3, t4, y3b, t0_3, Z3m, t1m = ops.lreduce_many(
        [
            m_xy - t0 - t1,
            m_yz - t1 - t2,
            ops.lb3(m_xz - t0 - t2),
            3 * t0,
            t1 + t2b,
            t1 - t2b,
        ]
    )
    p1, p2, p3, p4, p5, p6 = ops.lmul_many(
        [
            (el(t4), el(y3b)),
            (el(t3), el(t1m)),
            (el(y3b), el(t0_3)),
            (el(t1m), el(Z3m)),
            (el(t0_3), el(t3)),
            (el(Z3m), el(t4)),
        ]
    )
    X3, Y3, Z3 = ops.lreduce_many([p2 - p1, p4 + p3, p6 + p5])
    return (X3, Y3, Z3)


def point_add_mixed(ops, p: Point, q) -> Point:
    """Complete mixed addition P + (x2, y2), RCB15 Algorithm 8 (a=0).
    `q` must not be the identity; `p` may be any projective point."""
    X1, Y1, Z1 = p
    X2, Y2 = q
    el = ops.lop
    t0, t1, t3p, t4p, y3p, t2 = ops.lmul_many(
        [
            (el(X1), el(X2)),
            (el(Y1), el(Y2)),
            (ops.ldsum(X1, Y1), ops.ldsum(X2, Y2)),
            (el(Y2), el(Z1)),
            (el(X2), el(Z1)),
            (el(Z1), el(ops.b3_element(Z1))),
        ]
    )
    t3, t0_3, Z3m, t1m, t4, y3raw = ops.lreduce_many(
        [
            t3p - t0 - t1,
            3 * t0,
            t1 + t2,
            t1 - t2,
            t4p + ops.llift(Y1),
            y3p + ops.llift(X1),
        ],
        wide=True,
    )
    q1, q2, q3, q4, q5, q6 = ops.lmul_many(
        [
            (el(t3), el(t1m)),
            (el(t4), el(y3raw)),
            (el(y3raw), el(t0_3)),
            (el(t1m), el(Z3m)),
            (el(Z3m), el(t4)),
            (el(t0_3), el(t3)),
        ]
    )
    X3, Y3, Z3 = ops.lreduce_many([q1 - ops.lb3(q2), ops.lb3(q3) + q4, q5 + q6])
    return (X3, Y3, Z3)


def point_double(ops, p: Point) -> Point:
    """Doubling, RCB15 Algorithm 9 (a=0), with lazy reduction."""
    X, Y, Z = p
    el = ops.lop
    t0, t1, t2r, txy = ops.lmul_many(
        [(el(Y), el(Y)), (el(Y), el(Z)), (el(Z), el(Z)), (el(X), el(Y))]
    )
    t2 = ops.lb3(t2r)
    z3_8y2, y3_mid, t0_adj, t1e, txye, t2re = ops.lreduce_many(
        [8 * t0, t0 + t2, t0 - 3 * t2, t1, txy, t2r]
    )
    x3p_raw, z3p, y3p, x3q = ops.lmul_many(
        [
            (el(t2re), el(z3_8y2)),
            (el(t1e), el(z3_8y2)),
            (el(t0_adj), el(y3_mid)),
            (el(t0_adj), el(txye)),
        ]
    )
    X3, Y3, Z3 = ops.lreduce_many([2 * x3q, ops.lb3(x3p_raw) + y3p, z3p])
    return (X3, Y3, Z3)


def point_select(ops, cond, p: Point, q: Point) -> Point:
    return tuple(ops.select(cond, a, b) for a, b in zip(p, q))


def point_is_identity(ops, p: Point):
    return ops.is_zero(p[2])


def scalar_mul_bits(ops, p: Point, bits: torch.Tensor) -> Point:
    """Branchless left-to-right double-and-add; `bits` is (nbits, *batch)
    int32, MSB first; `p` broadcasts over the batch."""
    batch = tuple(bits.shape[1:])
    acc = point_identity(ops, batch, bits.device)
    for i in range(bits.shape[0]):
        acc = point_double(ops, acc)
        added = point_add(ops, acc, p)
        acc = point_select(ops, bits[i] == 1, added, acc)
    return acc


def scalar_mul_const(ops, p: Point, k: int) -> Point:
    """Double-and-add for a host-constant scalar: unrolled, select-free."""
    if k == 0:
        return point_identity(ops, ops.batch_shape(p[0]), p[0].device)
    acc = p
    for b in bin(k)[3:]:
        acc = point_double(ops, acc)
        if b == "1":
            acc = point_add(ops, acc, p)
    return acc


def tree_reduce(ops, p: Point) -> Point:
    """Sum all points along the LAST batch axis (a power of two), pairing
    the first half with the second half at every level (as the reference)."""
    X, Y, Z = p
    n = X.shape[-1]
    assert n & (n - 1) == 0
    while n > 1:
        half = n // 2
        X, Y, Z = point_add(
            ops,
            (X[..., :half], Y[..., :half], Z[..., :half]),
            (X[..., half:], Y[..., half:], Z[..., half:]),
        )
        n = half
    return (X, Y, Z)


def to_affine(ops, p: Point):
    """(x, y, is_infinity) with batched Fermat inversion of Z."""
    X, Y, Z = p
    inf = point_is_identity(ops, p)
    zsafe = ops.select(inf, ops.one(ops.batch_shape(Z), Z.device), Z)
    zinv = ops.inv(zsafe)
    return ops.mul(X, zinv), ops.mul(Y, zinv), inf


# ----------------------------------------------------------- group instances
fp_ops = DevFp(bc.fp, 3 * bc.B_G1)  # b3 = 12
fp2_ops = DevFp2(bc.fp, 12, 12)  # b3 = 12(1+u)


class DeviceGroup:
    """Bundles coordinate ops + host mirror group + codecs for one of G1/G2."""

    def __init__(self, ops, host_group: chost.CurveGroup, name: str):
        self.ops = ops
        self.host = host_group
        self.name = name

    def encode_points(self, pts: Sequence[Optional[tuple]], device) -> Point:
        """Host affine points (None = identity) -> projective limb tensors."""
        if self.name == "G1":
            xs = [p[0] if p else 0 for p in pts]
            ys = [p[1] if p else 1 for p in pts]
        else:
            xs = [p[0] if p else (0, 0) for p in pts]
            ys = [p[1] if p else (1, 0) for p in pts]
        zs_host = [0 if p is None else 1 for p in pts]
        X = self.ops.encode(xs, device)
        Y = self.ops.encode(ys, device)
        if self.name == "G1":
            Z = bc.fp.encode(zs_host, device=device)
        else:
            Z = self.ops.encode([(z, 0) for z in zs_host], device)
        return (X, Y, Z)

    def decode_points(self, p: Point) -> List[Optional[tuple]]:
        """Projective limb tensors -> host affine points."""
        x, y, inf = to_affine(self.ops, p)
        xs = self.ops.decode(x)
        ys = self.ops.decode(y)
        infs = inf.reshape(-1).cpu().numpy()
        return [None if i else (xv, yv) for xv, yv, i in zip(xs, ys, infs)]


g1_device = DeviceGroup(fp_ops, chost.G1, "G1")
g2_device = DeviceGroup(fp2_ops, chost.G2, "G2")


def scalars_to_bits(scalars: Sequence[int], nbits: int, device="cpu") -> torch.Tensor:
    """Host ints -> (nbits, N) int32 bit matrix, MSB first."""
    n = len(scalars)
    out = np.zeros((nbits, n), np.int32)
    for j, s in enumerate(scalars):
        for i in range(nbits):
            out[nbits - 1 - i, j] = (s >> i) & 1
    return torch.from_numpy(out).to(device)
