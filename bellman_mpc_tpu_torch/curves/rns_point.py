"""RNS curve ops — the point layer of the MSM window fold.

Port of bellman_mpc_tpu/curves/rns_point.py: the complete Renes–Costello–
Batina formulas (eprint 2015/1060, Algs 7-9, a = 0) over the RNS field engine
(fields/rns.py).  Coordinates are RnsVal wrappers over (C, *batch) residues
(G1) or (C, 2, *batch) (G2, axis 1 = Fp2 component).  The formulas are the
reference's line for line: their operation order fixes every K of every
subtraction, and with it the residues.

`point_add_mixed` is also the formula the fold kernels run
(ops/fold_kernels.py): the plain versions call it over a padded-layout shim,
and the same call, replayed on the host, yields the K sequence the CUDA
kernels are handed.  `point_add` is likewise the tree kernel's: the MSMs
reduce their accumulators level by level through
`ops/fold_kernels.rns_tree_level`, whose residues are `tree_reduce`'s.  The reference's other helpers are here too, held
against it by the tests: `point_double`, `point_select`, `is_stored_zero`
(its XLA fold tests the sentinel with it; the port's fold kernels and
their plain versions test it inside) and the bound proofs
`mixed_add_fixpoint` / `add_fixpoint`.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Tuple

import torch

from ..fields.rns import RnsField, RnsVal

RPoint = Tuple[RnsVal, RnsVal, RnsVal]


class RnsG1Ops:
    """Fp coordinate ops over RnsVal (residues (C, *batch))."""

    fp2 = False

    def __init__(self, f, b3: int):
        self.f = f
        self.b3 = b3

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def neg(self, a):
        return a.neg()

    def mul_b3(self, a):
        return a.scale(self.b3)

    def scale3(self, a):
        return a.scale(3)

    def mul_many(self, pairs):
        return self.f.mul_many(pairs)

    def zero(self, batch, device) -> RnsVal:
        return RnsVal(self.f, torch.zeros((self.f.C,) + tuple(batch), dtype=torch.int32,
                                          device=device), Fraction(1))

    def one(self, batch, device) -> RnsVal:
        # M-residue of 1 is M mod p
        r = self.f.encode_raw(self.f.M % self.f.p, device=device)
        return RnsVal(
            self.f,
            r.reshape((self.f.C,) + (1,) * len(batch)).expand((self.f.C,) + tuple(batch)),
            Fraction(1),
        )

    def select(self, cond, a: RnsVal, b: RnsVal) -> RnsVal:
        return RnsVal(self.f, torch.where(cond[None], a.res, b.res), max(a.a, b.a))

    def is_stored_zero(self, a: RnsVal):
        """All base channels zero: the exact integer 0 (the stored identity
        sentinel), not merely 0 mod p."""
        return torch.all(a.res[: self.f.k] == 0, dim=0)

    def wrap(self, res: torch.Tensor, a) -> RnsVal:
        return RnsVal(self.f, res, a)


class RnsG2Ops:
    """Fp2 = Fp[u]/(u^2+1) coordinate ops over RnsVal (residues
    (C, 2, *batch)); Karatsuba sub-products stack through ONE pipeline."""

    fp2 = True

    def __init__(self, f, b3c: int):
        self.f = f
        self.b3c = b3c

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def neg(self, a):
        return a.neg()

    def _c(self, a: RnsVal, i: int) -> RnsVal:
        return RnsVal(self.f, a.res[:, i], a.a)

    def _join(self, c0: RnsVal, c1: RnsVal) -> RnsVal:
        return RnsVal(self.f, torch.stack([c0.res, c1.res], dim=1), max(c0.a, c1.a))

    def mul_b3(self, a):
        c0, c1 = self._c(a, 0), self._c(a, 1)
        return self._join((c0 - c1).scale(self.b3c), (c0 + c1).scale(self.b3c))

    def scale3(self, a):
        return a.scale(3)

    def mul_many(self, pairs):
        sub = []
        for a, b in pairs:
            a0, a1 = self._c(a, 0), self._c(a, 1)
            b0, b1 = self._c(b, 0), self._c(b, 1)
            sub += [(a0, b0), (a1, b1), (a0 + a1, b0 + b1)]
        prods = self.f.mul_many(sub)
        out = []
        for i in range(len(pairs)):
            t0, t1, t2 = prods[3 * i : 3 * i + 3]
            out.append(self._join(t0 - t1, t2 - t0 - t1))
        return out

    def zero(self, batch, device) -> RnsVal:
        return RnsVal(self.f, torch.zeros((self.f.C, 2) + tuple(batch), dtype=torch.int32,
                                          device=device), Fraction(1))

    def one(self, batch, device) -> RnsVal:
        r = self.f.encode_raw(self.f.M % self.f.p, device=device)
        c0 = r.reshape((self.f.C,) + (1,) * len(batch)).expand((self.f.C,) + tuple(batch))
        return RnsVal(self.f, torch.stack([c0, torch.zeros_like(c0)], dim=1), Fraction(1))

    def select(self, cond, a: RnsVal, b: RnsVal) -> RnsVal:
        return RnsVal(self.f, torch.where(cond[None, None], a.res, b.res), max(a.a, b.a))

    def is_stored_zero(self, a: RnsVal):
        return torch.all(a.res[: self.f.k] == 0, dim=0).all(dim=0)

    def wrap(self, res: torch.Tensor, a) -> RnsVal:
        return RnsVal(self.f, res, a)


# ---------------------------------------------------------- point arithmetic


def point_identity(ops, batch, device) -> RPoint:
    return (ops.zero(batch, device), ops.one(batch, device), ops.zero(batch, device))


def point_select(ops, cond, p: RPoint, q: RPoint) -> RPoint:
    return tuple(ops.select(cond, a, b) for a, b in zip(p, q))


def point_add(ops, p: RPoint, q: RPoint) -> RPoint:
    """Complete addition, RCB15 Algorithm 7 (a=0)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0, t1, t2, m_xy, m_yz, m_xz = ops.mul_many(
        [
            (X1, X2),
            (Y1, Y2),
            (Z1, Z2),
            (ops.add(X1, Y1), ops.add(X2, Y2)),
            (ops.add(Y1, Z1), ops.add(Y2, Z2)),
            (ops.add(X1, Z1), ops.add(X2, Z2)),
        ]
    )
    t3 = ops.sub(ops.sub(m_xy, t0), t1)
    t4 = ops.sub(ops.sub(m_yz, t1), t2)
    y3b = ops.mul_b3(ops.sub(ops.sub(m_xz, t0), t2))
    t0_3 = ops.scale3(t0)
    t2b = ops.mul_b3(t2)
    Z3m = ops.add(t1, t2b)
    t1m = ops.sub(t1, t2b)
    p1, p2, p3, p4, p5, p6 = ops.mul_many(
        [
            (t4, y3b),
            (t3, t1m),
            (y3b, t0_3),
            (t1m, Z3m),
            (t0_3, t3),
            (Z3m, t4),
        ]
    )
    return (ops.sub(p2, p1), ops.add(p4, p3), ops.add(p6, p5))


def point_add_mixed(ops, p: RPoint, q: Tuple[RnsVal, RnsVal]) -> RPoint:
    """Complete mixed addition P + (x2, y2), RCB15 Algorithm 8 (a=0).
    `q` must not be the identity (callers select around the stored (0,0)
    sentinel); `p` may be any projective point."""
    X1, Y1, Z1 = p
    X2, Y2 = q
    t0, t1, t3p, t4p, y3p = ops.mul_many(
        [
            (X1, X2),
            (Y1, Y2),
            (ops.add(X1, Y1), ops.add(X2, Y2)),
            (Y2, Z1),
            (X2, Z1),
        ]
    )
    t3 = ops.sub(ops.sub(t3p, t0), t1)
    t4 = ops.add(t4p, Y1)
    y3b = ops.mul_b3(ops.add(y3p, X1))
    t0_3 = ops.scale3(t0)
    t2 = ops.mul_b3(Z1)
    Z3m = ops.add(t1, t2)
    t1m = ops.sub(t1, t2)
    q1, q2, q3, q4, q5, q6 = ops.mul_many(
        [
            (t3, t1m),
            (t4, y3b),
            (y3b, t0_3),
            (t1m, Z3m),
            (Z3m, t4),
            (t0_3, t3),
        ]
    )
    return (ops.sub(q1, q2), ops.add(q3, q4), ops.add(q5, q6))


def point_double(ops, p: RPoint) -> RPoint:
    """Doubling, RCB15 Algorithm 9 (a=0)."""
    X, Y, Z = p
    t0, t1, t2r, txy = ops.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
    t2 = ops.mul_b3(t2r)
    z8 = t0.scale(8)
    y3m = ops.add(t0, t2)
    t0a = ops.sub(t0, t2.scale(3))
    p1, p2, p3, p4 = ops.mul_many([(t2, z8), (t1, z8), (t0a, y3m), (t0a, txy)])
    return (p4.scale(2), ops.add(p1, p3), p2)


def tree_reduce(ops, p: RPoint, cap) -> RPoint:
    """Sum points along the LAST batch axis (a power of two), first half +
    second half at every level, re-pinning the coordinate bound to `cap`
    after every halving (asserted sound, as in the reference)."""
    X, Y, Z = p
    n = X.res.shape[-1]
    assert n & (n - 1) == 0

    def halves(v: RnsVal):
        m = v.res.shape[-1] // 2
        return ops.wrap(v.res[..., :m], v.a), ops.wrap(v.res[..., m:], v.a)

    while n > 1:
        hx, hy, hz = halves(X), halves(Y), halves(Z)
        X, Y, Z = point_add(ops, (hx[0], hy[0], hz[0]), (hx[1], hy[1], hz[1]))
        assert max(X.a, Y.a, Z.a) <= cap, "tree_reduce bound escape"
        X, Y, Z = (ops.wrap(v.res, cap) for v in (X, Y, Z))
        n //= 2
    return (X, Y, Z)


# ----------------------------------------------------- fixpoint verification


def mixed_add_fixpoint(ops, acc_bound: Fraction, table_bound: Fraction):
    """Host-side proof that `point_add_mixed` maps accumulator coordinates
    bounded by acc_bound (table coordinates by table_bound) back inside
    acc_bound, every intermediate within the RNS range (RnsVal's
    constructor asserts it): the formula run on one-lane dummies."""
    mk = lambda a: ops.wrap(ops.zero((1,), "cpu").res, Fraction(a))
    X3, Y3, Z3 = point_add_mixed(ops, (mk(acc_bound),) * 3, (mk(table_bound),) * 2)
    got = max(X3.a, Y3.a, Z3.a)
    assert got <= acc_bound, f"mixed-add bound fixpoint fails: {acc_bound} -> {got}"
    return got


def add_fixpoint(ops, cap: Fraction):
    """The same for `point_add` at the cap (the tree reduction's halvings)."""
    mk = lambda a: ops.wrap(ops.zero((1,), "cpu").res, Fraction(a))
    p = (mk(cap),) * 3
    X3, Y3, Z3 = point_add(ops, p, p)
    got = max(X3.a, Y3.a, Z3.a)
    assert got <= cap, f"add bound fixpoint fails: {cap} -> {got}"
    return got


# -------------------------------------------------------- limb <-> RNS bridge


def limb_coord_to_rns(f: RnsField, lf, arr: torch.Tensor, limb_bits: int = 11) -> RnsVal:
    """Canonical limb Montgomery coordinate (x*Rlimb mod p, lazy < 2p) ->
    RNS M-residue of x.  Exact-zero limbs map to exact-zero residues, so the
    (0,0) affine identity sentinel survives the conversion."""
    u = f.from_digits(arr, bound=2, limb_bits=limb_bits)
    c = (f.M * f.M % f.p) * pow(lf.R, -1, f.p) % f.p
    cv = RnsVal(f, f.encode_raw(c, like=u.res), Fraction(1))
    return f.mul(u, cv)


@functools.lru_cache(maxsize=None)
def default_rns_field() -> RnsField:
    from ..fields import bls12_381 as bc

    return RnsField(bc.P)


@functools.lru_cache(maxsize=None)
def rns_g1_ops() -> RnsG1Ops:
    from ..fields import bls12_381 as bc

    return RnsG1Ops(default_rns_field(), 3 * bc.B_G1)


@functools.lru_cache(maxsize=None)
def rns_g2_ops() -> RnsG2Ops:
    return RnsG2Ops(default_rns_field(), 12)


def rns_point_to_limb(ops, f: RnsField, lf, p: RPoint):
    """RNS projective point -> limb projective point (device.py layout)."""
    outs = []
    for v in p:
        if ops.fp2:
            c0 = f.to_limb_mont(RnsVal(f, v.res[:, 0], v.a), lf)
            c1 = f.to_limb_mont(RnsVal(f, v.res[:, 1], v.a), lf)
            outs.append(torch.stack([c0, c1], dim=1))
        else:
            outs.append(f.to_limb_mont(v, lf))
    return tuple(outs)
