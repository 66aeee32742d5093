"""Batched Fp2/Fp6/Fp12 tower arithmetic on limb tensors.

Port of bellman_mpc_tpu/ops/tower.py: the tower of fields/tower.py
(Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3-xi) with xi = 1+u,
Fp12 = Fp6[w]/(w^2-v)) over (L, *batch) int32 limb tensors.  Elements are
nested tuples, as in the reference, so raw limbs compare with it:

    Fp2  = (c0, c1)                      each (L, *B)
    Fp6  = (a0, a1, a2)                  each Fp2
    Fp12 = (b0, b1)                      each Fp6

Multiplications run on the lazy-column engine of fields/limb.py: all the
Karatsuba sub-products of one operation go through ONE stacked product
(`lazy_mul_many`), every combine is an int32 column add, and each output
coefficient costs ONE stacked Montgomery reduction (`lazy_reduce_many`).
Column and digit bounds are proven on the host as the tensors are built.
The Fp products outside that engine (`fp2_mul_fp`, `fp2_mul_const`,
`fp2_inv`) are `LimbField.mul` calls: the K4 kernel on CUDA tensors.

Frobenius maps use gamma constants (powers of xi) computed exactly on the
host at import and placed on the operand's device when used.  Functions
that create or encode elements take the batch shape and a `device`.
"""

from __future__ import annotations

import torch

from ..fields import tower as ht
from ..fields.bls12_381 import P, fp
from ..fields.limb import LIMB_MASK, LazyFp2

F = fp  # the base field


# ----------------------------------------------------- lazy-column internals
# Operands are ((c0, c1), dvec), dvec the exact per-limb digit bound.


def _lz2_op(a):
    return (a, F._dmax_lazy)


def _lz2_dsum(x, y):
    """Digit-wise sum of two Fp2 operands (folds once when digits exceed
    the canonical range, so nested sums keep their products int32-safe)."""
    (a, da), (b, db) = x, y
    s0, s1 = a[0] + b[0], a[1] + b[1]
    dv = tuple(p + q for p, q in zip(da, db))
    if max(dv) > LIMB_MASK + 1:
        s0, dv2 = F.fold_digits(s0, dv)
        s1, _ = F.fold_digits(s1, dv)
        return ((s0, s1), dv2)
    return ((s0, s1), dv)


def _lz2_mul_many(pairs):
    """k unreduced Fp2 Karatsuba products via ONE (3k-lane) product."""
    arrs, dms = [], []
    for (a, da), (b, db) in pairs:
        arrs += [(a[0], b[0]), (a[1], b[1]), (a[0] + a[1], b[0] + b[1])]
        dms += [
            (da, db),
            (da, db),
            (tuple(2 * x for x in da), tuple(2 * x for x in db)),
        ]
    prods = F.lazy_mul_many(arrs, dms)
    out = []
    for i in range(len(pairs)):
        t0, t1, t2 = prods[3 * i : 3 * i + 3]
        out.append(LazyFp2(t0 - t1, t2 - t0 - t1))
    return out


def _lz2_reduce_many(ls):
    flat = []
    for l in ls:
        flat += [l.re, l.im]
    red = F.lazy_reduce_many(flat)
    return [(red[2 * i], red[2 * i + 1]) for i in range(len(ls))]


def _lz6_opnd(x):
    return tuple(_lz2_op(c) for c in x)


def _lz6_pairs(A, B):
    """The 6 Karatsuba Fp2 sub-products of one Fp6 multiply (operand form)."""
    a0, a1, a2 = A
    b0, b1, b2 = B
    return [
        (a0, b0),
        (a1, b1),
        (a2, b2),
        (_lz2_dsum(a1, a2), _lz2_dsum(b1, b2)),
        (_lz2_dsum(a0, a1), _lz2_dsum(b0, b1)),
        (_lz2_dsum(a0, a2), _lz2_dsum(b0, b2)),
    ]


def _lz6_combine(prods):
    """6 LazyFp2 sub-products -> (c0, c1, c2) LazyFp2 coefficients."""
    t0, t1, t2, m12, m01, m02 = prods
    c0 = t0 + (m12 - t1 - t2).mul_by_xi()
    c1 = (m01 - t0 - t1) + t2.mul_by_xi()
    c2 = (m02 - t0 - t2) + t1
    return (c0, c1, c2)


def _fp12_from_outs(outs):
    return ((outs[0], outs[1], outs[2]), (outs[3], outs[4], outs[5]))


# ------------------------------------------------------------------------ Fp2
def fp2_add(a, b):
    return (F.add(a[0], b[0]), F.add(a[1], b[1]))


def fp2_sub(a, b):
    return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))


def fp2_neg(a):
    return (F.neg(a[0]), F.neg(a[1]))


def fp2_conj(a):
    return (a[0], F.neg(a[1]))


def fp2_mul_many(pairs):
    """Multiply many independent Fp2 pairs through ONE product and ONE
    stacked Montgomery reduction (the Karatsuba recombination is int32
    column arithmetic)."""
    return _lz2_reduce_many(
        _lz2_mul_many([(_lz2_op(a), _lz2_op(b)) for a, b in pairs])
    )


def fp2_mul(a, b):
    return fp2_mul_many([(a, b)])[0]


def fp2_square(a):
    return fp2_mul(a, a)


def fp2_mul_fp(a, s):
    """Multiply by an Fp element (s broadcasts over components)."""
    return (F.mul(a[0], s), F.mul(a[1], s))


def fp2_mul_const(a, c0: int, c1: int):
    """Multiply by the host constant c0 + c1*u."""
    if c1 == 0:
        return (F.mul_const(a[0], c0), F.mul_const(a[1], c0))
    re = F.sub(F.mul_const(a[0], c0), F.mul_const(a[1], c1))
    im = F.add(F.mul_const(a[0], c1), F.mul_const(a[1], c0))
    return (re, im)


def fp2_mul_by_xi(a):
    """Multiply by xi = 1 + u."""
    return (F.sub(a[0], a[1]), F.add(a[0], a[1]))


def fp2_inv(a):
    d = F.add(F.mul(a[0], a[0]), F.mul(a[1], a[1]))
    dinv = F.inv(d)
    return (F.mul(a[0], dinv), F.mul(F.neg(a[1]), dinv))


def fp2_zero(batch, device):
    return (F.zeros(batch, device), F.zeros(batch, device))


def fp2_one(batch, device):
    return (F.const(1, batch, device=device), F.zeros(batch, device))


def fp2_select(cond, a, b):
    return (F.select(cond, a[0], b[0]), F.select(cond, a[1], b[1]))


def fp2_is_zero(a):
    return torch.logical_and(F.is_zero(a[0]), F.is_zero(a[1]))


def fp2_eq(a, b):
    return torch.logical_and(F.eq(a[0], b[0]), F.eq(a[1], b[1]))


def fp2_encode(vals, device):
    return (
        F.encode([v[0] for v in vals], device=device),
        F.encode([v[1] for v in vals], device=device),
    )


def fp2_decode(a):
    return list(zip(F.decode(a[0]), F.decode(a[1])))


# ------------------------------------------------------------------------ Fp6
def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def _fp6_mul_pairs(a, b):
    """The 6 Karatsuba Fp2 sub-products of one Fp6 multiply."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    return [
        (a0, b0),
        (a1, b1),
        (a2, b2),
        (fp2_add(a1, a2), fp2_add(b1, b2)),
        (fp2_add(a0, a1), fp2_add(b0, b1)),
        (fp2_add(a0, a2), fp2_add(b0, b2)),
    ]


def _fp6_mul_combine(products):
    t0, t1, t2, m12, m01, m02 = products
    c0 = fp2_add(t0, fp2_mul_by_xi(fp2_sub(m12, fp2_add(t1, t2))))
    c1 = fp2_add(fp2_sub(m01, fp2_add(t0, t1)), fp2_mul_by_xi(t2))
    c2 = fp2_add(fp2_sub(m02, fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fp6_mul(a, b):
    prods = _lz2_mul_many(_lz6_pairs(_lz6_opnd(a), _lz6_opnd(b)))
    return tuple(_lz2_reduce_many(_lz6_combine(prods)))


def fp6_mul_by_v(a):
    return (fp2_mul_by_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    s00, s12, s22, s01, s11, s02 = fp2_mul_many(
        [(a0, a0), (a1, a2), (a2, a2), (a0, a1), (a1, a1), (a0, a2)]
    )
    c0 = fp2_sub(s00, fp2_mul_by_xi(s12))
    c1 = fp2_sub(fp2_mul_by_xi(s22), s01)
    c2 = fp2_sub(s11, s02)
    p0, p1, p2 = fp2_mul_many([(a0, c0), (a1, c2), (a2, c1)])
    t = fp2_add(p0, fp2_mul_by_xi(fp2_add(p1, p2)))
    tinv = fp2_inv(t)
    return tuple(fp2_mul_many([(c0, tinv), (c1, tinv), (c2, tinv)]))


def fp6_zero(batch, device):
    return (fp2_zero(batch, device), fp2_zero(batch, device), fp2_zero(batch, device))


def fp6_one(batch, device):
    return (fp2_one(batch, device), fp2_zero(batch, device), fp2_zero(batch, device))


# ----------------------------------------------------------------------- Fp12
def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_mul(a, b):
    """Full Fp12 multiply: ONE 54-lane product, int32 column combines, and
    ONE stacked 12-lane Montgomery reduction (one per coefficient)."""
    A0, A1 = _lz6_opnd(a[0]), _lz6_opnd(a[1])
    B0, B1 = _lz6_opnd(b[0]), _lz6_opnd(b[1])
    As = tuple(_lz2_dsum(x, y) for x, y in zip(A0, A1))
    Bs = tuple(_lz2_dsum(x, y) for x, y in zip(B0, B1))
    prods = _lz2_mul_many(
        _lz6_pairs(A0, B0) + _lz6_pairs(A1, B1) + _lz6_pairs(As, Bs)
    )
    t0 = _lz6_combine(prods[0:6])
    t1 = _lz6_combine(prods[6:12])
    m = _lz6_combine(prods[12:18])
    # c0 = t0 + v*t1 (v-mul rotates: (xi*x2, x0, x1)); c1 = m - t0 - t1
    c0 = (t0[0] + t1[2].mul_by_xi(), t0[1] + t1[0], t0[2] + t1[1])
    c1 = tuple(m[i] - t0[i] - t1[i] for i in range(3))
    return _fp12_from_outs(_lz2_reduce_many(list(c0) + list(c1)))


def fp12_square(a):
    """Complex-method squaring over Fp6: (c0+c1w)^2 via m=(c0+c1)(c0+v c1),
    t=c0*c1, out = (m - t - v*t, 2t).  12 Fp2 product lanes instead of the
    18 of a generic multiply; all combines stay at the column level."""
    c0, c1 = a
    A0, A1 = _lz6_opnd(c0), _lz6_opnd(c1)
    S = tuple(_lz2_dsum(x, y) for x, y in zip(A0, A1))
    vc1 = (fp2_mul_by_xi(c1[2]), c1[0], c1[1])  # v * c1 (element level)
    V = tuple(_lz2_dsum(x, _lz2_op(y)) for x, y in zip(A0, vc1))
    prods = _lz2_mul_many(_lz6_pairs(A0, A1) + _lz6_pairs(S, V))
    t = _lz6_combine(prods[0:6])
    m = _lz6_combine(prods[6:12])
    vt = (t[2].mul_by_xi(), t[0], t[1])
    out0 = tuple(m[i] - t[i] - vt[i] for i in range(3))
    out1 = tuple(2 * t[i] for i in range(3))
    return _fp12_from_outs(_lz2_reduce_many(list(out0) + list(out1)))


def fp12_mul_by_0bc(f, A, B, C):
    """Sparse multiply f * (A + B w^3 + C w^5) (the Miller-loop line shape:
    c0 = (A,0,0), c1 = (0,B,C) in Fp6[w] coordinates).  14 Fp2 product
    lanes instead of a generic multiply's 18."""
    f0, f1 = f
    el = _lz2_op
    x0, x1, x2 = el(f0[0]), el(f0[1]), el(f0[2])
    y0, y1, y2 = el(f1[0]), el(f1[1]), el(f1[2])
    sA, sB, sC = el(A), el(B), el(C)
    pairs = (
        [(x0, sA), (x1, sA), (x2, sA)]  # t_a = f0 * (A,0,0)
        + [  # t_b = f1 * (0,B,C), Karatsuba on the (1,2) block
            (y1, sB),
            (y2, sC),
            (_lz2_dsum(y1, y2), _lz2_dsum(sB, sC)),
            (y0, sB),
            (y0, sC),
        ]
        + _lz6_pairs(  # (f0+f1) * (A,B,C)
            (_lz2_dsum(x0, y0), _lz2_dsum(x1, y1), _lz2_dsum(x2, y2)),
            (sA, sB, sC),
        )
    )
    prods = _lz2_mul_many(pairs)
    ta = prods[0:3]
    t1, t2, m12, y0B, y0C = prods[3:8]
    tb0 = (m12 - t1 - t2).mul_by_xi()  # xi*(y1 C + y2 B)
    tb1 = y0B + t2.mul_by_xi()
    tb2 = y0C + t1
    mf = _lz6_combine(prods[8:14])
    c0 = (ta[0] + tb2.mul_by_xi(), ta[1] + tb0, ta[2] + tb1)  # t_a + v*t_b
    c1 = (
        mf[0] - ta[0] - tb0,
        mf[1] - ta[1] - tb1,
        mf[2] - ta[2] - tb2,
    )
    return _fp12_from_outs(_lz2_reduce_many(list(c0) + list(c1)))


def fp12_cyclotomic_square(a):
    """Granger-Scott squaring for elements of the cyclotomic subgroup
    G_{Phi6(p^2)} (anything after the final exponentiation's easy part).
    9 Fp2 squarings instead of a full multiply: one 27-lane product, one
    12-lane stacked reduction and 3 element passes."""
    (c00, c01, c02), (c10, c11, c12) = a
    el = _lz2_op
    prods = _lz2_mul_many(
        [
            (el(c11), el(c11)),
            (el(c00), el(c00)),
            (_lz2_dsum(el(c11), el(c00)), _lz2_dsum(el(c11), el(c00))),
            (el(c02), el(c02)),
            (el(c10), el(c10)),
            (_lz2_dsum(el(c02), el(c10)), _lz2_dsum(el(c02), el(c10))),
            (el(c12), el(c12)),
            (el(c01), el(c01)),
            (_lz2_dsum(el(c12), el(c01)), _lz2_dsum(el(c12), el(c01))),
        ]
    )
    t0, t1, s0, t2, t3, s1, t4, t5, s2 = prods
    t6 = s0 - t0 - t1  # 2 c00 c11
    t7 = s1 - t2 - t3  # 2 c02 c10
    t8 = (s2 - t4 - t5).mul_by_xi()  # 2 c01 c12 * xi
    u0 = t0.mul_by_xi() + t1  # c00^2 + xi c11^2
    u2 = t2.mul_by_xi() + t3  # c10^2 + xi c02^2
    u4 = t4.mul_by_xi() + t5  # c01^2 + xi c12^2
    T0, T2, T4, T8, T6, T7 = _lz2_reduce_many(
        [3 * u0, 3 * u2, 3 * u4, 3 * t8, 3 * t6, 3 * t7]
    )
    # z0j = 3u - 2c0j ; z1j = 3t + 2c1j  (one stacked double + add/sub pass)
    sub_t = torch.stack([T0[0], T0[1], T2[0], T2[1], T4[0], T4[1]], dim=1)
    sub_c = torch.stack([c00[0], c00[1], c01[0], c01[1], c02[0], c02[1]], dim=1)
    add_t = torch.stack([T8[0], T8[1], T6[0], T6[1], T7[0], T7[1]], dim=1)
    add_c = torch.stack([c10[0], c10[1], c11[0], c11[1], c12[0], c12[1]], dim=1)
    zs = F.sub(sub_t, F.add(sub_c, sub_c))
    za = F.add(add_t, F.add(add_c, add_c))
    return (
        ((zs[:, 0], zs[:, 1]), (zs[:, 2], zs[:, 3]), (zs[:, 4], zs[:, 5])),
        ((za[:, 0], za[:, 1]), (za[:, 2], za[:, 3]), (za[:, 4], za[:, 5])),
    )


def fp12_conj(a):
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    sq = fp2_mul_many(_fp6_mul_pairs(a[0], a[0]) + _fp6_mul_pairs(a[1], a[1]))
    a0sq = _fp6_mul_combine(sq[0:6])
    a1sq = _fp6_mul_combine(sq[6:12])
    t = fp6_inv(fp6_sub(a0sq, fp6_mul_by_v(a1sq)))
    pr = fp2_mul_many(_fp6_mul_pairs(a[0], t) + _fp6_mul_pairs(a[1], t))
    return (_fp6_mul_combine(pr[0:6]), fp6_neg(_fp6_mul_combine(pr[6:12])))


def fp12_one(batch, device):
    return (fp6_one(batch, device), fp6_zero(batch, device))


def tree_map(fn, *trees):
    """fn over the leaves of equally nested tuples of tensors."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return tuple(tree_map(fn, *subs) for subs in zip(*trees))


def fp12_select(cond, a, b):
    """cond ? a : b, cond an (*B) bool tensor broadcast over the limbs."""
    return tree_map(lambda x, y: F.select(cond, x, y), a, b)


def fp12_is_one(a):
    like = a[0][0][0]
    one = fp12_one(tuple(like.shape[1:]), like.device)
    acc = None
    for i in range(2):
        for j in range(3):
            for k in range(2):
                flag = F.eq(a[i][j][k], one[i][j][k])
                acc = flag if acc is None else torch.logical_and(acc, flag)
    return acc


def fp12_encode(vals, device):
    """Host Fp12 tuples -> device element."""
    return tuple(
        tuple(fp2_encode([v[i][j] for v in vals], device) for j in range(3))
        for i in range(2)
    )


def fp12_decode(a):
    c = [[fp2_decode(a[i][j]) for j in range(3)] for i in range(2)]
    n = len(c[0][0])
    return [
        (
            (c[0][0][k], c[0][1][k], c[0][2][k]),
            (c[1][0][k], c[1][1][k], c[1][2][k]),
        )
        for k in range(n)
    ]


# ------------------------------------------------------------- Frobenius maps
# gamma constants: xi^(k(p-1)/6) in Fp2, computed exactly on the host.
_XI = (1, 1)
_G = [ht.fp2_pow(_XI, k * (P - 1) // 6) for k in range(6)]


def _const_fp2(c, like):
    """A host Fp2 constant as a broadcast element on `like`'s device."""

    def enc(v):
        return F.limbs_const(v % P * F.R % P, like).expand(like.shape)

    return (enc(c[0]), enc(c[1]))


_FROB1_CONSTS = [
    _G[2],
    _G[4],
    _G[1],
    ht.fp2_mul(_G[1], _G[2]),
    ht.fp2_mul(_G[1], _G[4]),
]
_G2C = [ht.fp2_pow(_XI, k * (P * P - 1) // 6) for k in range(6)]
_FROB2_CONSTS = [
    _G2C[2],
    _G2C[4],
    _G2C[1],
    ht.fp2_mul(_G2C[1], _G2C[2]),
    ht.fp2_mul(_G2C[1], _G2C[4]),
]


def fp12_frobenius(a):
    """x -> x^p: conjugate coefficients, scale by gamma constants (one
    stacked multiply for all five scaled coefficients)."""
    (a0, a1, a2), (b0, b1, b2) = a
    like = a0[0]
    elems = [fp2_conj(x) for x in (a1, a2, b0, b1, b2)]
    prods = fp2_mul_many(
        [(e, _const_fp2(c, like)) for e, c in zip(elems, _FROB1_CONSTS)]
    )
    return ((fp2_conj(a0), prods[0], prods[1]), (prods[2], prods[3], prods[4]))


def fp12_frobenius2(a):
    """x -> x^(p^2): real constants, no conjugation."""
    (a0, a1, a2), (b0, b1, b2) = a
    like = a0[0]
    prods = fp2_mul_many(
        [
            (e, _const_fp2(c, like))
            for e, c in zip((a1, a2, b0, b1, b2), _FROB2_CONSTS)
        ]
    )
    return ((a0, prods[0], prods[1]), (prods[2], prods[3], prods[4]))
