"""Host (exact bigint) BLS12-381 extension-field tower: Fp2, Fp6, Fp12.

Tower construction (the standard one used by every BLS12-381 implementation,
including the reference's `bls12_381` crate):

    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1
    Fp12 = Fp6[w] / (w^2 - v)

Elements are immutable tuples of ints; all ops are exact.  This module is the
*oracle* for the TPU tower kernels and also the host-side compute path for
scalar-sized work (single pairings in ceremony bookkeeping, Gt formatting).
"""

from __future__ import annotations

from typing import Tuple

from .bls12_381 import P

Fp2T = Tuple[int, int]
Fp6T = Tuple[Fp2T, Fp2T, Fp2T]
Fp12T = Tuple[Fp6T, Fp6T]


# ------------------------------------------------------------------------ Fp2
FP2_ZERO: Fp2T = (0, 0)
FP2_ONE: Fp2T = (1, 0)


def fp2_add(a: Fp2T, b: Fp2T) -> Fp2T:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a: Fp2T, b: Fp2T) -> Fp2T:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a: Fp2T) -> Fp2T:
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a: Fp2T, b: Fp2T) -> Fp2T:
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fp2_square(a: Fp2T) -> Fp2T:
    return fp2_mul(a, a)


def fp2_mul_scalar(a: Fp2T, k: int) -> Fp2T:
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a: Fp2T) -> Fp2T:
    return (a[0], (-a[1]) % P)


def fp2_inv(a: Fp2T) -> Fp2T:
    d = (a[0] * a[0] + a[1] * a[1]) % P
    dinv = pow(d, P - 2, P)
    return (a[0] * dinv % P, (-a[1]) * dinv % P)


def fp2_mul_by_xi(a: Fp2T) -> Fp2T:
    """Multiply by the Fp6 non-residue xi = 1 + u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fp2_is_zero(a: Fp2T) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def fp2_pow(a: Fp2T, e: int) -> Fp2T:
    r = FP2_ONE
    base = a
    while e:
        if e & 1:
            r = fp2_mul(r, base)
        base = fp2_mul(base, base)
        e >>= 1
    return r


# ------------------------------------------------------------------------ Fp6
FP6_ZERO: Fp6T = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE: Fp6T = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a: Fp6T, b: Fp6T) -> Fp6T:
    return tuple(fp2_add(x, y) for x, y in zip(a, b))  # type: ignore


def fp6_sub(a: Fp6T, b: Fp6T) -> Fp6T:
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))  # type: ignore


def fp6_neg(a: Fp6T) -> Fp6T:
    return tuple(fp2_neg(x) for x in a)  # type: ignore


def fp6_mul(a: Fp6T, b: Fp6T) -> Fp6T:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(t0, fp2_mul_by_xi(
        fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2))))
    c1 = fp2_add(
        fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)),
        fp2_mul_by_xi(t2))
    c2 = fp2_add(
        fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fp6_mul_by_v(a: Fp6T) -> Fp6T:
    """Multiply by v (shifts coefficients, wraps through xi)."""
    return (fp2_mul_by_xi(a[2]), a[0], a[1])


def fp6_inv(a: Fp6T) -> Fp6T:
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_square(a0), fp2_mul_by_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_by_xi(fp2_square(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_square(a1), fp2_mul(a0, a2))
    t = fp2_add(fp2_mul(a0, c0),
                fp2_mul_by_xi(fp2_add(fp2_mul(a1, c2), fp2_mul(a2, c1))))
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


# ----------------------------------------------------------------------- Fp12
FP12_ZERO: Fp12T = (FP6_ZERO, FP6_ZERO)
FP12_ONE: Fp12T = (FP6_ONE, FP6_ZERO)


def fp12_add(a: Fp12T, b: Fp12T) -> Fp12T:
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a: Fp12T, b: Fp12T) -> Fp12T:
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_neg(a: Fp12T) -> Fp12T:
    return (fp6_neg(a[0]), fp6_neg(a[1]))


def fp12_mul(a: Fp12T, b: Fp12T) -> Fp12T:
    t0 = fp6_mul(a[0], b[0])
    t1 = fp6_mul(a[1], b[1])
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(
        fp6_mul(fp6_add(a[0], a[1]), fp6_add(b[0], b[1])), fp6_add(t0, t1))
    return (c0, c1)


def fp12_square(a: Fp12T) -> Fp12T:
    return fp12_mul(a, a)


def fp12_conj(a: Fp12T) -> Fp12T:
    """Conjugation = Frobenius^6 (negates the w-odd part)."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a: Fp12T) -> Fp12T:
    t = fp6_inv(fp6_sub(fp6_mul(a[0], a[0]), fp6_mul_by_v(fp6_mul(a[1], a[1]))))
    return (fp6_mul(a[0], t), fp6_neg(fp6_mul(a[1], t)))


def fp12_pow(a: Fp12T, e: int) -> Fp12T:
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    r = FP12_ONE
    base = a
    while e:
        if e & 1:
            r = fp12_mul(r, base)
        base = fp12_mul(base, base)
        e >>= 1
    return r


def fp12_eq(a: Fp12T, b: Fp12T) -> bool:
    def n2(x):
        return (x[0] % P, x[1] % P)

    def n6(x):
        return tuple(n2(c) for c in x)

    return (n6(a[0]), n6(a[1])) == (n6(b[0]), n6(b[1]))


def fp12_is_one(a: Fp12T) -> bool:
    return fp12_eq(a, FP12_ONE)


# Convenience embeddings -----------------------------------------------------
def fp12_from_fp(x: int) -> Fp12T:
    return (((x % P, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO)


def fp12_from_fp2(x: Fp2T) -> Fp12T:
    return ((x, FP2_ZERO, FP2_ZERO), FP6_ZERO)


# w and its small powers (w^2 = v):  w   = (0, w-part 1)
FP12_W: Fp12T = (FP6_ZERO, (FP2_ONE, FP2_ZERO, FP2_ZERO))
FP12_W2: Fp12T = ((FP2_ZERO, FP2_ONE, FP2_ZERO), FP6_ZERO)  # = v
FP12_W3: Fp12T = (FP6_ZERO, (FP2_ZERO, FP2_ONE, FP2_ZERO))  # = v*w
