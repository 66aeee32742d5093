"""Host (exact bigint) optimal-ate pairing on BLS12-381 — the oracle.

Deliberately the *simplest correct* construction: untwist G2 points into
E(Fp12), run an affine Miller loop with generic line functions, and apply the
final exponentiation as a single bigint power (p^12-1)/r.  Slow, but every
step is obviously the textbook definition — this anchors the correctness of
the optimized TPU pairing kernel (ops/pairing.py), which must agree with it
bit-for-bit on random inputs.

Replaces the reference's `pairing`/`MultiMillerLoop` surface
(bellman/Cargo.toml:26, used at e.g. bellman/src/groth16/verifier.rs:49-56
and throughout bellman/src/groth16/mpc.rs pairing checks).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..fields.bls12_381 import P, R, X
from ..fields import tower as tw
from ..fields.tower import (
    FP12_ONE, FP12_W2, FP12_W3, Fp12T,
    fp12_add, fp12_conj, fp12_from_fp, fp12_from_fp2, fp12_inv, fp12_mul,
    fp12_neg, fp12_pow, fp12_sub, fp12_eq,
)

# Inverses of w^2, w^3 used for untwisting (computed once, exactly).
_W2_INV = fp12_inv(FP12_W2)
_W3_INV = fp12_inv(FP12_W3)

FINAL_EXP = (P ** 12 - 1) // R

_ABS_X_BITS = bin(-X)[2:]  # X < 0 for BLS12-381


def untwist(q) -> Tuple[Fp12T, Fp12T]:
    """Map an affine point of E'(Fp2): y^2=x^3+4(u+1) to E(Fp12): y^2=x^3+4."""
    (x, y) = q
    return (
        fp12_mul(fp12_from_fp2(x), _W2_INV),
        fp12_mul(fp12_from_fp2(y), _W3_INV),
    )


def _fp12_div(a: Fp12T, b: Fp12T) -> Fp12T:
    return fp12_mul(a, fp12_inv(b))


def _pt_add(t, q):
    """Affine addition in E(Fp12) (distinct x assumed handled by caller)."""
    (x1, y1), (x2, y2) = t, q
    lam = _fp12_div(fp12_sub(y2, y1), fp12_sub(x2, x1))
    x3 = fp12_sub(fp12_sub(fp12_mul(lam, lam), x1), x2)
    y3 = fp12_sub(fp12_mul(lam, fp12_sub(x1, x3)), y1)
    return (x3, y3)


def _pt_double(t):
    (x1, y1) = t
    three_x2 = fp12_mul(fp12_from_fp(3), fp12_mul(x1, x1))
    lam = _fp12_div(three_x2, fp12_mul(fp12_from_fp(2), y1))
    x3 = fp12_sub(fp12_mul(lam, lam), fp12_mul(fp12_from_fp(2), x1))
    y3 = fp12_sub(fp12_mul(lam, fp12_sub(x1, x3)), y1)
    return (x3, y3)


def _line(t, q, pt) -> Fp12T:
    """Evaluate the line through t and q (tangent when t == q) at pt."""
    (x1, y1), (x2, y2) = t, q
    xp, yp = pt
    if fp12_eq(x1, x2) and fp12_eq(y1, y2):
        num = fp12_mul(fp12_from_fp(3), fp12_mul(x1, x1))
        den = fp12_mul(fp12_from_fp(2), y1)
    elif fp12_eq(x1, x2):
        # vertical line
        return fp12_sub(xp, x1)
    else:
        num = fp12_sub(y2, y1)
        den = fp12_sub(x2, x1)
    lam = _fp12_div(num, den)
    return fp12_sub(fp12_sub(yp, y1), fp12_mul(lam, fp12_sub(xp, x1)))


def miller_loop(p_g1, q_g2) -> Fp12T:
    """Miller loop f_{|X|,Q}(P); conjugated at the end because X < 0."""
    if p_g1 is None or q_g2 is None:
        return FP12_ONE
    pt = (fp12_from_fp(p_g1[0]), fp12_from_fp(p_g1[1]))
    q = untwist(q_g2)
    t = q
    f = FP12_ONE
    for bit in _ABS_X_BITS[1:]:
        f = fp12_mul(fp12_mul(f, f), _line(t, t, pt))
        t = _pt_double(t)
        if bit == "1":
            f = fp12_mul(f, _line(t, q, pt))
            t = _pt_add(t, q)
    return fp12_conj(f)


def final_exponentiation(f: Fp12T) -> Fp12T:
    return fp12_pow(f, FINAL_EXP)


def multi_miller_loop(terms) -> Fp12T:
    """Product of Miller loops (mirrors pairing::multi_miller_loop)."""
    acc = FP12_ONE
    for (p_g1, q_g2) in terms:
        acc = fp12_mul(acc, miller_loop(p_g1, q_g2))
    return acc


def pairing(p_g1, q_g2) -> Fp12T:
    """e(P, Q) for affine host points (None = identity)."""
    return final_exponentiation(miller_loop(p_g1, q_g2))
