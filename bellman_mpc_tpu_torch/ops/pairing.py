"""Batched optimal-ate pairing on limb tensors.

Port of bellman_mpc_tpu/ops/pairing.py: a vectorized Miller loop and final
exponentiation over a batch axis, for the verifier's pairing-product check
and the ceremony's thousands of independent pairing equations.

Construction (the reference's, validated against the exact host oracle
curves/pairing_host.py):

  * G2 points stay on the twist E'(Fp2): y^2 = x^3 + 4(1+u).  The Miller
    variable T is homogeneous projective in DevFp2's stacked (L, 2, *B)
    layout and is advanced with the complete add/double formulas of the
    curve code (curves/device.py).
  * Line functions are evaluated in untwisted form, scaled by xi and by the
    Fp2 denominator (both die in the final exponentiation), as the sparse
    element A + B*w^3 + C*w^5 with, for doubling at T = (X, Y, Z):
        A = 2YZ^2 * yP * xi,  B = 3X^3 - 2Y^2 Z,  C = -3X^2 Z * xP
    and for addition with affine Q = (xQ, yQ):
        D = X - xQ Z, N = Y - yQ Z,
        A = D * yP * xi,  B = N xQ - yQ D,  C = -N * xP.
  * The BLS parameter x is negative: f is conjugated after the loop.
  * The loop runs doubling runs between the 6 set bits of |x| (`_RUNS`,
    read at call time) with an add step after each run.
  * Final exponentiation: easy part (p^6-1)(p^2+1) via conjugation,
    inversion and Frobenius; exact hard part (p^4-p^2+1)/r as a square-and-
    multiply ladder of Granger-Scott squarings, or the x-chain for
    equality checks (`final_exp_eq_batch`).

The exponent bits are host constants, so the ladders multiply only where a
bit is set: the reference's `fp12_select(bit, r * f, r)` keeps r untouched
where the bit is clear, so the limbs are the same.

Batch sizes are padded up to a bucket (`_bucket`), with identity lanes
encoded as in the reference, so the shapes of a call stay fixed.  Every
entry point takes a `device` (default the first CUDA card).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..curves.device import fp2_ops, point_add, point_double
from ..curves.host import G1
from ..fields.bls12_381 import P, R, X, fp
from . import tower as tw

ABS_X = -X
# Doubling-run lengths between add steps (the MSB of |x| is consumed by
# the initialization T = Q, f = 1).
_BITS = bin(ABS_X)[3:]
_RUNS: List[Tuple[int, bool]] = []  # (number of doublings, then add?)
_count = 0
for _b in _BITS:
    _count += 1
    if _b == "1":
        _RUNS.append((_count, True))
        _count = 0
if _count:
    _RUNS.append((_count, False))

_HARD_EXP = (P ** 4 - P ** 2 + 1) // R
_HARD_EXP_BITS = bin(_HARD_EXP)[2:]
_ABS_X_BITS = bin(ABS_X)[2:]


def _stacked(q):
    """fp2 tuple -> (L, 2, *B) stacked representation of the point code."""
    return torch.stack([q[0], q[1]], dim=1)


def _unstacked(s):
    return (s[:, 0], s[:, 1])


def _dbl_step(T, xp_neg3, yp_xi2):
    """Line coefficients for the tangent at T, then T <- 2T.

    xp_neg3 = -3*xP (Fp), yp_xi2 = 2*yP (Fp); the step's Fp2 products run as
    two stacked multiplies, the point update as three (point_double)."""
    Xs, Ys, Zs = T
    Xt, Yt, Zt = _unstacked(Xs), _unstacked(Ys), _unstacked(Zs)
    X2, Y2, YZ = tw.fp2_mul_many([(Xt, Xt), (Yt, Yt), (Yt, Zt)])
    X3, Y2Z2, X2Z, YZZ = tw.fp2_mul_many(
        [
            (X2, Xt),
            (tw.fp2_add(Y2, Y2), Zt),
            (X2, Zt),
            (YZ, Zt),
        ]
    )
    A = tw.fp2_mul_by_xi(tw.fp2_mul_fp(YZZ, yp_xi2))
    B = tw.fp2_sub(tw.fp2_add(tw.fp2_add(X3, X3), X3), Y2Z2)
    C = tw.fp2_mul_fp(X2Z, xp_neg3)
    T2 = point_double(fp2_ops, T)
    return (A, B, C), T2


def _add_step(T, Q, xq, yq, xp_neg1, yp):
    """Line through T and affine Q, then T <- T + Q."""
    Xs, Ys, Zs = T
    Xt, Yt, Zt = _unstacked(Xs), _unstacked(Ys), _unstacked(Zs)
    xqZ, yqZ = tw.fp2_mul_many([(xq, Zt), (yq, Zt)])
    D = tw.fp2_sub(Xt, xqZ)
    N = tw.fp2_sub(Yt, yqZ)
    Nxq, yqD = tw.fp2_mul_many([(N, xq), (yq, D)])
    A = tw.fp2_mul_by_xi(tw.fp2_mul_fp(D, yp))
    B = tw.fp2_sub(Nxq, yqD)
    C = tw.fp2_mul_fp(N, xp_neg1)
    T2 = point_add(fp2_ops, T, Q)
    return (A, B, C), T2


def miller_loop_batch(px, py, qx, qy, mask_valid):
    """Batched Miller loop f_{|x|,Q}(P), conjugated (x < 0).

    px, py: (L, N) Fp tensors (Montgomery), an affine G1 batch;
    qx, qy: fp2 tuples, an affine G2 batch (on the twist);
    mask_valid: (N,) bool; False lanes yield f = 1 (identity pairs)."""
    batch = tuple(px.shape[1:])
    dev = px.device
    xp_neg3 = fp.neg(fp.add(fp.add(px, px), px))
    xp_neg1 = fp.neg(px)
    yp2 = fp.add(py, py)

    Q_stacked = (
        _stacked(qx),
        _stacked(qy),
        _stacked(tw.fp2_one(batch, dev)),
    )
    f = tw.fp12_one(batch, dev)
    T = Q_stacked
    for run_len, then_add in _RUNS:
        for _ in range(run_len):
            f = tw.fp12_square(f)
            (A, B, C), T = _dbl_step(T, xp_neg3, yp2)
            f = tw.fp12_mul_by_0bc(f, A, B, C)
        if then_add:
            (A, B, C), T = _add_step(T, Q_stacked, qx, qy, xp_neg1, py)
            f = tw.fp12_mul_by_0bc(f, A, B, C)

    f = tw.fp12_conj(f)  # x < 0
    return tw.fp12_select(mask_valid, f, tw.fp12_one(batch, dev))


def _easy_part(f):
    """f^((p^6-1)(p^2+1)): conjugate over inverse, then Frobenius^2."""
    f1 = tw.fp12_mul(tw.fp12_conj(f), tw.fp12_inv(f))
    return tw.fp12_mul(tw.fp12_frobenius2(f1), f1)


def _ladder(f, bits: str):
    """f^e for cyclotomic f, e given by its bits (MSB first): a Granger-
    Scott squaring per bit from 1, and a multiply by f per set bit."""
    like = f[0][0][0]
    r = tw.fp12_one(tuple(like.shape[1:]), like.device)
    for bit in bits:
        r = tw.fp12_cyclotomic_square(r)
        if bit == "1":
            r = tw.fp12_mul(r, f)
    return r


def final_exp_batch(f):
    """(p^12-1)/r in three classical stages (the exact canonical value)."""
    return _ladder(_easy_part(f), _HARD_EXP_BITS)


def _pow_abs_x(f):
    """f^|x| for cyclotomic f (64 Granger-Scott squarings, 6 products)."""
    return _ladder(f, _ABS_X_BITS)


def final_exp_eq_batch(f):
    """f^(3*(p^12-1)/r) via the BLS x-chain: EQUALITY-preserving only.

    Uses the identity (x-1)^2 (x+p) (x^2+p^2-1) + 3 = 3*(p^4-p^2+1)/r
    (asserted at import).  The extra cube is harmless for pairing-product
    comparisons (mu_r has prime order r != 3, so cubing is a bijection
    there) but the VALUE differs from the canonical e(P,Q): use
    final_exp_batch where values must match the oracle."""
    f2 = _easy_part(f)
    # t1 = f2^(x-1) = conj(f2^(|x|+1))   [x < 0]
    t1 = tw.fp12_conj(tw.fp12_mul(_pow_abs_x(f2), f2))
    t2 = tw.fp12_conj(tw.fp12_mul(_pow_abs_x(t1), t1))  # ^(x-1) again
    # t3 = t2^(x+p) = conj(t2^|x|) * frob(t2)
    t3 = tw.fp12_mul(tw.fp12_conj(_pow_abs_x(t2)), tw.fp12_frobenius(t2))
    # t4 = t3^(x^2 + p^2 - 1) = t3^(|x|^2) * frob2(t3) * conj(t3)
    t4 = tw.fp12_mul(
        tw.fp12_mul(_pow_abs_x(_pow_abs_x(t3)), tw.fp12_frobenius2(t3)),
        tw.fp12_conj(t3),
    )
    # * f2^3
    return tw.fp12_mul(tw.fp12_mul(t4, tw.fp12_cyclotomic_square(f2)), f2)


# The exponent identity, exactly (host bigints, at import).
assert (X - 1) ** 2 * (X + P) * (X ** 2 + P ** 2 - 1) + 3 == 3 * _HARD_EXP


# ------------------------------------------------------------------ host APIs
_BATCH_BUCKETS = (8, 32, 128, 512, 2048)


def _bucket(n: int) -> int:
    for b in _BATCH_BUCKETS:
        if n <= b:
            return b
    return -(-n // _BATCH_BUCKETS[-1]) * _BATCH_BUCKETS[-1]


def _pad(pts, m):
    return list(pts) + [None] * (m - len(pts))


def _encode_g1(pts, device):
    """Affine G1 points (None = identity, encoded as (0, 1)) -> (x, y, valid)."""
    xs = [p[0] if p else 0 for p in pts]
    ys = [p[1] if p else 1 for p in pts]
    valid = np.asarray([p is not None for p in pts])
    return fp.encode(xs, device=device), fp.encode(ys, device=device), valid


def _encode_g2(pts, device):
    """Affine G2 points (None = identity, encoded as ((0,0), (1,0)))."""
    xs = [p[0] if p else (0, 0) for p in pts]
    ys = [p[1] if p else (1, 0) for p in pts]
    valid = np.asarray([p is not None for p in pts])
    return tw.fp2_encode(xs, device), tw.fp2_encode(ys, device), valid


def encode_pairs(g1_pts: Sequence, g2_pts: Sequence, m: int, device):
    """Pad both lists to m lanes and encode them: (px, py, qx, qy, mask),
    mask False where either point is the identity."""
    px, py, v1 = _encode_g1(_pad(g1_pts, m), device)
    qx, qy, v2 = _encode_g2(_pad(g2_pts, m), device)
    return px, py, qx, qy, torch.as_tensor(v1 & v2, device=px.device)


def pairing_batch(g1_pts: Sequence, g2_pts: Sequence, device="cuda:0"):
    """e(P_i, Q_i) for host affine point lists -> list of host Fp12 values."""
    n = len(g1_pts)
    ml = miller_loop_batch(*encode_pairs(g1_pts, g2_pts, _bucket(n), device))
    return tw.fp12_decode(final_exp_batch(ml))[:n]


def _fp12_batch_product(f):
    """Product of an (..., m) batch of Fp12 values along the trailing batch
    axis via a log-depth multiply tree -> batch (..., 1)."""
    m = f[0][0][0].shape[-1]
    while m > 1:
        h = m // 2
        lo = tw.tree_map(lambda x: x[..., :h], f)
        hi = tw.tree_map(lambda x: x[..., h : 2 * h], f)
        prod = tw.fp12_mul(lo, hi)
        if m % 2:
            prod = tw.tree_map(
                lambda a, b: torch.cat([a, b[..., 2 * h :]], dim=-1), prod, f
            )
        f = prod
        m = h + (m % 2)
    return f


def pairing_product_is_one(g1_pts: Sequence, g2_pts: Sequence, device="cuda:0") -> bool:
    """prod_i e(P_i, Q_i) == 1 on the device: ONE batched Miller loop, a
    log-depth Fp12 product tree, and ONE equality-preserving final
    exponentiation (the x-chain, final_exp_eq_batch).

    The device form of the verifier's pairing check (bellman's
    verifier.rs:49-56 rearranged as e(A,B) e(acc,-gamma) e(C,-delta)
    e(-alpha,beta) == 1, and verifier/batch.rs:164-168)."""
    n = len(g1_pts)
    ml = miller_loop_batch(*encode_pairs(g1_pts, g2_pts, _bucket(n), device))
    e = final_exp_eq_batch(_fp12_batch_product(ml))
    return bool(tw.fp12_is_one(e)[0])


def pairing_eq_batch(a1, b1, a2, b2, device="cuda:0") -> np.ndarray:
    """Vectorized check e(a1_i, b1_i) == e(a2_i, b2_i).

    Computed as fe(ml(a1,b1) * ml(-a2,b2)) == 1: ONE shared final
    exponentiation per equation instead of two full pairings."""
    n = len(a1)
    m = _bucket(n)
    ml1 = miller_loop_batch(*encode_pairs(a1, b1, m, device))
    ml2 = miller_loop_batch(*encode_pairs([G1.neg(p) for p in a2], b2, m, device))
    f = final_exp_eq_batch(tw.fp12_mul(ml1, ml2))
    return tw.fp12_is_one(f).cpu().numpy()[:n]
