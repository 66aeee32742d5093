"""GLV/GLS scalar decomposition for the BLS12-381 MSMs.

Port of bellman_mpc_tpu/ops/glv.py.  Endomorphism decompositions shrink
the scalar bit-length, and with it the number of sequential fold windows,
at the price of more base lanes:

  * G1 (GLV-2): phi(x, y) = (beta*x, y) with eigenvalue
    lam = z^2 - 1 (lam^2 + lam + 1 == 0 mod r).  k = k1 + k2*lam with
    |k1|, |k2| < 2^128: windows 33 -> 18 at c=8, bases N -> 2N.
  * G2 (GLS-4): psi = untwist-Frobenius-twist with eigenvalue z
    (psi^4 - psi^2 + 1 == 0 on G2).  k = k0 + k1 z + k2 z^2 + k3 z^3:
    windows 33 -> 10 at c=8, bases N -> 4N.

phi and psi are group homomorphisms, so the window bucket tables of the
extended base sets are coordinate maps of the original tables
(ops/msm.phi_extend_affine_tables, psi_extend_affine_tables_g2).

The host half is pure Python on ints, the reference's digit for digit
(including its dead v2 correction: c2 of `decompose_glv2` is always 0).
The device half works on (D, *B) int32 tensors of 11-bit digits on the
scalars' device.  Its constant products are float64 matrix products (every
column is below n_in * 2^22 < 2^27, exact in a double; there is no integer
matrix product on CUDA), and its carry normalization is a loop over the
digit axis, as the reference's lax.scan: a few tensor ops per digit.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..fields import bls12_381 as bc

P, R, Z = bc.P, bc.R, bc.X  # base-field mod, scalar-field mod, BLS parameter

Z2 = Z * Z
LAMBDA = (Z2 - 1) % R  # phi eigenvalue on G1
assert (LAMBDA * LAMBDA + LAMBDA + 1) % R == 0

# Barrett shift of the floor-variant rounding (46 * 11: digit-aligned, so
# the device decomposition uses the same constants)
GLV_S = 506
MU1 = (1 << GLV_S) * Z2 // R
MU2 = (1 << GLV_S) // R

# |k1|, |k2| < 2^128 for the floor variant; the signed-digit recode adds its
# own top window
GLV_BITS = 128


def decompose_glv2(k: int) -> Tuple[int, int]:
    """k (mod r) -> (k1, k2) signed, k == k1 + k2*LAMBDA (mod r),
    |ki| < 2^128: floor-Barrett Babai rounding on the lattice basis
    v1 = (z^2-1, -1), v2 = (1, z^2), the device decomposition's constants."""
    k %= R
    c1 = (k * MU1) >> GLV_S
    c2 = (k * MU2) >> GLV_S
    k1 = k - c1 * (Z2 - 1) - c2
    k2 = c1 - c2 * Z2
    return k1, k2


# ------------------------------------------------------------------- G2 GLS-4
# psi's eigenvalue on the r-torsion is p == z (mod r); z^4 - z^2 + 1 = r.
assert (Z ** 4 - Z ** 2 + 1) == R
ABS_Z = -Z  # z < 0 for BLS12-381

# Babai basis of the rank-4 lattice {(a,b,c,d): a + bz + cz^2 + dz^3 == 0
# mod r}: rows v1..v4
_GLS_BASIS = np.array(
    [
        [Z, -1, 0, 0],
        [0, Z, -1, 0],
        [0, 0, Z, -1],
        [1, 0, -1, Z],
    ],
    dtype=object,
)


def _adjugate4(M):
    """The adjugate of a 4x4 integer matrix, exactly (bigints)."""
    n = 4
    C = [[0] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            rows = [r_ for r_ in range(n) if r_ != i]
            cols = [c_ for c_ in range(n) if c_ != j]
            m = [[M[r_][c_] for c_ in cols] for r_ in rows]
            det3 = (
                m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
                - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
                + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0])
            )
            C[i][j] = (-1) ** (i + j) * det3
    return [[C[j][i] for j in range(n)] for i in range(n)]  # adj = C^T


_GLS_ADJ = _adjugate4([[int(x) for x in row] for row in _GLS_BASIS])
_GLS_DET = (
    _GLS_BASIS[0][0] * _GLS_ADJ[0][0]
    + _GLS_BASIS[0][1] * _GLS_ADJ[1][0]
    + _GLS_BASIS[0][2] * _GLS_ADJ[2][0]
    + _GLS_BASIS[0][3] * _GLS_ADJ[3][0]
)
assert abs(int(_GLS_DET)) == R, "GLS lattice determinant must be +-r"

GLS_BITS = 67  # |ki| < 2^67 for the host round variant


def decompose_gls4(k: int) -> Tuple[int, int, int, int]:
    """k (mod r) -> (k0, k1, k2, k3) signed with
    k == k0 + k1*z + k2*z^2 + k3*z^3 (mod r) and |ki| < 2^GLS_BITS
    (round-to-nearest Babai; the device variant floors)."""
    k %= R
    det = int(_GLS_DET)
    # target vector (k, 0, 0, 0); c = round((k,0,0,0) @ B^{-1})
    cs = []
    for j in range(4):
        num = k * _GLS_ADJ[0][j]
        if det < 0:
            num, d = -num, -det
        else:
            d = det
        cs.append((num + (d // 2)) // d)
    out = [k, 0, 0, 0]
    for j in range(4):
        for t in range(4):
            out[t] -= cs[j] * int(_GLS_BASIS[j][t])
    return tuple(out)


def gls4_eigen_check(k: int) -> bool:
    k0, k1, k2, k3 = decompose_gls4(k)
    return (k0 + k1 * Z + k2 * Z * Z + k3 * Z ** 3 - k) % R == 0


# -------------------------------------------------------- endomorphism consts
@functools.lru_cache(maxsize=None)
def beta_g1() -> int:
    """Cube root of unity in Fp with (beta*x, y) == [LAMBDA](x, y) on G1."""
    from ..curves import host as chost

    g = chost.G1.generator
    target = chost.G1.mul(g, LAMBDA)
    for base in range(2, 12):
        b = pow(base, (P - 1) // 3, P)
        if b == 1:
            continue
        for cand in (b, b * b % P):
            if chost.G1.eq((cand * g[0] % P, g[1]), target):
                return cand
    raise AssertionError("no beta matches lambda")


@functools.lru_cache(maxsize=None)
def psi_constants() -> Tuple[tuple, tuple]:
    """(c_x, c_y) in Fp2 with psi(x, y) = (c_x * conj(x), c_y * conj(y)) on
    the twist y^2 = x^3 + 4 xi, xi = 1 + u: c_x = 1 / xi^((p-1)/3),
    c_y = 1 / xi^((p-1)/2); conj is the Fp2 Frobenius."""
    from ..fields import tower as ht

    xi = (1, 1)
    cx = ht.fp2_inv(ht.fp2_pow(xi, (P - 1) // 3))
    cy = ht.fp2_inv(ht.fp2_pow(xi, (P - 1) // 2))
    return cx, cy


def psi_host(pt):
    """psi on a host affine G2 point ((x0,x1),(y0,y1)) (None passes)."""
    if pt is None:
        return None
    from ..fields import tower as ht

    cx, cy = psi_constants()
    (x, y) = pt
    xbar = (x[0], P - x[1] if x[1] else 0)
    ybar = (y[0], P - y[1] if y[1] else 0)
    return (ht.fp2_mul(cx, xbar), ht.fp2_mul(cy, ybar))


def phi_host(pt):
    """phi on a host affine G1 point (x, y) (None passes)."""
    if pt is None:
        return None
    b = beta_g1()
    return (b * pt[0] % P, pt[1])


# ----------------------------------------------------- device decomposition
# The h-query scalars come from the device's h(x) pipeline, so the split
# runs on the device too: exact integer digit arithmetic on the 11-bit limb
# tensors of the scalar field.

GLV_NBITS = 130  # magnitude bits fed to the window digitizer (|ki| < 2^128)
_DIGIT_BITS = 11
_DIGIT_MASK = (1 << _DIGIT_BITS) - 1
_S_DIG = GLV_S // _DIGIT_BITS  # 46 (GLV_S is digit-aligned)
_MAG_DIGS = 13  # 13 * 11 = 143 bits >= GLV_NBITS
_OFF_DIG = _MAG_DIGS  # OFF = 2^(11*13) = 2^143 > 2^129 >= |ki| + slack


def _const_digits(c: int) -> List[int]:
    out = []
    while c:
        out.append(c & _DIGIT_MASK)
        c >>= _DIGIT_BITS
    return out or [0]


@functools.lru_cache(maxsize=None)
def _digit_mul_matrix(const: int, n_in: int):
    """(n_out, n_in) W with W[i+j, i] = digit_j(const), as numpy float64:
    cols = W @ k are the (unnormalized) product columns of k * const, each
    below n_in * 2^22 < 2^27, so the float64 product is exact."""
    digs = _const_digits(const)
    n_out = n_in + len(digs)
    W = np.zeros((n_out, n_in), np.float64)
    for i in range(n_in):
        for j, dv in enumerate(digs):
            W[i + j, i] = dv
    return W, n_out


_W_DEV = {}


def _mul_const_digits(digits: torch.Tensor, const: int) -> torch.Tensor:
    """(D, *B) canonical digits -> (D + len(const digits), *B) int32 product
    columns of value * const (one float64 matrix product)."""
    n_in = digits.shape[0]
    W, n_out = _digit_mul_matrix(const, n_in)
    key = (const, n_in, str(digits.device))
    w = _W_DEV.get(key)
    if w is None:
        w = torch.from_numpy(W).to(digits.device)
        _W_DEV[key] = w
    flat = digits.reshape(n_in, -1).to(torch.float64)
    cols = torch.matmul(w, flat).to(torch.int32)
    return cols.reshape((n_out,) + tuple(digits.shape[1:]))


def _normalize_digits(cols: torch.Tensor) -> torch.Tensor:
    """Exact carry normalization of signed int32 columns to canonical 11-bit
    digits, one digit at a time (arithmetic >> floors, so negative columns
    borrow).  The represented value must be non-negative and fit the column
    count."""
    carry = torch.zeros_like(cols[0])
    out = torch.empty_like(cols)
    for i in range(cols.shape[0]):
        v = cols[i] + carry
        carry = v >> _DIGIT_BITS
        out[i] = v & _DIGIT_MASK
    return out


def _pad_digits(d: torch.Tensor, n: int) -> torch.Tensor:
    if d.shape[0] >= n:
        return d[:n]
    return torch.cat([d, torch.zeros((n - d.shape[0],) + tuple(d.shape[1:]), dtype=d.dtype,
                                     device=d.device)], dim=0)


def _split_off(kd: torch.Tensor, off_dig: int, mag_digs: int):
    """Digits of OFF + k (OFF = 2^(11 off_dig)) -> (k < 0, digits of |k|)."""
    pos = kd[off_dig] == 1  # OFF survived => value >= OFF => k >= 0
    negcols = -kd
    negcols[off_dig] += 1
    mag_neg = _normalize_digits(negcols)[:mag_digs]
    return torch.logical_not(pos), torch.where(pos[None], kd[:mag_digs], mag_neg)


def decompose_glv2_device(std_digits: torch.Tensor):
    """(L, *B) canonical 11-bit digits of k (< r, standard form) ->
    (neg1, mag1, neg2, mag2): neg* bool (*B); mag* (13, *B) digits of |ki|,
    the host `decompose_glv2`'s values."""
    batch = tuple(std_digits.shape[1:])

    # c1 = (k * MU1) >> 506 ; c2 = (k * MU2) >> 506 (c2 in {0, 1})
    d1 = _normalize_digits(_mul_const_digits(std_digits, MU1))
    c1 = d1[_S_DIG : _S_DIG + _MAG_DIGS]  # (13, *B)
    d2 = _normalize_digits(_mul_const_digits(std_digits, MU2))
    c2 = d2[_S_DIG]  # (*B) in {0, 1}

    # t = c1 * (Z2 - 1) + c2 ; k1 = k - t  (signed, |k1| < 2^128)
    t_cols = _mul_const_digits(c1, Z2 - 1)
    t_cols[0] += c2
    n_d = max(std_digits.shape[0], t_cols.shape[0]) + 2
    acc = _pad_digits(std_digits, n_d) - _pad_digits(t_cols, n_d)
    acc[_OFF_DIG] += 1  # + OFF = 2^143
    k1d = _normalize_digits(acc)  # value = OFF + k1

    # k2 = c1 - c2 * Z2
    z2d = torch.tensor(_const_digits(Z2), dtype=torch.int32, device=std_digits.device)
    t2 = c2[None] * z2d.reshape((z2d.shape[0],) + (1,) * len(batch))
    acc2 = _pad_digits(c1, n_d) - _pad_digits(t2, n_d)
    acc2[_OFF_DIG] += 1
    k2d = _normalize_digits(acc2)

    neg1, mag1 = _split_off(k1d, _OFF_DIG, _MAG_DIGS)
    neg2, mag2 = _split_off(k2d, _OFF_DIG, _MAG_DIGS)
    return neg1, mag1, neg2, mag2


def digits_to_bits_msb(mag: torch.Tensor, nbits: int = GLV_NBITS) -> torch.Tensor:
    """(D, *B) 11-bit digits -> (nbits, *B) bits, MSB first."""
    shifts = torch.arange(_DIGIT_BITS, dtype=torch.int32, device=mag.device).reshape(
        (1, _DIGIT_BITS) + (1,) * (mag.dim() - 1))
    bits = (mag[:, None] >> shifts) & 1
    flat = bits.reshape((mag.shape[0] * _DIGIT_BITS,) + tuple(mag.shape[1:]))
    return torch.flip(flat[:nbits], dims=[0])


# ------------------------------------------------------- GLS-4 device (G2)
GLS_NBITS = 66  # |ki| < 2^64 for the floor variant
_GLS_MAG_DIGS = 7  # 7 * 11 = 77 bits
_GLS_OFF_DIG = _GLS_MAG_DIGS  # OFF = 2^77 > 2^64 + slack

# floor-Barrett constants: c_j = sgn_j * ((k * MU_j) >> GLV_S)
_GLS_MUS = tuple(((1 << GLV_S) * abs(int(_GLS_ADJ[0][j]))) // R for j in range(4))
_GLS_SGN = tuple(1 if int(_GLS_ADJ[0][j]) >= 0 else -1 for j in range(4))
# c_j magnitude digit counts: |c_j| <= k * |adj0_j| / r < 2^(|adj0_j| bits)
_GLS_C_DIGS = tuple(
    -(-(abs(int(_GLS_ADJ[0][j])).bit_length() + 1) // _DIGIT_BITS) for j in range(4)
)


def decompose_gls4_device(std_digits: torch.Tensor):
    """(L, *B) canonical digits of k (< r) -> (neg, mag): neg bool (4, *B);
    mag (4, 7, *B) digits of |ki| with k == sum_j ki * z^j (mod r),
    |ki| < 2^64 (floor-Barrett Babai on the quartic psi-lattice)."""
    basis = [[int(x) for x in row] for row in _GLS_BASIS]

    cs = []  # per j: c_j >= 0 digits (its sign applied below), or None
    for j in range(4):
        if _GLS_MUS[j] == 0:
            cs.append(None)
            continue
        d = _normalize_digits(_mul_const_digits(std_digits, _GLS_MUS[j]))
        cs.append(d[_S_DIG : _S_DIG + _GLS_C_DIGS[j]])

    n_d = std_digits.shape[0] + max(_GLS_C_DIGS) + 8
    negs, mags = [], []
    for t in range(4):
        acc = _pad_digits(std_digits if t == 0 else torch.zeros_like(std_digits), n_d)
        for j in range(4):
            b_jt = basis[j][t]
            if b_jt == 0 or cs[j] is None:
                continue
            # out_t -= c_j * b_jt  with c_j = sgn_j * cs[j]
            term = _mul_const_digits(cs[j], abs(b_jt))
            sign = -_GLS_SGN[j] * (1 if b_jt >= 0 else -1)
            acc = acc + sign * _pad_digits(term, n_d)
        acc[_GLS_OFF_DIG] += 1  # + OFF = 2^77
        neg, mag = _split_off(_normalize_digits(acc), _GLS_OFF_DIG, _GLS_MAG_DIGS)
        negs.append(neg)
        mags.append(mag)
    return torch.stack(negs, dim=0), torch.stack(mags, dim=0)
