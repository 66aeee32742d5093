"""Multi-scalar multiplication: the pieces of the `rns` main path.

Port of the subset of bellman_mpc_tpu/ops/msm.py that the batched prover's
`rns` strategy and setup run: scalar digits (`digits_from_bits`,
`signed_digits`), the affine window bucket tables (`shifted_bases`,
`window_tables_affine`, `tables_to_rns`), the window fold over padded RNS
tables (`msm_table_affine_rns`, whose every window goes through the fold
kernels of ops/fold_kernels.py), `pick_table_c`, and the device ladder
behind setup's fixed-base batches (`batch_mul_host`).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Sequence

import torch

from ..curves.device import (
    DeviceGroup,
    Point,
    point_add,
    point_double,
    point_identity,
    scalar_mul_bits,
    scalars_to_bits,
    tree_reduce,
)


def _pad_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def digits_from_bits(bits: torch.Tensor, c: int) -> torch.Tensor:
    """(NBITS, B, N) MSB-first bits -> (W, B, N) LSB-window-first digits."""
    nbits = bits.shape[0]
    W = -(-nbits // c)
    pad = W * c - nbits
    lsb_first = torch.flip(bits, dims=[0])
    if pad:
        lsb_first = torch.cat(
            [lsb_first, torch.zeros((pad,) + tuple(bits.shape[1:]), dtype=bits.dtype,
                                    device=bits.device)], dim=0)
    weights = (1 << torch.arange(c, dtype=torch.int32, device=bits.device)).reshape(
        (1, c) + (1,) * (bits.dim() - 1))
    return torch.sum(lsb_first.reshape((W, c) + tuple(bits.shape[1:])) * weights,
                     dim=1).to(torch.int32)


def signed_digits(digits: torch.Tensor, c: int) -> torch.Tensor:
    """(W, *S) unsigned base-2^c digits (LSB window first) -> (W+1, *S)
    signed digits in [-2^(c-1), 2^(c-1)-1] of the same value; a digit
    >= 2^(c-1) becomes digit - 2^c with a +1 carry into the next window."""
    half = 1 << (c - 1)
    full = 1 << c
    carry = torch.zeros_like(digits[0])
    out = []
    for w in range(digits.shape[0]):
        t = digits[w] + carry
        carry = (t >= half).to(digits.dtype)
        out.append(t - carry * full)
    out.append(carry)
    return torch.stack(out, dim=0)


def shifted_bases(ops, points: Point, c: int, nbits: int = 255) -> Point:
    """(L, [2,] N) bases -> (L, [2,] W*N) with block w holding 2^(c*w) * P_i."""
    W = -(-nbits // c)
    N = points[0].shape[-1]
    acc = tuple(torch.zeros(tuple(x.shape[:-1]) + (W, N), dtype=torch.int32, device=x.device)
                for x in points)
    cur = points
    for w in range(W):
        for a, x in zip(acc, cur):
            a[..., w, :] = x
        for _ in range(c):
            cur = point_double(ops, cur)
    return tuple(x.reshape(tuple(x.shape[:-2]) + (W * N,)) for x in acc)


def window_tables_affine(ops, points: Point, c: int, nbits: int = 255):
    """Affine window bucket tables for the signed-digit gather MSM:
    T[w, b, i] = b * 2^(c*w) * P_i as affine (x, y), coords
    (L, [2,] W, nb, N), the identity stored as (0, 0).  Bucket chain, then
    Montgomery batch inversion along the bucket axis (the reference's
    sequence of multiplies)."""
    W = -(-nbits // c) + 1
    nb = (1 << (c - 1)) + 1
    N = points[0].shape[-1]
    dev = points[0].device
    sb = shifted_bases(ops, points, c, W * c)
    sb = tuple(x.reshape(tuple(x.shape[:-1]) + (W, N)) for x in sb)

    table = [torch.zeros(tuple(x.shape[:-1]) + (nb, W, N), dtype=torch.int32, device=dev)
             for x in points]
    b_axis = table[0].dim() - 3
    table[1].select(b_axis, 0).copy_(ops.one((W, N), dev))
    running = point_identity(ops, (W, N), dev)
    for b in range(nb - 1):
        running = point_add(ops, running, sb)
        for t, x in zip(table, running):
            t.select(b_axis, b + 1).copy_(x)
    X, Y, Z = table
    del sb, running

    inf = ops.is_zero(Z)
    zero_wn = ops.zero((W, N), dev)
    one_wn = ops.one((W, N), dev)
    zs = ops.select(inf, ops.one(ops.batch_shape(Z), dev), Z)
    del Z, table

    prefix = torch.zeros_like(zs)
    running = one_wn
    for b in range(nb):
        prefix.select(b_axis, b).copy_(running)
        running = ops.mul(running, zs.select(b_axis, b))
    inv_run = ops.inv(running)

    xt = torch.zeros_like(X)
    yt = torch.zeros_like(Y)
    for i in range(nb):
        b = nb - 1 - i
        zinv_b, inv_next = ops.mul_many(
            [(inv_run, prefix.select(b_axis, b)), (inv_run, zs.select(b_axis, b))]
        )
        xb, yb = ops.mul_many([(X.select(b_axis, b), zinv_b), (Y.select(b_axis, b), zinv_b)])
        inf_b = inf.select(inf.dim() - 3, b)
        xt.select(b_axis, b).copy_(ops.select(inf_b, zero_wn, xb))
        yt.select(b_axis, b).copy_(ops.select(inf_b, zero_wn, yb))
        inv_run = inv_next
    # layout (L, [2,] W, nb, N)
    return tuple(torch.swapaxes(t, -3, -2).contiguous() for t in (xt, yt))


def tables_to_rns(rops, lf, tables):
    """Affine limb window tables -> RNS M-residue tables (int16), one window
    at a time.  Output: the limb axis replaced by the channel axis C, same
    layout otherwise; returns ((x_res, y_res), table_bound)."""
    from ..curves.rns_point import limb_coord_to_rns

    f = rops.f
    w_axis = tables[0].dim() - 3
    outs = []
    for t in tables:
        W = t.shape[w_axis]
        res = torch.empty((f.C,) + tuple(t.shape[1:]), dtype=torch.int16, device=t.device)
        for w in range(W):
            v = limb_coord_to_rns(f, lf, t.select(w_axis, w))
            res.select(w_axis, w).copy_(v.res.to(torch.int16))
        outs.append(res)
    bound = limb_coord_to_rns(f, lf, lf.zeros((1,), tables[0].device)).a
    return tuple(outs), bound


def msm_table_affine_rns(rops, lf, tables, sdigits: torch.Tensor, tab_bound):
    """The RNS window fold over 80-row padded int16 tables (the reference's
    padded-table branches): per window, gather the |digit| bucket and fold
    it into the accumulator with ONE fold-kernel launch (K1 for G1, K2 for
    G2; the plain versions on the CPU).  Then the tree reduction and the
    bridge back to limb form.

    tables: (80, [2,] W, nb, N) int16; sdigits: (W, B, N) signed digits.
    Returns a limb point (L, [2,] B, 1).  The accumulator is pinned to the
    fixpoint cap (128 p for G1, 256 p for G2), asserted by the bookkeeping."""
    from ..curves import rns_point as rpt
    from .fold_kernels import (
        G1_CAP,
        G2_CAP,
        PAD_C,
        rns_fold_window,
        rns_fold_window_g2,
        rns_pad_rows,
        rns_unpad_rows,
    )

    W, B, N = sdigits.shape
    xs, ys = tables
    assert xs.shape[0] == PAD_C, "the fold runs over padded tables"
    dev = xs.device
    cap = Fraction(G2_CAP if rops.fp2 else G1_CAP)
    mag = torch.abs(sdigits).to(torch.long)
    sgn = sdigits < 0
    n_idx = torch.arange(N, device=dev)
    acc = tuple(rns_pad_rows(rops.f, v.res) for v in rpt.point_identity(rops, (B, N), dev))
    for w in range(W):
        if rops.fp2:
            qx = xs[:, :, w][:, :, mag[w], n_idx].to(torch.int32)  # (80, 2, B, N)
            qy = ys[:, :, w][:, :, mag[w], n_idx].to(torch.int32)
            acc = rns_fold_window_g2(rops.f, rops.b3c, acc, (qx, qy), sgn[w], tab_bound, cap)
        else:
            qx = xs[:, w][:, mag[w], n_idx].to(torch.int32)  # (80, B, N)
            qy = ys[:, w][:, mag[w], n_idx].to(torch.int32)
            acc = rns_fold_window(rops.f, rops.b3, acc, (qx, qy), sgn[w], tab_bound, cap)
    accv = tuple(rops.wrap(rns_unpad_rows(rops.f, r), cap) for r in acc)
    return _rns_fold_reduce(rops, lf, accv, cap)


def _rns_fold_reduce(rops, lf, acc, cap):
    """Tree reduction of the folded accumulator + the bridge to limb form."""
    from ..curves import rns_point as rpt

    red = rpt.tree_reduce(rops, acc, cap)
    return rpt.rns_point_to_limb(rops, rops.f, lf, red)


def pick_table_c(n: int, g2: bool, budget_mb: int = 1536, nbits: int = 255) -> int:
    """Largest signed window width c whose affine table fits the budget
    (288 B per G1 point, 576 B per G2 point of the limb table)."""
    bytes_per = 576 if g2 else 288
    cap = 12 if n <= 4 else 8
    best = 4
    for c in range(4, cap + 1):
        W = -(-nbits // c) + 1
        nb = (1 << (c - 1)) + 1
        if W * nb * n * bytes_per <= budget_mb * (1 << 20):
            best = c
    return best


def batch_mul_host(group: DeviceGroup, base, exps: Sequence[int], device) -> List:
    """[base * e for e in exps] on the device: one branchless ladder over
    all exponents (padded to a power of two)."""
    n = len(exps)
    if n == 0:
        return []
    nbits = max(max(e.bit_length() for e in exps), 1)
    m = _pad_pow2(n)
    sc = list(exps) + [0] * (m - n)
    B = group.encode_points([base], device)
    bits = scalars_to_bits(sc, nbits, device)
    out = scalar_mul_bits(group.ops, B, bits)
    return group.decode_points(out)[:n]


def msm_ladder(ops, points: Point, bits: torch.Tensor) -> Point:
    """Per-point ladders + tree reduction. bits: (nbits, N), N a power of 2."""
    return tree_reduce(ops, scalar_mul_bits(ops, points, bits))


def msm_host(group: DeviceGroup, bases: Sequence, scalars: Sequence[int], device):
    """Host-facing MSM: affine host points + int scalars -> host point, as
    one ladder over all bases on the device (padded to a power of two with
    identities)."""
    n = len(bases)
    if n == 0:
        return None
    nbits = max(max(s.bit_length() for s in scalars), 1)
    m = _pad_pow2(n)
    pts = group.encode_points(list(bases) + [None] * (m - n), device)
    bits = scalars_to_bits(list(scalars) + [0] * (m - n), nbits, device)
    return group.decode_points(msm_ladder(group.ops, pts, bits))[0]
