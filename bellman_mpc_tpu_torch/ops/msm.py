"""Multi-scalar multiplication on limb tensors and RNS tables.

Port of bellman_mpc_tpu/ops/msm.py:

  * scalar digits (`digits_from_bits`, `signed_digits`);
  * the `rns` main path: affine window bucket tables (`shifted_bases`,
    `window_tables_affine`, `tables_to_rns`) and the window fold over padded
    RNS tables (`msm_table_affine_rns`, every window one fold-kernel launch,
    ops/fold_kernels.py), `pick_table_c`; its opt-ins: the GLV-2 / GLS-4
    table extensions (`phi_extend_affine_tables`,
    `psi_extend_affine_tables_g2`, ops/glv.py) and the segmented fold of
    several MSMs at once (`seg_sizes`);
  * the limb strategies: per-point ladders (`msm_ladder`), the bucket
    method (`msm_pippenger`, `msm_pippenger_batched`, which also runs
    stacked MSMs, each over its own bases), the flat bucket pass
    over pre-shifted bases (`msm_flat_pippenger`), and the gather MSMs over
    projective (`window_tables`, `msm_table`) or affine signed-digit tables
    (`msm_table_affine`);
  * fixed-base multiplication: the device ladder (`batch_mul_host`) and the
    comb (`fixed_base_tables`, `batch_mul_comb`, `batch_mul_comb_host`,
    taken under BMT_FIXED_BASE=comb);
  * the host-facing MSMs (`msm_host`, `msm_pippenger_host`, taken under
    BMT_MSM_STRATEGY=pippenger at 64 bases or more).

The bucket method's segmented scans run through `associative_scan`, the
odd/even recursion of jax.lax.associative_scan in plain tensor ops.  Point
operations are the lazy-column formulas of curves/device.py, so their limb
products are plain PyTorch; only LimbField.mul (the decodes, the table
build's batch inversion) launches the limb Montgomery kernel on the card.
"""

from __future__ import annotations

import os
from fractions import Fraction
from typing import List, Sequence

import numpy as np
import torch

from ..curves.device import (
    DeviceGroup,
    Point,
    point_add,
    point_add_mixed,
    point_double,
    point_identity,
    point_select,
    scalar_mul_bits,
    scalars_to_bits,
    tree_reduce,
)
from ..utils import profiling


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


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of `fn` over the trailing axis of a tuple of tensors,
    the odd/even recursion of jax.lax.associative_scan (depth 2 log n, about
    2n combines); `reverse` scans from the end (flip, scan, flip), as JAX
    does.  fn(a, b) combines two tuples lane by lane, a before b."""
    if reverse:
        out = _scan(fn, tuple(torch.flip(x, [-1]) for x in elems))
        return tuple(torch.flip(x, [-1]) for x in out)
    return _scan(fn, tuple(elems))


def _scan(fn, elems):
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    odd = _scan(fn, fn(tuple(x[..., 0:-1:2] for x in elems), tuple(x[..., 1::2] for x in elems)))
    if n > 2:
        left = odd if n % 2 else tuple(x[..., :-1] for x in odd)
        even = fn(left, tuple(x[..., 2::2] for x in elems))
    out = []
    for i, (x, o) in enumerate(zip(elems, odd)):
        t = torch.empty(tuple(o.shape[:-1]) + (n,), dtype=o.dtype, device=o.device)
        t[..., :1] = x[..., :1]
        t[..., 1::2] = o
        if n > 2:
            t[..., 2::2] = even[i]
        out.append(t)
    return tuple(out)


def _segmented_add(ops):
    """The bucket scans' combine: b where b starts a segment, else a + b;
    the start flags are or-ed."""

    def combine(a, b):
        s = point_add(ops, a[:3], b[:3])
        start = b[3]
        return tuple(torch.where(start, y, x) for x, y in zip(s, b[:3])) + (a[3] | start,)

    return combine


def _bucket_sums(ops, pts: Point, keys: torch.Tensor, n_keys: int) -> Point:
    """Bucket sums S_k over points sorted by key: a segmented scan, then the
    last lane of each key's run (scatter-max of the lane index); keys with
    no lane give the identity.  pts: (L, [2,] *S, M), keys: (*S, M) sorted
    along M.  Returns (L, [2,] *S, n_keys)."""
    M = keys.shape[-1]
    start = torch.ones_like(keys, dtype=torch.bool)
    start[..., 1:] = keys[..., 1:] != keys[..., :-1]
    sums = associative_scan(_segmented_add(ops), tuple(pts) + (start,))[:3]
    k = keys.to(torch.long)
    lane = torch.arange(M, device=k.device).expand(k.shape)
    shape = tuple(k.shape[:-1]) + (n_keys,)
    last = torch.zeros(shape, dtype=torch.long, device=k.device).scatter_reduce(-1, k, lane, "amax")
    present = torch.zeros(shape, dtype=torch.bool, device=k.device).scatter(-1, k, True)
    bucket = tuple(x.gather(-1, last.expand(tuple(x.shape[:-1]) + (n_keys,))) for x in sums)
    return point_select(ops, present, bucket, point_identity(ops, shape, k.device))


def _sub_first(ops, total: Point, first: Point) -> Point:
    """total - first (negation is free on short-Weierstrass points)."""
    return point_add(ops, total, (first[0], ops.neg(first[1]), first[2]))


# windows of the bucket method scanned together: at most this many lanes
_SCAN_LANES = 1 << 19


def msm_pippenger_batched(ops, points: Point, digits: torch.Tensor, c: int) -> Point:
    """Bucket-method MSM over a batch of scalar sets sharing one base set.

    points: coords (L, [2,] N); digits: (W, B, N) window digits (LSB window
    first) in [0, 2^c).  Per window, as the reference: a stable sort by
    digit, bucket sums by a segmented scan, sum_b b S_b by summation by
    parts (a reverse scan over the 2^c buckets, its tree sum, minus
    suffix_0); then the Horner fold over the windows with c doublings each.
    The window sums are independent, so the windows are scanned together
    (up to _SCAN_LANES lanes at a time) and only the fold is sequential.
    Returns (L, [2,] B, 1).

    Stacked (BMT_STACK_MSMS): digits (W, S, B, N) with points
    (L, [2,] S, N) run S MSMs, each over its own bases, as one; returns
    (L, [2,] S, B, 1)."""
    W, N = digits.shape[0], digits.shape[-1]
    batch = tuple(digits.shape[1:-1])
    nb = 1 << c
    dev = digits.device
    perm = torch.argsort(digits, dim=-1, stable=True)
    sdig = torch.gather(digits, -1, perm)
    if len(batch) == 2:  # stacked: lane (w, s, b, i) takes base perm[w, s, b, i] of set s
        s_idx = torch.arange(batch[0], device=dev).reshape(1, -1, 1, 1)
        take = lambda x, pw: x[..., s_idx, pw]
    else:
        take = lambda x, pw: x[..., pw]
    step = max(1, _SCAN_LANES // (int(np.prod(batch)) * N))
    parts = []
    for w0 in range(0, W, step):
        pw, dw = perm[w0:w0 + step], sdig[w0:w0 + step]
        bucket = _bucket_sums(ops, tuple(take(x, pw) for x in points), dw, nb)
        suffix = associative_scan(lambda a, b: point_add(ops, a, b), bucket, reverse=True)
        parts.append(_sub_first(ops, tree_reduce(ops, suffix), tuple(x[..., :1] for x in suffix)))
    w_axis = -(len(batch) + 2)
    sums = tuple(torch.cat([p[k] for p in parts], dim=w_axis) for k in range(3))  # (L, [2,] W, *batch, 1)
    res = point_identity(ops, batch + (1,), dev)
    for w in range(W - 1, -1, -1):  # MSB window first
        for _ in range(c):
            res = point_double(ops, res)
        res = point_add(ops, res, tuple(x.select(w_axis, w) for x in sums))
    return res


def msm_pippenger(ops, points: Point, digits: torch.Tensor, c: int) -> Point:
    """Bucket-method MSM of one scalar set: digits (W, N) -> (L, [2,] 1)."""
    out = msm_pippenger_batched(ops, points, digits[:, None], c)
    return tuple(x[..., 0, :] for x in out)


def msm_flat_pippenger(ops, sbases: Point, digits: torch.Tensor, c: int) -> Point:
    """Bucket-method MSM over pre-shifted bases: one sort, one segmented
    scan, one bucket fold, no doublings.

    sbases: coords (L, [2,] W*N) from `shifted_bases`; digits: (W, B, N).
    sum_i s_i P_i = sum_{w,i} d_{w,i} (2^(cw) P_i) is one small-scalar MSM
    over W*N points with bucket keys (w << c) | digit; the weighted fold is
    summation by parts per window, a segmented reverse scan whose segments
    start at each window's last bucket.  Returns (L, [2,] B, 1)."""
    W, B, N = digits.shape
    M = W * N
    nb = 1 << c
    n_keys = W * nb
    dev = digits.device
    keys = (torch.arange(W, dtype=digits.dtype, device=dev)[:, None, None] * nb + digits)
    keys = keys.permute(1, 0, 2).reshape(B, M)
    perm = torch.argsort(keys, dim=-1, stable=True)
    bucket = _bucket_sums(ops, tuple(x[..., perm] for x in sbases), torch.gather(keys, -1, perm), n_keys)
    wend = (torch.arange(n_keys, device=dev) % nb == nb - 1).expand(B, n_keys)
    suffix = associative_scan(_segmented_add(ops), tuple(bucket) + (wend,), reverse=True)[:3]
    s0 = tuple(x[..., ::nb] for x in suffix)  # each window's suffix_0: (L, [2,] B, W)
    Wp = _pad_pow2(W)
    if Wp != W:
        ident = point_identity(ops, (B, Wp - W), dev)
        s0 = tuple(torch.cat([x, i_], dim=-1) for x, i_ in zip(s0, ident))
    return _sub_first(ops, tree_reduce(ops, suffix), tree_reduce(ops, s0))


def window_tables(ops, points: Point, c: int, nbits: int = 255) -> Point:
    """Projective window bucket tables T[w, b, i] = b 2^(cw) P_i for the
    unsigned gather MSM, buckets 0..2^c-1 (bucket 0 the identity (0 : 1 :
    0)): coords (L, [2,] W, 2^c, N)."""
    W = -(-nbits // c)
    N = points[0].shape[-1]
    nb = 1 << c
    dev = points[0].device
    sb = tuple(x.reshape(tuple(x.shape[:-1]) + (W, N)) for x in shifted_bases(ops, points, c, nbits))
    table = [torch.zeros(tuple(x.shape[:-1]) + (W, nb, N), dtype=torch.int32, device=dev) for x in points]
    table[1][..., 0, :].copy_(ops.one((W, N), dev))
    running = point_identity(ops, (W, N), dev)
    for b in range(1, nb):
        running = point_add(ops, running, sb)
        for t, x in zip(table, running):
            t[..., b, :].copy_(x)
    return tuple(table)


def _pick(t: torch.Tensor, w: int, idx: torch.Tensor, n_idx: torch.Tensor) -> torch.Tensor:
    """Window w's bucket idx[b, i] of base i: (L, [2,] W, nb, N) -> (L, [2,] B, N)."""
    return t.select(-3, w)[..., idx, n_idx]


def msm_table(ops, tables: Point, digits: torch.Tensor) -> Point:
    """MSM from projective window tables: per window a gather and one
    complete addition at (B, N) lanes, then the tree reduction.

    tables: (L, [2,] W, 2^c, N) from `window_tables`; digits: (W, B, N).
    Returns (L, [2,] B, 1)."""
    W, B, N = digits.shape
    dev = digits.device
    idx = digits.to(torch.long)
    n_idx = torch.arange(N, device=dev)
    acc = point_identity(ops, (B, N), dev)
    for w in range(W):
        acc = point_add(ops, acc, tuple(_pick(t, w, idx[w], n_idx) for t in tables))
    return tree_reduce(ops, acc)


def msm_table_affine(ops, tables, sdigits: torch.Tensor) -> Point:
    """MSM from affine window tables and signed digits (the limb twin of
    msm_table_affine_rns): per window gather the |digit| bucket, negate y
    where the digit is negative, fold with one complete mixed addition, and
    keep the accumulator where the bucket is the (0, 0) identity sentinel.

    tables: (x, y) from `window_tables_affine`, coords (L, [2,] W, nb, N);
    sdigits: (W, B, N) from `signed_digits`.  Returns (L, [2,] B, 1)."""
    W, B, N = sdigits.shape
    dev = sdigits.device
    mag = torch.abs(sdigits).to(torch.long)
    sgn = sdigits < 0
    n_idx = torch.arange(N, device=dev)
    acc = point_identity(ops, (B, N), dev)
    for w in range(W):
        qx, qy = (_pick(t, w, mag[w], n_idx) for t in tables)
        inf = torch.logical_and(ops.is_zero(qx), ops.is_zero(qy))
        qy = ops.select(sgn[w], ops.neg(qy), qy)
        acc = point_select(ops, inf, acc, point_add_mixed(ops, acc, (qx, qy)))
    return tree_reduce(ops, acc)


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


def tables_in_lazy_range(lf, tables) -> bool:
    """True when every coordinate of the limb tables (coords (L, [2,] W,
    nb, N)) is below 2p, the bound `tables_to_rns` converts under (and with
    it the fold's table bound and K schedule); checked one window at a
    time."""
    w_axis = tables[0].dim() - 3
    for t in tables:
        for w in range(t.shape[w_axis]):
            _, borrow = lf._sub_flat(t.select(w_axis, w), lf._2p(t.device))
            if not bool(borrow.all()):
                return False
    return True


def msm_table_affine_rns(rops, lf, tables, sdigits: torch.Tensor, tab_bound, seg_sizes=None):
    """The RNS window fold over 80-row padded int16 tables (the reference's
    padded-table branches): per window, gather the |digit| bucket and fold
    it into the accumulator with ONE fold-kernel launch (K1 for G1, K2 for
    G2; the plain versions on the CPU).  Then the tree reduction and the
    bridge back to limb form (`_rns_fold_reduce`).

    tables: (80, [2,] W, nb, N) int16; sdigits: (W, B, N) signed digits.
    Returns a limb point (L, [2,] B, 1).  The accumulator is pinned to the
    fixpoint cap (128 p for G1, 256 p for G2), asserted by the bookkeeping.

    seg_sizes=(n_0, ..., n_{S-1}) runs S independent MSMs as one fold: the
    base axis holds S concatenated base sets (N = sum(n_s), each a power of
    two), the windows fold at the full (B, N) width, and the reduction sums
    within each segment only.  Returns (L, [2,] B, S)."""
    from ..curves import rns_point as rpt
    from .fold_kernels import G1_CAP, G2_CAP, PAD_C, rns_fold_window, rns_fold_window_g2, rns_pad_rows

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
    return _rns_fold_reduce(rops, lf, acc, cap, seg_sizes)


def _rns_fold_reduce(rops, lf, acc, cap, seg_sizes=None):
    """Tree (or segment) reduction of the folded accumulator, 3 padded
    (80, [2,] B, N) int32 tiles, and the bridge to limb form: one
    `rns_tree_level` per halving (one tree-kernel launch on the card), the
    tiles kept padded until the (B, S) sums are unpadded for the bridge;
    timed as the device span "msm.reduce" (utils/profiling.py).  With
    seg_sizes, consecutive equal-width segments share one tree over a
    (B, count, n_s) view."""
    from ..curves import rns_point as rpt
    from .fold_kernels import rns_tree_level, rns_unpad_rows

    f, g2 = rops.f, rops.fp2
    b = rops.b3c if g2 else rops.b3

    def tree(tiles):
        n = tiles[0].shape[-1]
        assert n & (n - 1) == 0, "the tree reduction halves a power of two"
        while tiles[0].shape[-1] > 1:
            tiles = rns_tree_level(f, b, tiles, cap, g2)
        return tiles

    with profiling.device_span("msm.reduce", acc[0].device, units=acc[0].shape[-2]):
        if seg_sizes is None:
            red = tree(acc)
        else:
            assert sum(seg_sizes) == acc[0].shape[-1]
            groups = []
            for n_s in seg_sizes:
                if groups and groups[-1][0] == n_s:
                    groups[-1][1] += 1
                else:
                    groups.append([n_s, 1])
            parts, off = [], 0
            for n_s, count in groups:
                chunk = tuple(t[..., off : off + n_s * count].reshape(tuple(t.shape[:-1]) + (count, n_s))
                              .contiguous() for t in acc)
                parts.append(tuple(t[..., 0] for t in tree(chunk)))  # (..., B, count)
                off += n_s * count
            red = tuple(torch.cat([p[k] for p in parts], dim=-1) for k in range(3))
        return rpt.rns_point_to_limb(rops, f, lf, tuple(rops.wrap(rns_unpad_rows(f, t), cap) for t in red))


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


def phi_extend_affine_tables(field, tables):
    """GLV base extension of affine limb G1 tables: (x, y) coords
    (L, W, nb, N) -> (L, W, nb, 2N), the second half phi(T[w, b, i]) =
    (beta x, y): phi is a group homomorphism, so the bucket table of the
    phi-mapped bases is the phi-map of the table (ops/glv.py).  One
    constant multiply (the limb Montgomery kernel on the card); the (0, 0)
    identity sentinel stays exactly zero (0 * beta is 0)."""
    from .glv import beta_g1

    x, y = tables
    x2 = field.mul_const(x, beta_g1())
    return torch.cat([x, x2], dim=-1), torch.cat([y, y], dim=-1)


def psi_extend_affine_tables_g2(field, tables):
    """GLS-4 base extension of affine limb G2 tables: coords
    (L, 2, W, nb, N) -> (L, 2, W, nb, 4N), block m holding psi^m(T[w, b, i]),
    psi(x, y) = (c_x conj(x), c_y conj(y)) with the conjugate folded into
    the constant products: c conj(a) = (c0 a0 + c1 a1) + (c1 a0 - c0 a1) u.
    The (0, 0) sentinel is re-imposed with an explicit mask (the field's
    sub does not keep an exact zero)."""
    from .glv import psi_constants

    x, y = tables
    inf = torch.all(x == 0, dim=1).all(dim=0) & torch.all(y == 0, dim=1).all(dim=0)

    def psi_coord(a, c):
        a0, a1 = a[:, 0], a[:, 1]
        c0, c1 = c
        n0 = field.add(field.mul_const(a0, c0), field.mul_const(a1, c1))
        n1 = field.sub(field.mul_const(a0, c1), field.mul_const(a1, c0))
        out = torch.stack([n0, n1], dim=1)
        return torch.where(inf[None, None], torch.zeros_like(out), out)

    cx, cy = psi_constants()
    xs, ys = [x], [y]
    for _ in range(3):
        xs.append(psi_coord(xs[-1], cx))
        ys.append(psi_coord(ys[-1], cy))
    return torch.cat(xs, dim=-1), torch.cat(ys, dim=-1)


def _window_digits(scalars: Sequence[int], c: int, device, nbits: int = 255) -> torch.Tensor:
    """Host ints -> (W, n) int32 base-2^c digits, LSB window first."""
    W = -(-nbits // c)
    mask = (1 << c) - 1
    digits = np.array([[(int(s) >> (w * c)) & mask for s in scalars] for w in range(W)], np.int32)
    return torch.from_numpy(digits.reshape(W, len(scalars))).to(device)


def fixed_base_tables(ops, base: Point, c: int, nbits: int = 255) -> Point:
    """Comb tables T[w, b] = b 2^(cw) base, coords (L, [2,] W, 2^c): the
    replacement for the reference's wNAF window tables (generator.rs:311-328).
    base: one point's coords (L, [2,]).  (W-1) c sequential doublings make
    the window bases, then 2^c - 1 sequential additions on W lanes fill the
    buckets (bucket 0 is the identity)."""
    W = -(-nbits // c)
    dev = base[0].device
    cur = tuple(x[..., None] for x in base)
    shifted = []
    for w in range(W):
        shifted.append(cur)
        if w < W - 1:
            for _ in range(c):
                cur = point_double(ops, cur)
    bases = tuple(torch.cat([p[k] for p in shifted], dim=-1) for k in range(3))  # (L, [2,] W)
    running = point_identity(ops, (W,), dev)
    cols = [running]
    for _ in range((1 << c) - 1):
        running = point_add(ops, running, bases)
        cols.append(running)
    return tuple(torch.stack([p[k] for p in cols], dim=-1) for k in range(3))


def batch_mul_comb(ops, table: Point, digits: torch.Tensor, c: int) -> Point:
    """Fixed-base multiplies from comb tables: digits (W, N) -> points
    (L, [2,] N), one gather of T[w, digit] and a log-depth add tree over the
    window axis (padded to a power of two with identities)."""
    W, N = digits.shape
    dev = digits.device
    w_idx = torch.arange(W, device=dev)[:, None]
    X, Y, Z = (x[..., w_idx, digits.to(torch.long)] for x in table)  # (L, [2,] W, N)
    Wp = _pad_pow2(W)
    if Wp != W:
        ident = point_identity(ops, (Wp - W, N), dev)
        X, Y, Z = (torch.cat([x, i_], dim=-2) for x, i_ in zip((X, Y, Z), ident))
    n = Wp
    while n > 1:
        half = n // 2
        X, Y, Z = point_add(ops, (X[..., :half, :], Y[..., :half, :], Z[..., :half, :]),
                            (X[..., half:, :], Y[..., half:, :], Z[..., half:, :]))
        n = half
    return (X[..., 0, :], Y[..., 0, :], Z[..., 0, :])


_COMB_C = 8


def batch_mul_comb_host(group: DeviceGroup, base, exps: Sequence[int], device) -> List:
    """[base * e for e in exps] through a comb table built on the device."""
    n = len(exps)
    if n == 0:
        return []
    sc = list(exps) + [0] * (_pad_pow2(n) - n)
    base_dev = tuple(x[..., 0] for x in group.encode_points([base], device))
    table = fixed_base_tables(group.ops, base_dev, _COMB_C)
    out = batch_mul_comb(group.ops, table, _window_digits(sc, _COMB_C, device), _COMB_C)
    return group.decode_points(out)[:n]


def batch_mul_host(group: DeviceGroup, base, exps: Sequence[int], device) -> List:
    """[base * e for e in exps] on the device: one branchless ladder over
    all exponents (padded to a power of two); BMT_FIXED_BASE=comb, read at
    call time, takes the comb table instead."""
    if os.environ.get("BMT_FIXED_BASE") == "comb":
        return batch_mul_comb_host(group, base, exps, device)
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


def msm_pippenger_host(group: DeviceGroup, bases: Sequence, scalars: Sequence[int], device,
                       c: int = 8):
    """Host-facing bucket-method MSM (padded to a power of two)."""
    n = len(bases)
    if n == 0:
        return None
    m = _pad_pow2(n)
    pts = group.encode_points(list(bases) + [None] * (m - n), device)
    digits = _window_digits(list(scalars) + [0] * (m - n), c, device)
    return group.decode_points(msm_pippenger(group.ops, pts, digits, c))[0]


def msm_host(group: DeviceGroup, bases: Sequence, scalars: Sequence[int], device):
    """Host-facing MSM: affine host points + int scalars -> host point, as
    one ladder over all bases on the device (padded to a power of two with
    identities); BMT_MSM_STRATEGY=pippenger, read at call time, takes the
    bucket method at 64 bases or more."""
    n = len(bases)
    if n == 0:
        return None
    if n >= 64 and os.environ.get("BMT_MSM_STRATEGY") == "pippenger":
        return msm_pippenger_host(group, bases, scalars, device, c=8)
    nbits = max(max(s.bit_length() for s in scalars), 1)
    m = _pad_pow2(n)
    pts = group.encode_points(list(bases) + [None] * (m - n), device)
    bits = scalars_to_bits(list(scalars) + [0] * (m - n), nbits, device)
    return group.decode_points(msm_ladder(group.ops, pts, bits))[0]
