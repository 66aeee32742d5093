"""Radix-2 NTT over group elements (curve points).

Port of bellman_mpc_tpu/ops/group_ntt.py.  The reference's EvaluationDomain
is generic over a `Group` trait with Scalar and Point instances
(bellman/src/domain.rs:192-259); a sound trusted-setup ceremony needs the
Point instance: turning the phase-1 power-basis points {tau^i G} into the
Lagrange-basis points {L_j(tau) G} is a group iFFT, the transform the
Groth16 generator performs on scalars (generator.rs:400-402), lifted to the
curve because nobody may know tau.

The butterflies are the scalar NTT's (ops/domain.ntt) with point add/sub
and a per-position twiddle scalar multiplication: each stage runs one
branchless double-and-add ladder at n/2 lanes.  The twiddle bit matrices
are host constants, built once per size and moved to each device once, so
a stage's ladder is as long as its longest twiddle.
"""

from __future__ import annotations

import functools

import torch

from ..curves.device import Point, point_add, scalar_mul_bits, scalars_to_bits
from ..fields.host import PrimeField
from .domain import _bitrev_indices


def point_neg(ops, p: Point) -> Point:
    return (p[0], ops.neg(p[1]), p[2])


def point_sub(ops, p: Point, q: Point) -> Point:
    return point_add(ops, p, point_neg(ops, q))


@functools.lru_cache(maxsize=None)
def _stage_twiddle_bits(host: PrimeField, exp: int, inverse: bool):
    """Twiddle bit matrices per stage on the CPU, (nbits_s, half_s) each,
    and the bits of 1/n as an (nbits, 1) matrix."""
    n = 1 << exp
    omega = host.nth_root_of_unity(exp)
    if inverse:
        omega = host.inv(omega)
    stages = []
    for s in range(1, exp + 1):
        half = 1 << (s - 1)
        step = n >> s
        tws = [pow(omega, step * j, host.p) for j in range(half)]
        stages.append(scalars_to_bits(tws, max(max(t.bit_length() for t in tws), 1)))
    n_inv = host.inv(n)
    return tuple(stages), scalars_to_bits([n_inv], n_inv.bit_length())


_BITS_DEV = {}


def _twiddle_bits(host: PrimeField, exp: int, inverse: bool, device):
    key = (id(host), exp, inverse, str(torch.device(device)))
    if key not in _BITS_DEV:
        stages, n_inv = _stage_twiddle_bits(host, exp, inverse)
        _BITS_DEV[key] = (tuple(b.to(device) for b in stages), n_inv.to(device))
    return _BITS_DEV[key]


def group_ntt(ops, host: PrimeField, p: Point, inverse: bool = False) -> Point:
    """NTT over the trailing axis of an (L, [2,] n) point tuple.  `inverse`
    applies omega^-1 twiddles and the final 1/n point scaling (ifft
    semantics)."""
    n = p[0].shape[-1]
    exp = n.bit_length() - 1
    assert 1 << exp == n
    if n == 1:
        return p
    dev = p[0].device
    rev = torch.as_tensor(_bitrev_indices(n), device=dev)
    p = tuple(torch.index_select(x, -1, rev) for x in p)
    tws, n_inv_bits = _twiddle_bits(host, exp, inverse, dev)
    for s in range(1, exp + 1):
        m = 1 << s
        half = m >> 1
        xr = tuple(x.reshape(tuple(x.shape[:-1]) + (n // m, m)) for x in p)
        u = tuple(x[..., :half] for x in xr)
        v = tuple(x[..., half:] for x in xr)
        bits = tws[s - 1]
        tv = scalar_mul_bits(ops, v, bits[:, None, :].expand(bits.shape[0], n // m, half))
        hi = point_add(ops, u, tv)
        lo = point_sub(ops, u, tv)
        p = tuple(torch.cat([a, b], dim=-1).reshape(tuple(a.shape[:-2]) + (n,))
                  for a, b in zip(hi, lo))
    if inverse:
        p = scalar_mul_bits(ops, p, n_inv_bits.expand(n_inv_bits.shape[0], n))
    return p
