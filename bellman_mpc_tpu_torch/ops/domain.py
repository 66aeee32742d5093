"""Polynomial evaluation domains with a radix-2 NTT on limb tensors.

Port of bellman_mpc_tpu/ops/domain.py: an iterative Cooley–Tukey network as
reshape + batched Montgomery multiply over ``(L, *batch, n)`` limb tensors
(the transform runs over the trailing axis; leading batch axes stand in for
the reference's vmap), plus `EvaluationDomain` with the reference's methods.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..fields.host import PrimeField
from ..fields.limb import LimbField
from ..r1cs.core import PolynomialDegreeTooLarge


def domain_size_for(n_coeffs: int, host_field: PrimeField) -> Tuple[int, int]:
    """(m, exp) of the smallest 2^exp >= n_coeffs; errors past two-adicity."""
    m, exp = 1, 0
    while m < n_coeffs:
        m *= 2
        exp += 1
        if exp >= host_field.S:
            raise PolynomialDegreeTooLarge(
                f"domain 2^{exp} exceeds field two-adicity {host_field.S}"
            )
    return m, exp


def _bitrev_indices(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for _ in range(k):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev


@functools.lru_cache(maxsize=None)
def _stage_twiddles_host(field: LimbField, host: PrimeField, exp: int, inverse: bool):
    """Per-stage twiddle tables (Montgomery limbs, CPU), cached per size."""
    n = 1 << exp
    omega = host.nth_root_of_unity(exp)
    if inverse:
        omega = host.inv(omega)
    tws = []
    for s in range(1, exp + 1):
        half = 1 << (s - 1)
        step = n >> s
        tws.append(field.encode([pow(omega, step * j, host.p) for j in range(half)]))
    return tuple(tws)


_TW_DEV = {}


def _stage_twiddles(field, host, exp, inverse, device):
    key = (id(field), id(host), exp, inverse, str(torch.device(device)))
    if key not in _TW_DEV:
        _TW_DEV[key] = tuple(t.to(device) for t in _stage_twiddles_host(field, host, exp, inverse))
    return _TW_DEV[key]


def ntt(field: LimbField, host: PrimeField, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order radix-2 NTT over the trailing axis of an (L, *batch, n) limb
    tensor; `inverse` applies omega^-1 and the final 1/n (ifft semantics)."""
    n = x.shape[-1]
    lead = tuple(x.shape[:-1])
    exp = n.bit_length() - 1
    assert 1 << exp == n
    if n == 1:
        return x
    rev = torch.as_tensor(_bitrev_indices(n), device=x.device)
    x = x[..., rev]
    tws = _stage_twiddles(field, host, exp, inverse, x.device)
    bshape = (1,) * (len(lead) - 1)
    for s in range(1, exp + 1):
        m = 1 << s
        half = m >> 1
        xr = x.reshape(lead + (n // m, m))
        u = xr[..., :half]
        tw = tws[s - 1].reshape((field.L,) + bshape + (1, half))
        v = field.mul(xr[..., half:], tw)
        x = torch.cat([field.add(u, v), field.sub(u, v)], dim=-1).reshape(lead + (n,))
    if inverse:
        x = field.mul_const(x, host.inv(n))
    return x


def distribute_powers(field: LimbField, host: PrimeField, x: torch.Tensor, g: int) -> torch.Tensor:
    """coeff_i *= g^i, with the power table built by length doubling (log n
    multiplies, the reference's sequence)."""
    n = x.shape[-1]
    pows = field.mont_one((1,), x.device)
    g_pow = field.const(g, (1,), device=x.device)
    while pows.shape[1] < n:
        pows = torch.cat([pows, field.mul(pows, g_pow)], dim=1)
        g_pow = field.square(g_pow)
    p = pows[:, :n].reshape((field.L,) + (1,) * (x.dim() - 2) + (n,))
    return field.mul(x, p)


def warm_twiddles(field: LimbField, host: PrimeField, exp: int) -> None:
    """Build the host twiddle caches ahead of the first transform."""
    if exp >= 1:
        _stage_twiddles_host(field, host, exp, False)
        _stage_twiddles_host(field, host, exp, True)


class EvaluationDomain:
    """Host orchestrator mirroring the reference EvaluationDomain API:
    device coefficients (Montgomery limbs, transform over the trailing
    axis) plus host constants.  Every multiply is LimbField.mul, the limb
    Montgomery kernel on the card."""

    def __init__(self, field: LimbField, host: PrimeField, coeffs: torch.Tensor, exp: int):
        self.field = field
        self.host = host
        self.coeffs = coeffs
        self.exp = exp

    @classmethod
    def from_coeffs(cls, field: LimbField, host: PrimeField, values: List[int],
                    device) -> "EvaluationDomain":
        """Host ints padded with zeros to 2^exp, encoded on `device`."""
        m, exp = domain_size_for(len(values), host)
        padded = list(values) + [0] * (m - len(values))
        return cls(field, host, field.encode(padded, device=device), exp)

    @classmethod
    def from_device(cls, field: LimbField, host: PrimeField, arr: torch.Tensor) -> "EvaluationDomain":
        """Montgomery limbs (L, *batch, n), zero-padded to 2^exp on their device."""
        n = arr.shape[-1]
        m, exp = domain_size_for(n, host)
        if m != n:
            pad = field.zeros(tuple(arr.shape[1:-1]) + (m - n,), arr.device)
            arr = torch.cat([arr, pad], dim=-1)
        return cls(field, host, arr, exp)

    def __len__(self) -> int:
        return self.coeffs.shape[-1]

    def into_coeffs(self) -> List[int]:
        return self.field.decode(self.coeffs)

    def fft(self) -> None:
        self.coeffs = ntt(self.field, self.host, self.coeffs, inverse=False)

    def ifft(self) -> None:
        self.coeffs = ntt(self.field, self.host, self.coeffs, inverse=True)

    def distribute_powers(self, g: int) -> None:
        self.coeffs = distribute_powers(self.field, self.host, self.coeffs, g % self.host.p)

    def coset_fft(self) -> None:
        self.distribute_powers(self.host.generator)
        self.fft()

    def icoset_fft(self) -> None:
        self.ifft()
        self.distribute_powers(self.host.inv(self.host.generator))

    def z(self, tau: int) -> int:
        """The vanishing polynomial tau^m - 1 on the host."""
        return (pow(tau, len(self), self.host.p) - 1) % self.host.p

    def divide_by_z_on_coset(self) -> None:
        zinv = self.host.inv(self.z(self.host.generator))
        self.coeffs = self.field.mul_const(self.coeffs, zinv)

    def mul_assign(self, other: "EvaluationDomain") -> None:
        assert len(self) == len(other)
        self.coeffs = self.field.mul(self.coeffs, other.coeffs)

    def sub_assign(self, other: "EvaluationDomain") -> None:
        assert len(self) == len(other)
        self.coeffs = self.field.sub(self.coeffs, other.coeffs)
