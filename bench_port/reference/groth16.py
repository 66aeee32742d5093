"""The plain Groth16 check of the window's proofs.

From the seeded toxic waste (alpha, beta, gamma, delta, tau) and the
benchmark's own copy of the circuit (`circuits/`), the reference works out
the verifying key's scalars again: each public input i has
k_i = beta u_i(tau) + alpha v_i(tau) + w_i(tau), where u_i, v_i, w_i are
the input's columns of A, B, C over the Lagrange basis of the radix-2
domain (the input dummy constraints x_i * 0 = 0 appended, as bellman's
generator does).  With vk = (alpha g1, beta g2, gamma g2, delta g2,
IC_i = (k_i / gamma) g1), Groth16's equation

    e(A, B) = e(alpha g1, beta g2) e(sum_i x_i IC_i, gamma g2) e(C, delta g2)

reads, by bilinearity, e(A, B) = e(D, g2) with
D = (alpha beta + sum_i x_i k_i) g1 + delta C.  A group of proofs is
checked at once with random 64-bit weights rho_j drawn from the seed:
prod_j e(rho_j A_j, B_j) e(-sum_j rho_j D_j, g2) = 1; a group that fails
is checked proof by proof, so each proof gets its own verdict.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

from . import bls12_381 as bls
from .circuits.core import AUX, INPUT, ConstraintSystem, Variable
from .circuits.field import PrimeField

FR = PrimeField(bls.R, name="Fr")
FR_TWO_ADICITY = 32
FR_ROOT_OF_UNITY = pow(7, (bls.R - 1) >> FR_TWO_ADICITY, bls.R)  # 7 generates Fr*


class InputColumns(ConstraintSystem):
    """Synthesizes a circuit, keeping of each constraint only the terms of
    public inputs (ONE is input 0) in A, B and C."""

    def __init__(self):
        super().__init__(FR)
        self.num_inputs = 1  # ONE
        self.num_aux = 0
        self.num_constraints = 0
        self.cols: Tuple[Dict[int, Dict[int, int]], ...] = ({}, {}, {})  # A, B, C: input -> {j: coeff}

    def alloc(self, annotation, f) -> Variable:
        self.num_aux += 1
        return Variable(AUX, self.num_aux - 1)

    def alloc_input(self, annotation, f) -> Variable:
        self.num_inputs += 1
        return Variable(INPUT, self.num_inputs - 1)

    def enforce(self, annotation, a, b, c) -> None:
        j = self.num_constraints
        for col, fn in zip(self.cols, (a, b, c)):
            for var, coeff in fn(self.lc()).terms:
                if var.kind == INPUT:
                    row = col.setdefault(var.index, {})
                    row[j] = (row.get(j, 0) + coeff) % bls.R
        self.num_constraints += 1

    def push_namespace(self, name: str) -> None:
        pass

    def pop_namespace(self) -> None:
        pass

    def finish(self) -> None:
        """The generator's dummy constraint x_i * 0 = 0 for every input."""
        for i in range(self.num_inputs):
            self.cols[0].setdefault(i, {})[self.num_constraints] = 1
            self.num_constraints += 1


def domain_exp(n: int) -> int:
    exp = max(n - 1, 0).bit_length()
    if exp > FR_TWO_ADICITY:
        raise ValueError(f"{n} constraints exceed the 2^{FR_TWO_ADICITY} domain")
    return exp


def lagrange_at(tau: int, exp: int, points: Sequence[int]) -> Dict[int, int]:
    """L_j(tau) over the domain {omega^j} of size m = 2^exp, for each j in
    points: (tau^m - 1) / m * omega^j / (tau - omega^j)."""
    r = bls.R
    m = 1 << exp
    omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - exp), r)
    z = (pow(tau, m, r) - 1) * pow(m, -1, r) % r
    if z == 0:
        raise ValueError("tau lies in the evaluation domain")
    out = {}
    for j in points:
        wj = pow(omega, j, r)
        out[j] = z * wj % r * pow((tau - wj) % r, -1, r) % r
    return out


def input_scalars(circuit, toxic: Dict[str, int]) -> List[int]:
    """k_i for every public input of `circuit` (a frozen-copy circuit),
    ONE first."""
    cs = InputColumns()
    circuit.synthesize(cs)
    cs.finish()
    exp = domain_exp(cs.num_constraints)
    points = sorted({j for col in cs.cols for row in col.values() for j in row})
    lag = lagrange_at(toxic["tau"], exp, points)
    r = bls.R

    def at_tau(col, i):
        return sum(c * lag[j] for j, c in col.get(i, {}).items()) % r

    a, b = toxic["alpha"], toxic["beta"]
    return [(b * at_tau(cs.cols[0], i) + a * at_tau(cs.cols[1], i) + at_tau(cs.cols[2], i)) % r
            for i in range(cs.num_inputs)]


def draw_toxic_waste(rng: random.Random) -> Dict[str, int]:
    """alpha, beta, gamma, delta, tau uniform in [1, r)."""
    return {k: rng.randrange(1, bls.R) for k in ("alpha", "beta", "gamma", "delta", "tau")}


def _prepare(raw: bytes, inputs: Sequence[int], toxic, k: Sequence[int]):
    """(A, B, C, s) with s = alpha beta + sum_i x_i k_i, or None where the
    bytes name no proof (malformed, off the curve, or an identity)."""
    try:
        a, b, c = bls.proof_decompress(raw)
    except bls.EncodingError:
        return None
    if a is None or b is None or c is None or len(inputs) + 1 != len(k):
        return None
    s = toxic["alpha"] * toxic["beta"] + k[0] + sum(x * ki for x, ki in zip(inputs, k[1:]))
    return a, b, c, s % bls.R


def _holds(items, delta: int, rng: random.Random) -> bool:
    pairs, s_sum, cs = [], 0, []
    for a, b, c, s in items:
        rho = rng.getrandbits(64) | 1
        pairs.append((bls.G1.mul(a, rho), b))
        s_sum += rho * s
        cs.append(bls.G1.mul(c, rho))
    d = bls.G1.add(bls.G1.mul(bls.G1_GEN, s_sum % bls.R), bls.G1.mul(bls.G1.sum(cs), delta))
    pairs.append((bls.G1.neg(d), bls.G2_GEN))
    return bls.pairing_product_is_one(pairs)


def verify(proofs: Sequence[Tuple[bytes, Sequence[int]]], toxic: Dict[str, int], k: Sequence[int],
           rng: random.Random, group: int = 64) -> List[bool]:
    """One verdict per (192 proof bytes, public inputs without ONE)."""
    ok = [False] * len(proofs)
    ready = []
    for idx, (raw, inputs) in enumerate(proofs):
        item = _prepare(raw, inputs, toxic, k)
        if item is not None:
            ready.append((idx, item))
    for start in range(0, len(ready), group):
        chunk = ready[start : start + group]
        if _holds([item for _, item in chunk], toxic["delta"], rng):
            for idx, _ in chunk:
                ok[idx] = True
        else:
            for idx, item in chunk:
                ok[idx] = _holds([item], toxic["delta"], rng)
    return ok
