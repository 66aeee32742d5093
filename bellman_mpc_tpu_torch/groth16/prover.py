"""Groth16 prover pieces the batched prover uses.

Port of the parts of bellman_mpc_tpu/groth16/prover.py on the main path:
the fork-pinned deterministic blinding (prover.rs:169-170), witness
synthesis with the per-input dummy constraints (prover.rs:198-204), and the
h(x) pipeline (prover.rs:210-231: 3x (iFFT, coset-FFT), pointwise a*b - c,
divide by Z on the coset, icoset-FFT) over (L, *batch, m) limb tensors.
"""

from __future__ import annotations

import functools

from ..fields.host import PrimeField
from ..fields.limb import LimbField
from ..ops.domain import distribute_powers, ntt, warm_twiddles
from ..r1cs.core import INPUT, Circuit, Variable
from .assembly import ProvingAssignment

DETERMINISTIC_R = 27134
DETERMINISTIC_S = 17146


@functools.lru_cache(maxsize=None)
def _h_pipeline(field: LimbField, host: PrimeField, exp: int):
    """The h(x) pipeline for a 2^exp domain; the returned function maps
    (L, *batch, m) Montgomery tensors a, b, c to h's coefficients."""
    gen = host.generator
    geninv = host.inv(gen)
    m = 1 << exp
    zinv = host.inv((pow(gen, m, host.p) - 1) % host.p)
    warm_twiddles(field, host, exp)

    def coset_values(x):
        x = ntt(field, host, x, inverse=True)  # ifft
        x = distribute_powers(field, host, x, gen)
        return ntt(field, host, x, inverse=False)  # coset_fft

    def pipeline(a, b, c):
        a = coset_values(a)
        b = coset_values(b)
        c = coset_values(c)
        h = field.sub(field.mul(a, b), c)
        h = field.mul_const(h, zinv)  # divide_by_z_on_coset
        h = ntt(field, host, h, inverse=True)  # icoset_fft part 1
        return distribute_powers(field, host, h, geninv)

    return pipeline


def synthesize_witness(engine, circuit: Circuit) -> ProvingAssignment:
    prover = ProvingAssignment(engine.fr_host)
    prover.alloc_input("", lambda: 1)  # prover.rs:198
    circuit.synthesize(prover)
    for i in range(len(prover.input_assignment)):  # prover.rs:202-204
        v = Variable(INPUT, i)
        prover.enforce("", lambda lc, v=v: lc + v, lambda lc: lc, lambda lc: lc)
    return prover
