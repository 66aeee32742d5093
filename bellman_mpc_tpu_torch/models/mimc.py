"""MiMC demo circuit (LongsightF322p3) — the canonical benchmark circuit.

Host copy of bellman_mpc_tpu/models/mimc.py (the native round function,
the deterministic round constants and the `MiMCDemo` circuit), kept free of
any jax import so the PyTorch port can synthesize witnesses on its own.
"""

from __future__ import annotations

import random
from typing import List, Optional

from ..r1cs.core import AssignmentMissing, Circuit, ConstraintSystem

MIMC_ROUNDS = 322


def mimc(field, xl: int, xr: int, constants: List[int]) -> int:
    """Native MiMC evaluation (mimc_mod.rs:21-35)."""
    p = field.p
    for c in constants:
        t = (xl + c) % p
        xl, xr = (t * t % p * t + xr) % p, xl
    return xl


def mimc_constants(field, seed: int = 42, rounds: int = MIMC_ROUNDS) -> List[int]:
    """Deterministic round constants (the reference samples from an RNG,
    mimc.rs:27-30; a fixed seed keeps proofs reproducible)."""
    rng = random.Random(seed)
    return [rng.randrange(field.p) for _ in range(rounds)]


class MiMCDemo(Circuit):
    """Proving knowledge of a MiMC preimage (mimc_mod.rs:40-130).

    `constants` has MIMC_ROUNDS entries in the reference configuration; a
    shorter list scales the circuit down (used by small-field tests whose
    2-adic domain cannot fit 646 constraints)."""

    def __init__(self, constants: List[int], xl: Optional[int] = None, xr: Optional[int] = None):
        self.xl = xl
        self.xr = xr
        self.constants = constants

    def synthesize(self, cs: ConstraintSystem) -> None:
        p = cs.field.p

        def need(v):
            if v is None:
                raise AssignmentMissing()
            return v

        xl_value = self.xl
        xr_value = self.xr
        xl = cs.alloc("preimage xl", lambda: need(xl_value))
        xr = cs.alloc("preimage xr", lambda: need(xr_value))

        rounds = len(self.constants)
        for i in range(rounds):
            with cs.namespace(f"round {i}"):
                c = self.constants[i]
                tmp_value = (
                    pow((xl_value + c) % p, 2, p) if xl_value is not None else None
                )
                tmp = cs.alloc("tmp", lambda v=tmp_value: need(v))
                cs.enforce(
                    "tmp = (xL + Ci)^2",
                    lambda lc, xl=xl, c=c: lc + xl + (c, cs.one()),
                    lambda lc, xl=xl, c=c: lc + xl + (c, cs.one()),
                    lambda lc, tmp=tmp: lc + tmp,
                )

                new_xl_value = (
                    ((xl_value + c) * tmp_value + xr_value) % p
                    if xl_value is not None
                    else None
                )
                if i == rounds - 1:
                    new_xl = cs.alloc_input("image", lambda v=new_xl_value: need(v))
                else:
                    new_xl = cs.alloc("new_xl", lambda v=new_xl_value: need(v))

                cs.enforce(
                    "new_xL = xR + (xL + Ci)^3",
                    lambda lc, tmp=tmp: lc + tmp,
                    lambda lc, xl=xl, c=c: lc + xl + (c, cs.one()),
                    lambda lc, new_xl=new_xl, xr=xr: lc + new_xl - xr,
                )

                xr, xr_value = xl, xl_value
                xl, xl_value = new_xl, new_xl_value

