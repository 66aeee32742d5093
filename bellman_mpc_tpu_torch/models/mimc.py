"""MiMC demo circuit (LongsightF322p3) — the canonical benchmark circuit.

Copy of bellman_mpc_tpu/models/mimc.py on the port's engines: the native
round function, the deterministic round constants, the `MiMCDemo` circuit,
and the helpers of bellman/src/mimc.rs: `neo_create_parameters`
(:24-46) and the timed prove/verify loop (:51-131), `timed_prove_verify`.
The port has no engine singleton, so both helpers take the engine; it runs
where its `device` says.
"""

from __future__ import annotations

import random
import time
from typing import List, Optional

from ..groth16 import (
    create_random_proof,
    generate_random_parameters,
    prepare_verifying_key,
    verify_proof,
)
from ..groth16.engine import Engine
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


def neo_create_parameters(engine: Engine, seed: int = 42):
    """FFI-style parameter factory (mimc.rs:24-46)."""
    constants = mimc_constants(engine.fr_host, seed)
    return generate_random_parameters(engine, MiMCDemo(constants)), constants


def timed_prove_verify(engine: Engine, samples: int = 50, seed: int = 42):
    """The reference's 50-sample timed prove/verify loop (mimc.rs:51-131).

    Returns (avg_proving_s, avg_verifying_s).  Queued device work ends
    inside each timed part: proof creation and verification read their
    results back to host ints.
    """
    from ..groth16.serialize import proof_from_bytes, proof_to_bytes

    constants = mimc_constants(engine.fr_host, seed)
    params = generate_random_parameters(engine, MiMCDemo(constants))
    pvk = prepare_verifying_key(engine, params.vk)

    rng = random.Random(seed + 1)
    total_proving = 0.0
    total_verifying = 0.0
    for _ in range(samples):
        xl = rng.randrange(engine.fr_host.p)
        xr = rng.randrange(engine.fr_host.p)
        image = mimc(engine.fr_host, xl, xr, constants)

        start = time.perf_counter()
        proof = create_random_proof(engine, MiMCDemo(constants, xl, xr), params)
        if engine.name == "bls12_381":
            raw = proof_to_bytes(proof)
        total_proving += time.perf_counter() - start

        start = time.perf_counter()
        if engine.name == "bls12_381":
            proof = proof_from_bytes(raw)
        verify_proof(engine, pvk, proof, [image])
        total_verifying += time.perf_counter() - start

    return total_proving / samples, total_verifying / samples
