"""Groth16 verifier (copy of bellman_mpc_tpu/groth16/verifier.py).

Port of bellman/src/groth16/verifier.rs: `prepare_verifying_key` (:11-21)
caches e(alpha, beta) and the negated gamma/delta G2 points;
`verify_proof` (:23-62) does the IC multi-scalar accumulation over public
inputs and one 3-term multi-Miller loop + final exponentiation against the
cached e(alpha, beta).
"""

from __future__ import annotations

from typing import List, Sequence

from ..r1cs.core import InvalidProof, InvalidVerifyingKey
from .types import PreparedVerifyingKey, Proof, VerifyingKey


def prepare_verifying_key(engine, vk: VerifyingKey) -> PreparedVerifyingKey:
    return PreparedVerifyingKey(
        alpha_g1_beta_g2=engine.pairing(vk.alpha_g1, vk.beta_g2),
        neg_gamma_g2=engine.prepare_g2(engine.g2.neg(vk.gamma_g2)),
        neg_delta_g2=engine.prepare_g2(engine.g2.neg(vk.delta_g2)),
        ic=list(vk.ic),
        neg_alpha_g1=engine.g1.neg(vk.alpha_g1),
        beta_g2=engine.prepare_g2(vk.beta_g2),
    )


def verify_proof(
    engine,
    pvk: PreparedVerifyingKey,
    proof: Proof,
    public_inputs: Sequence[int],
) -> None:
    """Raises InvalidVerifyingKey / InvalidProof on failure (verifier.rs:23-62).

    Checks  e(A, B) = e(alpha, beta) * e(inputs, gamma) * e(C, delta)
    rearranged into a single multi-Miller loop with -gamma2/-delta2.
    """
    if len(public_inputs) + 1 != len(pvk.ic):
        raise InvalidVerifyingKey()

    G1 = engine.g1
    acc = pvk.ic[0]
    for x, ic in zip(public_inputs, pvk.ic[1:]):
        acc = G1.add(acc, G1.mul(ic, x))

    terms = [
        (proof.a, engine.prepare_g2(proof.b)),
        (acc, pvk.neg_gamma_g2),
        (proof.c, pvk.neg_delta_g2),
    ]
    if pvk.neg_alpha_g1 is not None:
        # e(A,B) e(acc,-gamma) e(C,-delta) e(-alpha,beta) == 1: the whole
        # check is one pairing-product program (device-fused on BLS).
        ok = engine.pairing_product_is_one(
            terms + [(pvk.neg_alpha_g1, pvk.beta_g2)]
        )
    else:
        lhs = engine.final_exponentiation(engine.multi_miller_loop(terms))
        ok = engine.gt_eq(lhs, pvk.alpha_g1_beta_g2)
    if not ok:
        raise InvalidProof()
