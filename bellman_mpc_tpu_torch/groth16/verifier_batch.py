"""Batched Groth16 verification via a random linear combination.

Port of bellman_mpc_tpu/groth16/verifier_batch.py (bellman's
src/groth16/verifier/batch.rs): `Item` (:36-61) with its `verify_single`
fallback, `BatchVerifier::{queue, verify}` (:68-170).  Per item a random
z != 0 folds a (zA, -B) Miller term; input coefficients accumulate into
per-IC sums; sum(zC) folds against delta and [sum(z)]alpha against beta;
the product of all n + 3 pairings must be 1.

On a CUDA engine the check is one device program
(ops/pairing.pairing_product_is_one): one batched Miller loop and one
final exponentiation, whatever the batch size.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

from ..r1cs.core import InvalidProof, InvalidVerifyingKey
from .types import PreparedVerifyingKey, Proof, VerifyingKey
from .verifier import verify_proof


class Item:
    def __init__(self, proof: Proof, inputs: Sequence[int]):
        self.proof = proof
        self.inputs = list(inputs)

    def verify_single(self, engine, pvk: PreparedVerifyingKey) -> None:
        verify_proof(engine, pvk, self.proof, self.inputs)


class BatchVerifier:
    def __init__(self):
        self.items: List[Item] = []

    def queue(self, item) -> None:
        if not isinstance(item, Item):
            proof, inputs = item
            item = Item(proof, inputs)
        self.items.append(item)

    def verify(self, engine, vk: VerifyingKey, rng: Optional[random.Random] = None) -> None:
        """Raises InvalidVerifyingKey / InvalidProof on failure."""
        rng = rng or random.Random()
        p = engine.fr_host.p
        G1, G2 = engine.g1, engine.g2

        if any(len(it.inputs) + 1 != len(vk.ic) for it in self.items):
            raise InvalidVerifyingKey()

        ml_terms: List[Tuple[object, object]] = []
        acc_gammas = [0] * len(vk.ic)
        acc_delta = G1.identity()
        acc_y = 0

        for it in self.items:
            z = 0
            while z == 0:
                z = rng.randrange(p)
            ml_terms.append((G1.mul(it.proof.a, z), engine.prepare_g2(G2.neg(it.proof.b))))
            acc_gammas[0] = (acc_gammas[0] + z) % p
            for i, a_i in enumerate(it.inputs):
                acc_gammas[i + 1] = (acc_gammas[i + 1] + z * a_i) % p
            acc_delta = G1.add(acc_delta, G1.mul(it.proof.c, z))
            acc_y = (acc_y + z) % p

        ml_terms.append((acc_delta, engine.prepare_g2(vk.delta_g2)))
        psi = G1.msm(vk.ic, acc_gammas)
        ml_terms.append((psi, engine.prepare_g2(vk.gamma_g2)))
        ml_terms.append((G1.mul(vk.alpha_g1, acc_y), engine.prepare_g2(vk.beta_g2)))

        if not engine.pairing_product_is_one(ml_terms):
            raise InvalidProof()
