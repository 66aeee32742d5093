"""Groth16 key / proof containers and the parameter-source contract.

Ports the type surface of bellman/src/groth16/mod.rs: `Proof` (:28-33),
`VerifyingKey` (:105-131), `Parameters` (:224-247), `PreparedVerifyingKey`
(:403-412) and the `ParameterSource` streaming contract (:414-477).
Serialization lives in groth16/serialize.py (byte-compatible with the
reference's formats).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Proof:
    a: object  # G1 affine
    b: object  # G2 affine
    c: object  # G1 affine

    def __eq__(self, other) -> bool:
        return (self.a, self.b, self.c) == (other.a, other.b, other.c)


@dataclass
class VerifyingKey:
    alpha_g1: object
    beta_g1: object
    beta_g2: object
    gamma_g2: object
    delta_g1: object
    delta_g2: object
    ic: List[object]

    def __eq__(self, other) -> bool:
        return (
            self.alpha_g1 == other.alpha_g1
            and self.beta_g1 == other.beta_g1
            and self.beta_g2 == other.beta_g2
            and self.gamma_g2 == other.gamma_g2
            and self.delta_g1 == other.delta_g1
            and self.delta_g2 == other.delta_g2
            and self.ic == other.ic
        )


@dataclass
class Parameters:
    """CRS: vk + h/l/a/b queries (mod.rs:224-247).

    Implements the `ParameterSource` contract (mod.rs:414-477) directly:
    offsets into the identity-filtered a/b query vectors.
    """

    vk: VerifyingKey
    h: List[object]
    l: List[object]
    a: List[object]
    b_g1: List[object]
    b_g2: List[object]

    # -- ParameterSource (mod.rs:438-477) -----------------------------------
    def get_vk(self, _num_ic: int = 0) -> VerifyingKey:
        return self.vk

    def get_h(self, _n: int = 0):
        return self.h

    def get_l(self, _n: int = 0):
        return self.l

    def get_a(self, num_inputs: int, _num_aux: int = 0):
        return self.a[:num_inputs], self.a[num_inputs:]

    def get_b_g1(self, num_inputs: int, _num_aux: int = 0):
        return self.b_g1[:num_inputs], self.b_g1[num_inputs:]

    def get_b_g2(self, num_inputs: int, _num_aux: int = 0):
        return self.b_g2[:num_inputs], self.b_g2[num_inputs:]

    def __eq__(self, other) -> bool:
        return (
            self.vk == other.vk
            and self.h == other.h
            and self.l == other.l
            and self.a == other.a
            and self.b_g1 == other.b_g1
            and self.b_g2 == other.b_g2
        )


@dataclass
class PreparedVerifyingKey:
    """e(alpha, beta) cached; -gamma2/-delta2 prepared (mod.rs:403-412).

    `neg_alpha_g1`/`beta_g2` let the verifier run its check as
    e(A,B) e(acc,-gamma) e(C,-delta) e(-alpha,beta) == 1 in ONE fused
    device program (Engine.pairing_product_is_one); `alpha_g1_beta_g2`
    is kept for the reference-parity Gt comparison fallback."""

    alpha_g1_beta_g2: object  # Gt
    neg_gamma_g2: object
    neg_delta_g2: object
    ic: List[object]
    neg_alpha_g1: object = None
    beta_g2: object = None
