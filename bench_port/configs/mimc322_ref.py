"""mimc322, the reference's side: witnesses from the seed, the public input
(the MiMC image, by plain evaluation) and the frozen circuit."""

from __future__ import annotations

import random
from typing import List, Tuple

from reference.bls12_381 import R
from reference.circuits.mimc import MiMCDemo, mimc, mimc_constants


def constants(cfg) -> List[int]:
    return mimc_constants(R, cfg["constants_seed"], cfg["rounds"])


def draw_witnesses(cfg, rng: random.Random, n: int) -> List[Tuple[int, int]]:
    return [(rng.randrange(R), rng.randrange(R)) for _ in range(n)]


def public_inputs(cfg, witness) -> List[int]:
    return [mimc(R, witness[0], witness[1], constants(cfg))]


def circuit(cfg):
    return MiMCDemo(constants(cfg))
