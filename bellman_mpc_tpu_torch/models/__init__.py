"""Circuits: host copies of the JAX package's MiMC, AndDemo and RangeDemo
models, and the Zcash Sapling Spend statement."""

from .and_range import AndDemo, RangeDemo, RangeDemoExplicit
from .mimc import MIMC_ROUNDS, MiMCDemo, mimc, mimc_constants, neo_create_parameters
from .sapling import Spend, spend_from_secrets

__all__ = [
    "AndDemo", "RangeDemo", "RangeDemoExplicit", "MIMC_ROUNDS", "MiMCDemo", "mimc",
    "mimc_constants", "neo_create_parameters", "Spend", "spend_from_secrets",
]
