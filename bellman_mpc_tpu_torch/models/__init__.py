"""Demo circuits (host copies of the JAX package's MiMC, AndDemo and
RangeDemo models)."""

from .and_range import AndDemo, RangeDemo, RangeDemoExplicit
from .mimc import MIMC_ROUNDS, MiMCDemo, mimc, mimc_constants, neo_create_parameters

__all__ = [
    "AndDemo", "RangeDemo", "RangeDemoExplicit", "MIMC_ROUNDS", "MiMCDemo", "mimc",
    "mimc_constants", "neo_create_parameters",
]
