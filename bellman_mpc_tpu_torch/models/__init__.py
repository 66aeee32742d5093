"""Demo circuits (host copies of the JAX package's MiMC model)."""

from .mimc import MIMC_ROUNDS, MiMCDemo, mimc, mimc_constants

__all__ = ["MIMC_ROUNDS", "MiMCDemo", "mimc", "mimc_constants"]
