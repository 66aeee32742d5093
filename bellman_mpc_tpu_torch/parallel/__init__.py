from .batch_prover import BatchProver

__all__ = ["BatchProver"]
