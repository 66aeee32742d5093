from .batch_prover import BatchProver
from .worker import Waiter, Worker, log2_floor

# make_mesh (parallel/mesh.py) is still to be ported (ROADMAP A5)
__all__ = ["BatchProver", "Waiter", "Worker", "log2_floor"]
