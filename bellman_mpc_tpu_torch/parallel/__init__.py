from .mesh import make_mesh
from .batch_prover import BatchProver
from .worker import Waiter, Worker, log2_floor

__all__ = ["make_mesh", "BatchProver", "Waiter", "Worker", "log2_floor"]
