"""bellman_mpc_tpu_torch — the PyTorch/CUDA port of bellman_mpc_tpu.

The batched Groth16 prover's main path (MiMC circuits, the `rns` MSM
strategy) on PyTorch tensors, with the window-fold kernels written by hand
in CUDA C++ for Hopper (csrc/).  The JAX package bellman_mpc_tpu stays the
reference; this package never imports jax.  Module names mirror the
reference's, so each module's counterpart is easy to find.
"""

__version__ = "0.1.0"
