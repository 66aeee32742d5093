"""Frozen copies of the port's constraint-system core and gadgets.

`core.py` is bellman_mpc_tpu_torch/r1cs/core.py and `boolean.py`,
`num.py`, `multieq.py`, `multipack.py`, `uint32.py` and `sha256.py` are
bellman_mpc_tpu_torch/gadgets/*.py as they stood when the benchmark was
written, with their imports pointed here; `mimc.py` is the MiMC circuit of
bellman_mpc_tpu_torch/models/mimc.py.  The reference synthesizes the
benchmark's circuits through them into its own recorder (`r1cs.py`), so the
constraint system that it derives the verifying key from stays fixed
whatever later changes the program's gadgets: a program whose circuit
changed no longer proves the benchmark's statement, and its proofs fail.
"""
