"""The mock test field GF(64513) — copy of bellman_mpc_tpu/fields/mock.py.

Reference: bellman/src/groth16/tests/dummy_engine.rs:15 (MODULUS_R = 64513),
:289-317 (NUM_BITS=16, CAPACITY=15, S=10, multiplicative generator 5, root of
unity 57751).  Its limb form has L = 2, the smallest shape the limb kernels
take.
"""

from __future__ import annotations

from .host import PrimeField
from .limb import LimbField

MODULUS = 64513

mock_host = PrimeField(MODULUS, generator=5, name="MockFr")
assert mock_host.S == 10
assert mock_host.root_of_unity == 57751  # dummy_engine.rs:314-316
assert mock_host.num_bits == 16 and mock_host.capacity == 15

mock = LimbField(MODULUS, name="MockFr")
