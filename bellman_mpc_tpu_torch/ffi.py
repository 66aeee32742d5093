"""External entry points (the reference's C-ABI surface).

Copy of bellman_mpc_tpu/ffi.py.  The reference builds as a dylib named
`groth16` exposing `#[no_mangle] extern "C"` functions for a blockchain VM
(bellman/src/lib.rs:156-201, bellman/Cargo.toml:48-50).  The equivalent
boundary is this module: stable, dependency-light callables a host runtime
can invoke.  The port has no engine singleton: `test_create_parameters`
takes an engine and builds `Bls12Engine()`, on the first CUDA card, when it
is given none.
"""

from __future__ import annotations

import threading


def test_bellman() -> None:
    """No-op healthcheck (lib.rs:157-159 — the reference body is commented out)."""


def test_create_parameters(engine=None):
    """Build MiMC-322 parameters (lib.rs:162-164 -> mimc.rs:24-46)."""
    from .groth16.engine import Bls12Engine
    from .models.mimc import neo_create_parameters

    params, _constants = neo_create_parameters(engine or Bls12Engine())
    return params


def process() -> list:
    """Thread smoke test (lib.rs:180-201): 10 workers count to 5,000,000."""
    results = [0] * 10

    def work(i: int) -> None:
        x = 0
        for _ in range(5_000_000):
            x += 1
        results[i] = x

    threads = [threading.Thread(target=work, args=(i,)) for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results
