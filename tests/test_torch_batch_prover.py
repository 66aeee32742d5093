"""The port's slice end to end on the CPU: setup -> BatchProver (rns) ->
prove -> verify for MiMC rounds=8 (domain 32), held against the reference.

* The port's proofs at B=2, on the reference's CRS carried over by
  `interop`, equal the reference's `create_random_proof` and pass the port's
  verifier (deterministic blinding makes proofs comparable).
* The port's `generate_random_parameters` equals the reference's.
* In a subprocess with jax made unimportable, the port runs its own
  setup -> prove -> verify.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from bellman_mpc_tpu.groth16 import Parameters as RefParameters
from bellman_mpc_tpu.groth16 import VerifyingKey as RefVerifyingKey
from bellman_mpc_tpu.groth16 import create_random_proof, generate_random_parameters
from bellman_mpc_tpu.groth16.bls12 import BLS12_381
from bellman_mpc_tpu.models import MiMCDemo as RefMiMC
from bellman_mpc_tpu.models import mimc_constants
from bellman_mpc_tpu_torch import groth16 as tg
from bellman_mpc_tpu_torch import interop
from bellman_mpc_tpu_torch.models import MiMCDemo, mimc
from bellman_mpc_tpu_torch.parallel import BatchProver

ROUNDS = 8
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    host = BLS12_381.fr_host
    constants = mimc_constants(host, seed=9, rounds=ROUNDS)
    ref_params = generate_random_parameters(BLS12_381, RefMiMC(constants))
    engine = tg.Bls12Engine("cpu")
    return host, constants, ref_params, engine


def test_crs_matches_reference(setup):
    host, constants, ref_params, engine = setup
    port_params = tg.generate_random_parameters(engine, MiMCDemo(constants))
    assert port_params == interop.params_from(ref_params)
    assert interop.params_to(port_params, RefParameters, RefVerifyingKey) == ref_params


def test_proofs_match_reference(setup):
    host, constants, ref_params, engine = setup
    params = interop.params_from(ref_params)
    bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), msm_strategy="rns")
    assert [c for _, _, c, _ in bp.table_info()] == [4] * 5  # the CPU window width
    rng = random.Random(4)
    wit = [(rng.randrange(host.p), rng.randrange(host.p)) for _ in range(2)]
    proofs = bp.prove_batch([MiMCDemo(constants, xl, xr) for xl, xr in wit])
    pvk = tg.prepare_verifying_key(engine, params.vk)
    for (xl, xr), proof in zip(wit, proofs):
        tg.verify_proof(engine, pvk, proof, [mimc(host, xl, xr, constants)])
        seq = create_random_proof(BLS12_381, RefMiMC(constants, xl, xr), ref_params)
        assert interop.proof_from(seq) == proof
    with pytest.raises(tg.verifier.InvalidProof):
        tg.verify_proof(engine, pvk, proofs[0], [mimc(host, *wit[1], constants)])


_JAX_FREE = """
import random, sys
sys.modules["jax"] = None
from bellman_mpc_tpu_torch import groth16 as tg
from bellman_mpc_tpu_torch.models import MiMCDemo, mimc, mimc_constants
from bellman_mpc_tpu_torch.parallel import BatchProver
eng = tg.Bls12Engine("cpu")
host = eng.fr_host
constants = mimc_constants(host, seed=9, rounds=8)
params = tg.generate_random_parameters(eng, MiMCDemo(constants))
bp = BatchProver(eng, params, MiMCDemo(constants, 0, 0))
rng = random.Random(8)
wit = [(rng.randrange(host.p), rng.randrange(host.p)) for _ in range(2)]
proofs = bp.prove_batch([MiMCDemo(constants, a, b) for a, b in wit])
pvk = tg.prepare_verifying_key(eng, params.vk)
for (a, b), pr in zip(wit, proofs):
    tg.verify_proof(eng, pvk, pr, [mimc(host, a, b, constants)])
assert not any(m == "jax" or m.startswith(("jax.", "bellman_mpc_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("JAX_FREE_OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _JAX_FREE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_FREE_OK" in out.stdout
