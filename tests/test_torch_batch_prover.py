"""The port's slice end to end on the CPU: setup -> BatchProver (rns) ->
prove -> verify for MiMC rounds=8 (domain 32), held against the reference.

* The port's proofs at B=2, on the reference's CRS carried over by
  `interop`, equal the reference's `create_random_proof` and pass the port's
  verifier (deterministic blinding makes proofs comparable).
* The port's sequential `create_random_proof` equals the reference's and
  the port's batch proof 0; its serialized proof, verifying key and
  parameters equal the reference's bytes and read back to the same objects.
* In a subprocess with jax made unimportable, the port runs its own
  setup (whose parameters equal the reference's CRS) -> prove -> verify,
  a sequential RangeDemo proof on parameters read from the port's
  serialized bytes, and the mock ceremony; it imports the ceremony,
  checkpoint, group-NTT and Gt-byte modules and the limb MSM, comb and
  EvaluationDomain entry points, the mesh and the sharded functions,
  builds a BatchProver on a (2, 2) mesh of CPU shards (the table
  strategy) and runs a sharded NTT, and proves the rns batch again with a
  GLV + merged-G1 BatchProver (BMT_GLV=1, BMT_MERGE_G1=1), whose proofs
  must be the same; it imports the host surface (config, ffi, benches,
  utils.profiling, parallel.worker, r1cs.test_cs, gadgets) and hashes one
  byte through the sha256 gadget on a TestConstraintSystem, against
  hashlib.
* `BatchProver.run_step` gives `step`'s tensors.
"""

import os
import random
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bellman_mpc_tpu.groth16 import Parameters as RefParameters
from bellman_mpc_tpu.groth16 import VerifyingKey as RefVerifyingKey
from bellman_mpc_tpu.groth16 import create_random_proof, generate_random_parameters
from bellman_mpc_tpu.groth16 import serialize as rser
from bellman_mpc_tpu.groth16.bls12 import BLS12_381
from bellman_mpc_tpu.models import MiMCDemo as RefMiMC
from bellman_mpc_tpu.models import RangeDemo as RefRangeDemo
from bellman_mpc_tpu.models import mimc_constants
from bellman_mpc_tpu_torch import groth16 as tg
from bellman_mpc_tpu_torch import interop
from bellman_mpc_tpu_torch.models import MiMCDemo, mimc
from bellman_mpc_tpu_torch.parallel import BatchProver

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

ROUNDS = 8
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_free_run(tmp_path_factory):
    """_JAX_FREE started in a subprocess, which runs alongside this module's
    in-process work (it needs only the reference's RangeDemo parameters):
    the process, its output files and the file where it writes the
    parameters of its own setup."""
    tmp = tmp_path_factory.mktemp("jax_free")
    setup = RefRangeDemo(a=1, b=2, n=4, w=9, wArray=[0, 0, 0, 0], less_or_equal=1, less=1,
                         not_all_zeros=1)
    r_params = interop.params_from(generate_random_parameters(BLS12_381, setup))
    (tmp / "range.params").write_bytes(tg.params_to_bytes(r_params))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    with open(tmp / "out", "w") as out, open(tmp / "err", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", _JAX_FREE, str(tmp / "range.params"),
                                 str(tmp / "mimc.params")], cwd=REPO, env=env, stdout=out, stderr=err)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)


@pytest.fixture(scope="module")
def jax_free(jax_free_run):
    """The subprocess's exit code, output and error, and its parameters file."""
    proc, tmp = jax_free_run
    rc = proc.wait(timeout=600)
    return SimpleNamespace(returncode=rc, stdout=(tmp / "out").read_text(),
                           stderr=(tmp / "err").read_text()), tmp / "mimc.params"


@pytest.fixture(scope="module")
def setup(jax_free_run):
    """The reference's CRS and sequential proofs, and the port's batch and
    sequential proofs of the same two witnesses on that CRS (made while the
    jax-free subprocess runs)."""
    host = BLS12_381.fr_host
    constants = mimc_constants(host, seed=9, rounds=ROUNDS)
    ref_params = generate_random_parameters(BLS12_381, RefMiMC(constants))
    engine = tg.Bls12Engine("cpu")
    params = interop.params_from(ref_params)
    rng = random.Random(4)
    wit = [(rng.randrange(host.p), rng.randrange(host.p)) for _ in range(2)]
    ref_proofs = [create_random_proof(BLS12_381, RefMiMC(constants, xl, xr), ref_params)
                  for xl, xr in wit]
    bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), msm_strategy="rns")
    return SimpleNamespace(
        host=host, constants=constants, ref_params=ref_params, engine=engine,
        params=params, wit=wit, ref_proofs=ref_proofs, bp=bp,
        proofs=bp.prove_batch([MiMCDemo(constants, xl, xr) for xl, xr in wit]),
        seq=tg.create_random_proof(engine, MiMCDemo(constants, *wit[0]), params),
    )


def test_crs_matches_reference(setup, jax_free):
    """The port's generate_random_parameters (run in the jax-free
    subprocess, bytes read back) equals the reference's CRS."""
    _, path = jax_free
    port_params = tg.params_from_bytes(path.read_bytes())
    assert port_params == setup.params
    assert interop.params_to(port_params, RefParameters, RefVerifyingKey) == setup.ref_params


def test_proofs_match_reference(setup):
    host, constants, engine = setup.host, setup.constants, setup.engine
    assert [c for _, _, c, _ in setup.bp.table_info()] == [4] * 5  # the CPU window width
    pvk = tg.prepare_verifying_key(engine, setup.params.vk)
    for (xl, xr), proof, seq in zip(setup.wit, setup.proofs, setup.ref_proofs):
        tg.verify_proof(engine, pvk, proof, [mimc(host, xl, xr, constants)])
        assert interop.proof_from(seq) == proof
    with pytest.raises(tg.verifier.InvalidProof):
        tg.verify_proof(engine, pvk, setup.proofs[0], [mimc(host, *setup.wit[1], constants)])


def test_sequential_proof_matches_reference(setup):
    assert setup.seq == interop.proof_from(setup.ref_proofs[0])
    assert setup.seq == setup.proofs[0]


def test_serialized_bytes_match_reference(setup):
    proof_bytes = tg.proof_to_bytes(setup.seq)
    assert len(proof_bytes) == 192
    assert proof_bytes == rser.proof_to_bytes(setup.ref_proofs[0])
    assert tg.proof_from_bytes(proof_bytes) == setup.seq
    vk_bytes = tg.vk_to_bytes(setup.params.vk)
    assert vk_bytes == rser.vk_to_bytes(setup.ref_params.vk)
    assert tg.vk_from_bytes(vk_bytes) == setup.params.vk
    params_bytes = tg.params_to_bytes(setup.params)
    assert params_bytes == rser.params_to_bytes(setup.ref_params)
    assert tg.params_from_bytes(params_bytes) == setup.params
    with pytest.raises(tg.serialize.IoError):
        tg.proof_from_bytes(proof_bytes[:-1])


def test_run_step_equals_step(setup):
    """BatchProver.run_step, the reference's name for the raw step, gives
    step's tensors, which decode to the batch proofs."""
    bp = setup.bp
    args = bp.encode_circuits([MiMCDemo(setup.constants, xl, xr) for xl, xr in setup.wit])
    got, want = bp.run_step(*args), bp.step(*args)
    for g, w in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(g, w))
    assert bp.decode(*got) == setup.proofs


_JAX_FREE = """
import os, random, sys
sys.modules["jax"] = None
from bellman_mpc_tpu_torch import groth16 as tg
from bellman_mpc_tpu_torch.fields.mock import mock, mock_host
from bellman_mpc_tpu_torch.models import AndDemo, MiMCDemo, RangeDemo, RangeDemoExplicit, mimc, mimc_constants
from bellman_mpc_tpu_torch.ops import group_ntt, kernel_lib, mont_kernels, pairing, tower
from bellman_mpc_tpu_torch.groth16 import mpc, mpc_serialize, verifier_batch
from bellman_mpc_tpu_torch.utils import gt_format, gt_parse
from bellman_mpc_tpu_torch.parallel import BatchProver, make_mesh
from bellman_mpc_tpu_torch.parallel import mesh as pmesh, sharded
from bellman_mpc_tpu_torch.ops.msm import batch_mul_comb_host, msm_flat_pippenger
from bellman_mpc_tpu_torch.ops.domain import EvaluationDomain, ntt
assert callable(EvaluationDomain.coset_fft)
eng = tg.Bls12Engine("cpu")
host = eng.fr_host
constants = mimc_constants(host, seed=9, rounds=8)
params = tg.generate_random_parameters(eng, MiMCDemo(constants))
with open(sys.argv[2], "wb") as fh:
    fh.write(tg.params_to_bytes(params))
bp = BatchProver(eng, params, MiMCDemo(constants, 0, 0), msm_strategy="rns")
cpu_mesh = make_mesh(4, devices=["cpu"] * 4)
assert pmesh.make_mesh is make_mesh and cpu_mesh.shape == {"data": 2, "model": 2}
bp_mesh = BatchProver(eng, params, MiMCDemo(constants, 0, 0), mesh=cpu_mesh)
assert bp_mesh.msm_strategy == "table" and [c for _, _, c, _ in bp_mesh.table_info()] == [4] * 5
x = mock.encode(list(range(16)))
assert mock.decode(sharded.sharded_ntt(cpu_mesh, mock, mock_host, x)) == mock.decode(ntt(mock, mock_host, x))
rng = random.Random(8)
wit = [(rng.randrange(host.p), rng.randrange(host.p)) for _ in range(2)]
proofs = bp.prove_batch([MiMCDemo(constants, a, b) for a, b in wit])
pvk = tg.prepare_verifying_key(eng, params.vk)
for (a, b), pr in zip(wit, proofs):
    tg.verify_proof(eng, pvk, pr, [mimc(host, a, b, constants)])
os.environ.update(BMT_GLV="1", BMT_MERGE_G1="1")
bp_opt = BatchProver(eng, params, MiMCDemo(constants, 0, 0), msm_strategy="rns")
del os.environ["BMT_GLV"], os.environ["BMT_MERGE_G1"]
assert bp_opt.glv and bp_opt.merge_g1 and bp_opt.table_info()[0][:2] == ("g1_merged", 224)
assert bp_opt.prove_batch([MiMCDemo(constants, a, b) for a, b in wit]) == proofs
with open(sys.argv[1], "rb") as fh:
    r_params = tg.params_from_bytes(fh.read())
r_proof = tg.create_random_proof(
    eng, RangeDemo(a=1, b=3, n=4, w=10, wArray=[0, 1, 0, 1], less_or_equal=1, less=1,
                   not_all_zeros=1), r_params)
tg.verify_proof(eng, tg.prepare_verifying_key(eng, r_params.vk), r_proof, [3])
dummy = tg.DummyEngine("cpu")
assert tg.DUMMY.device.type == "cuda" and isinstance(dummy, tg.Engine)
assert mpc.mpc_common_paramters_custom_all(dummy, 8).tau_g1[1] == 2
assert mpc_serialize.common_storage_from_bytes(mpc_serialize.common_storage_to_bytes(
    mpc.initial_common_paramters(eng, 2))).tau_g1 == [eng.g1.generator()] * 2
assert mpc.generate_parameters_mpc(dummy, AndDemo(None, None), basis="lagrange").vk.delta_g2 == 24
assert isinstance(eng.g1, tg.GroupAPI) and len(eng.g1.intt([eng.g1.generator()] * 2, host)) == 2
assert gt_parse(gt_format(((((1, 2),) * 3),) * 2)) == ((((1, 2),) * 3),) * 2
import hashlib
from bellman_mpc_tpu_torch import benches, config, ffi
from bellman_mpc_tpu_torch.utils import profiling
from bellman_mpc_tpu_torch.parallel import Waiter, Worker, log2_floor, worker
from bellman_mpc_tpu_torch.r1cs import TestConstraintSystem, test_cs
from bellman_mpc_tpu_torch.gadgets import AllocatedBit, Boolean, sha256
from bellman_mpc_tpu_torch.models import neo_create_parameters
assert config.Config.from_env().pippenger_c == 8 and Worker(2).compute(lambda: 3).wait() == 3
cs = TestConstraintSystem(host)
bits = [Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"bit {i}"), bool((0x61 >> (7 - i)) & 1)))
        for i in range(8)]
digest = [b.get_value() for b in sha256(cs, bits)]
assert cs.is_satisfied() and digest == [bool((c >> i) & 1) for c in hashlib.sha256(b"a").digest()
                                        for i in range(7, -1, -1)]
assert not any(m == "jax" or m.startswith(("jax.", "bellman_mpc_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("JAX_FREE_OK")
"""


def test_port_runs_without_jax(jax_free):
    out, _ = jax_free
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_FREE_OK" in out.stdout
