"""The port's BatchProver MSM strategies on the CPU, held against the
reference's sequential prover on one MiMC rounds=8 CRS (domain 32) at B=2:
ladder, table (signed affine tables; unsigned projective tables under
BMT_TABLE_SIGNED=0), pippenger and flatpip (pippenger_c=4).  Each batch
equals the reference's `create_random_proof` of the same witnesses, and its
step and decode make the limb multiplies (LimbField.mul, the limb
Montgomery kernel on the card) that chip_smoke.k4_counts derives.  "auto"
resolves to ladder on a CPU engine; `mesh=` with a strategy other than
table raises ValueError (the mesh cases are in tests/test_torch_opt_ins.py),
and BMT_STACK_MSMS=1 with rns, table or flatpip (which the reference's
stacked path cannot run) raises ValueError."""

import random
from types import SimpleNamespace

import pytest
import torch

from bellman_mpc_tpu.groth16 import create_random_proof, generate_random_parameters
from bellman_mpc_tpu.groth16.bls12 import BLS12_381
from bellman_mpc_tpu.models import MiMCDemo as RefMiMC
from bellman_mpc_tpu.models import mimc_constants
from bellman_mpc_tpu_torch import groth16 as tg
from bellman_mpc_tpu_torch import interop
from bellman_mpc_tpu_torch.fields.bls12_381 import fp
from bellman_mpc_tpu_torch.fields.limb import LimbField
from bellman_mpc_tpu_torch.models import MiMCDemo
from bellman_mpc_tpu_torch.parallel import BatchProver, make_mesh

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

ROUNDS = 8


@pytest.fixture(scope="module")
def crs():
    """The reference's CRS, carried over to the port."""
    host = BLS12_381.fr_host
    constants = mimc_constants(host, seed=9, rounds=ROUNDS)
    ref_params = generate_random_parameters(BLS12_381, RefMiMC(constants))
    return SimpleNamespace(host=host, constants=constants, ref_params=ref_params,
                           params=interop.params_from(ref_params), engine=tg.Bls12Engine("cpu"))


@pytest.fixture(scope="module")
def reference(crs):
    """Two witnesses and the reference's sequential proofs of them."""
    rng = random.Random(12)
    wit = [(rng.randrange(crs.host.p), rng.randrange(crs.host.p)) for _ in range(2)]
    proofs = [interop.proof_from(create_random_proof(BLS12_381, RefMiMC(crs.constants, xl, xr),
                                                     crs.ref_params)) for xl, xr in wit]
    return wit, proofs


def _prover(crs, **kw):
    return BatchProver(crs.engine, crs.params, MiMCDemo(crs.constants, 0, 0), **kw)


def test_auto_and_unported_opt_ins(crs, monkeypatch):
    bp = _prover(crs)
    assert bp.msm_strategy == "ladder" and bp.table_info() == []
    assert not (bp.glv or bp.merge_g1 or bp.stack_msms)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    for strategy in ("ladder", "rns", "pippenger"):
        with pytest.raises(ValueError, match="table strategy"):
            _prover(crs, msm_strategy=strategy, mesh=mesh)
    monkeypatch.setenv("BMT_STACK_MSMS", "1")
    for strategy in ("rns", "table", "flatpip"):
        with pytest.raises(ValueError, match="BMT_STACK_MSMS"):
            _prover(crs, msm_strategy=strategy)
    monkeypatch.delenv("BMT_STACK_MSMS")
    with pytest.raises(ValueError):
        _prover(crs, msm_strategy="glv")


def _counting_mul(counter):
    mul = LimbField.mul

    def counted(self, a, b):
        counter[0] += 1
        return mul(self, a, b)

    return counted


@pytest.mark.parametrize(
    "strategy,env",
    [("ladder", {}), ("table", {}), ("table", {"BMT_TABLE_SIGNED": "0"}), ("pippenger", {}),
     ("flatpip", {})],
    ids=["ladder", "table", "table-unsigned", "pippenger", "flatpip"],
)
def test_strategy_matches_reference(crs, reference, strategy, env, monkeypatch):
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    bp = _prover(crs, msm_strategy=strategy, pippenger_c=4)
    tables = [c for _, _, c, _ in bp.table_info()]
    assert tables == ([4] * 5 if strategy == "table" else [])
    wit, want = reference
    args = bp.encode_circuits([MiMCDemo(crs.constants, xl, xr) for xl, xr in wit])
    muls = [0]
    monkeypatch.setattr(LimbField, "mul", _counting_mul(muls))
    out = bp.step(*args)
    step_muls = muls[0]
    proofs = bp.decode(*out)
    assert proofs == want
    # a step: to_mont, the h(x) pipeline (15 exp + 10), std_from_mont; a
    # decode: two G1 sets (an inversion, 4 products) and one G2 set (the
    # norm, its inversion, 8 products), as chip_smoke.k4_counts
    inv = (fp.p - 2).bit_length() + bin(fp.p - 2).count("1")
    assert step_muls == 15 * bp.exp + 12
    assert muls[0] - step_muls == 2 * (inv + 4) + (inv + 9)
