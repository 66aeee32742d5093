"""The port's AndDemo / RangeDemo circuits and the sequential prover on
RangeDemo, held against the reference on the CPU.

* AndDemo, RangeDemoExplicit and RangeDemo synthesize the reference's
  constraints, assignments and densities.
* On the reference's RangeDemo CRS (n = 4, the chip gate's setup), the
  port's `create_random_proof` equals the reference's, and the port's
  BatchProver (rns) proof 0 equals it too; both batch proofs verify.
  RangeDemo has an input wire, a 2^4 domain and CRS sets of 7 to 15 points,
  shapes that MiMC does not give the batched prover.
"""

from types import SimpleNamespace

import pytest
import torch

from bellman_mpc_tpu.groth16 import create_random_proof, generate_random_parameters
from bellman_mpc_tpu.groth16 import prover as rpv
from bellman_mpc_tpu.groth16.bls12 import BLS12_381
from bellman_mpc_tpu.models import AndDemo as RefAndDemo
from bellman_mpc_tpu.models import RangeDemo as RefRangeDemo
from bellman_mpc_tpu.models import RangeDemoExplicit as RefRangeDemoExplicit
from bellman_mpc_tpu_torch import groth16 as tg
from bellman_mpc_tpu_torch import interop
from bellman_mpc_tpu_torch.groth16 import prover as tpv
from bellman_mpc_tpu_torch.models import AndDemo, RangeDemo, RangeDemoExplicit
from bellman_mpc_tpu_torch.parallel import BatchProver

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

SETUP = dict(a=1, b=2, n=4, w=9, wArray=[0, 0, 0, 0], less_or_equal=1, less=1, not_all_zeros=1)


def range_witness(d: int) -> dict:
    """The chip gate's RangeDemo witness: a = 1 < b = 1 + d (d in 1..7)."""
    w = 8 + d
    return dict(a=1, b=1 + d, n=4, w=w, wArray=[(w >> i) & 1 for i in range(4)],
                less_or_equal=1, less=1, not_all_zeros=1)


CIRCUITS = {
    "AndDemo": dict(a=True, b=True),
    "RangeDemoExplicit": dict(range_witness(3), crArray=[1, 1, 1, 1]),
    "RangeDemo": range_witness(5),
}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_circuits_synthesize_like_reference(name):
    ref_cls = {"AndDemo": RefAndDemo, "RangeDemoExplicit": RefRangeDemoExplicit,
               "RangeDemo": RefRangeDemo}[name]
    port_cls = {"AndDemo": AndDemo, "RangeDemoExplicit": RangeDemoExplicit,
                "RangeDemo": RangeDemo}[name]
    ref = rpv.synthesize_witness(BLS12_381, ref_cls(**CIRCUITS[name]))
    port = tpv.synthesize_witness(tg.Bls12Engine("cpu"), port_cls(**CIRCUITS[name]))
    assert (port.a, port.b, port.c) == (ref.a, ref.b, ref.c)
    assert port.input_assignment == ref.input_assignment
    assert port.aux_assignment == ref.aux_assignment
    for dens in ("a_aux_density", "b_input_density", "b_aux_density"):
        assert getattr(port, dens).bv == getattr(ref, dens).bv, dens


@pytest.fixture(scope="module")
def range_setup():
    ref_params = generate_random_parameters(BLS12_381, RefRangeDemo(**SETUP))
    engine = tg.Bls12Engine("cpu")
    params = interop.params_from(ref_params)
    return SimpleNamespace(
        ref_params=ref_params, engine=engine, params=params,
        seq=tg.create_random_proof(engine, RangeDemo(**range_witness(1)), params),
    )


def test_sequential_proof_matches_reference(range_setup):
    want = create_random_proof(BLS12_381, RefRangeDemo(**range_witness(1)), range_setup.ref_params)
    assert range_setup.seq == interop.proof_from(want)
    assert tg.proof_to_bytes(range_setup.seq) == tg.proof_to_bytes(interop.proof_from(want))


def test_batch_prover_matches_sequential(range_setup):
    engine, params = range_setup.engine, range_setup.params
    bp = BatchProver(engine, params, RangeDemo(**range_witness(1)), msm_strategy="rns")
    assert (bp.m, bp.num_inputs, bp.num_aux) == (16, 2, 13)
    ds = [1, 6]
    proofs = bp.prove_batch([RangeDemo(**range_witness(d)) for d in ds])
    assert proofs[0] == range_setup.seq
    pvk = tg.prepare_verifying_key(engine, params.vk)
    for d, proof in zip(ds, proofs):
        tg.verify_proof(engine, pvk, proof, [1 + d])
