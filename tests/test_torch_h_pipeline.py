"""The port's h(x) pipeline and NTT vs groth16.prover._h_pipeline and
ops/domain.ntt of the reference at exp=4 (raw limbs, tolerance 0)."""

import random

import numpy as np
import pytest
import torch

from bellman_mpc_tpu.fields.bls12_381 import fr as rfr
from bellman_mpc_tpu.fields.bls12_381 import fr_host
from bellman_mpc_tpu.groth16 import prover as rpv
from bellman_mpc_tpu.ops import domain as rdom
from bellman_mpc_tpu_torch.fields.bls12_381 import fr as tfr
from bellman_mpc_tpu_torch.groth16 import prover as tpv
from bellman_mpc_tpu_torch.ops import domain as tdom

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

EXP = 4


def _vals(seed, n=1 << EXP):
    rng = random.Random(seed)
    return [rng.randrange(fr_host.p) for _ in range(n)]


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_reference(inverse):
    v = _vals(1)
    r = rdom.ntt(rfr, fr_host, rfr.encode(v), inverse=inverse)
    t = tdom.ntt(tfr, fr_host, tfr.encode(v), inverse=inverse)
    assert np.array_equal(np.asarray(r), t.numpy())


def test_evaluation_domain_ifft():
    v = _vals(2, 10)
    rd = rdom.EvaluationDomain.from_coeffs(rfr, fr_host, v)
    td = tdom.EvaluationDomain.from_coeffs(tfr, fr_host, v, "cpu")
    rd.ifft()
    td.ifft()
    assert td.into_coeffs() == rd.into_coeffs()


def test_h_pipeline_matches_reference_batched():
    """Two proofs' (a, b, c) through the reference pipeline one by one and
    through the port's batched pipeline at once."""
    abc = [[_vals(10 * i + j) for j in range(3)] for i in range(2)]
    want = [np.asarray(rpv._h_pipeline(rfr, fr_host, EXP)(*(rfr.encode(x) for x in p))) for p in abc]
    stacked = [torch.stack([tfr.encode(p[j]) for p in abc], dim=1) for j in range(3)]
    got = tpv._h_pipeline(tfr, fr_host, EXP)(*stacked)
    for i in range(2):
        assert np.array_equal(want[i], got[:, i].numpy())
