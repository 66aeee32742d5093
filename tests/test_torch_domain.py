"""The port's EvaluationDomain (ops/domain.py) against the reference's at
domain 16 on Fr and the mock field: every method's raw limbs at tolerance 0,
`z` and the length; `from_device` pads to the domain."""

import random

import numpy as np
import pytest
import torch

from bellman_mpc_tpu.fields.bls12_381 import fr as rfr
from bellman_mpc_tpu.fields.bls12_381 import fr_host
from bellman_mpc_tpu.fields.mock import mock as rmock
from bellman_mpc_tpu.fields.mock import mock_host
from bellman_mpc_tpu.ops import domain as rdom
from bellman_mpc_tpu_torch.fields.bls12_381 import fr as tfr
from bellman_mpc_tpu_torch.fields.mock import mock as tmock
from bellman_mpc_tpu_torch.ops import domain as tdom

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers


@pytest.mark.parametrize("rf,tf,host", [(rmock, tmock, mock_host), (rfr, tfr, fr_host)],
                         ids=["mock", "fr"])
def test_evaluation_domain_matches_reference(rf, tf, host):
    rng = random.Random(31)
    vals = [[rng.randrange(host.p) for _ in range(13)] for _ in range(3)]
    ref = [rdom.EvaluationDomain.from_coeffs(rf, host, v) for v in vals]
    port = [tdom.EvaluationDomain.from_coeffs(tf, host, v, "cpu") for v in vals]
    port[2] = tdom.EvaluationDomain.from_device(tf, host, tf.encode(vals[2]))

    def same():
        for r, t in zip(ref, port):
            assert len(t) == len(r) == 16 and t.exp == r.exp
            assert np.array_equal(np.asarray(r.coeffs), t.coeffs.numpy())

    same()
    # every method on the first domain; the reference jits each transform anew
    for name, args in (("fft", ()), ("ifft", ()), ("distribute_powers", (7,)), ("coset_fft", ()),
                       ("icoset_fft", ()), ("coset_fft", ())):
        for d in (ref[0], port[0]):
            getattr(d, name)(*args)
        same()
    for r, t in zip(ref[1:], port[1:]):
        r.coset_fft()
        t.coset_fft()
    same()
    for d, e, f in (ref, port):
        d.mul_assign(e)
        d.sub_assign(f)
        d.divide_by_z_on_coset()
    same()
    assert port[0].z(12345) == ref[0].z(12345) == (pow(12345, 16, host.p) - 1) % host.p
    assert port[0].into_coeffs() == ref[0].into_coeffs()
