"""The port's group NTT (ops/group_ntt.py) and `_BlsGroup.intt` against the
reference, on the CPU.

* Raw limbs: the port's `group_ntt` on the same encoded points equals the
  reference's (a G1 iNTT of 8 points, a G2 forward NTT and its inverse on
  4 points).
* Decoded points: the G1 iNTT of [tau^i G] equals [L_j(tau) G] from the
  scalar inverse DFT (tests/test_group_ntt.py's oracle); the G2 round trip
  gives its input back.
* `_BlsGroup.intt` of a CPU engine equals `GroupAPI.intt`'s host
  butterflies at 4 points (the host route) and at 8 (the device route).
"""

import random

import jax
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.curves.device import g1_device as ref_g1
from bellman_mpc_tpu.curves.device import g2_device as ref_g2
from bellman_mpc_tpu.fields import bls12_381 as ref_bc
from bellman_mpc_tpu.ops import group_ntt as ref_group_ntt_module
from bellman_mpc_tpu.ops.group_ntt import group_ntt as ref_group_ntt
from bellman_mpc_tpu_torch.curves.device import g1_device, g2_device
from bellman_mpc_tpu_torch.curves.host import G1, G2
from bellman_mpc_tpu_torch.fields import bls12_381 as bc
from bellman_mpc_tpu_torch.groth16 import Bls12Engine, GroupAPI
from bellman_mpc_tpu_torch.ops.group_ntt import group_ntt
from tests.test_group_ntt import _scalar_intt_oracle

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

HOST = bc.fr_host


def _ref_ntt(group, pts, inverse):
    """The reference's group NTT under jit.  Its twiddle cache
    (`_stage_twiddle_bits`) keeps the arrays it built while tracing, so it
    is cleared before and after the call: a worker that also runs
    tests/test_group_ntt.py must not reuse another trace's values."""
    ref_group_ntt_module._stage_twiddle_bits.cache_clear()
    try:
        out = jax.jit(lambda p: ref_group_ntt(group.ops, ref_bc.fr_host, p, inverse=inverse))(pts)
        return tuple(np.asarray(x) for x in out)
    finally:
        ref_group_ntt_module._stage_twiddle_bits.cache_clear()


def _limbs(p):
    return tuple(x.numpy() for x in p)


def _assert_limbs_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


def _tau_points(n, seed):
    tau = random.Random(seed).randrange(2, HOST.p)
    powers = [pow(tau, i, HOST.p) for i in range(n)]
    return powers, [G1.mul(G1.generator, k) for k in powers]


def test_group_intt_g1_matches_reference_and_oracle():
    """A G1 iNTT of 8 points: raw limbs equal the reference's, decoded
    points equal L_j(tau) G."""
    powers, pts = _tau_points(8, 21)
    got = group_ntt(g1_device.ops, HOST, g1_device.encode_points(pts, "cpu"), inverse=True)
    _assert_limbs_equal(_limbs(got), _ref_ntt(ref_g1, ref_g1.encode_points(pts), True))
    lam = _scalar_intt_oracle(HOST, powers)
    assert g1_device.decode_points(got) == [G1.mul(G1.generator, k) for k in lam]


def test_group_ntt_roundtrip_g2_matches_reference():
    """A G2 NTT of 4 points and its inverse: raw limbs of both equal the
    reference's, and the round trip gives the input points back."""
    rng = random.Random(22)
    pts = [G2.mul(G2.generator, rng.randrange(1, HOST.p)) for _ in range(4)]
    fwd = group_ntt(g2_device.ops, HOST, g2_device.encode_points(pts, "cpu"))
    ref_fwd = _ref_ntt(ref_g2, ref_g2.encode_points(pts), False)
    _assert_limbs_equal(_limbs(fwd), ref_fwd)
    back = group_ntt(g2_device.ops, HOST, fwd, inverse=True)
    _assert_limbs_equal(_limbs(back), _ref_ntt(ref_g2, tuple(jax.numpy.asarray(x) for x in ref_fwd), True))
    assert g2_device.decode_points(back) == pts


@pytest.mark.parametrize("n", [4, 8])
def test_bls_group_intt_matches_host_butterflies(n):
    """_BlsGroup.intt on a CPU engine (host route at 4 points, device route
    at 8) equals GroupAPI.intt's host Cooley-Tukey on the same points."""
    eng = Bls12Engine("cpu")
    _, pts = _tau_points(n, 23 + n)
    assert eng.g1.intt(pts, HOST) == GroupAPI.intt(eng.g1, pts, HOST)
