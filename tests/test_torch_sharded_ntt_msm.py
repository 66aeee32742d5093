"""The port's sharded_ntt against the reference's on the conftest's
8-virtual-device CPU mesh (raw limbs, tolerance 0), and the three sharded
MSMs against the host oracle at the sizes of tests/test_sharded.py (16
bases, B = 2, c = 4), on CPU meshes (logical shards of the one CPU
device).  Apart from tests/test_torch_sharded.py because they take most
of its time: with fewer than six tests, xdist's loadfile queue (ordered
by test count) runs this file beside the reference's long
tests/test_batch_prover.py rather than before it."""

import random

import jax
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.fields.mock import mock as rmock
from bellman_mpc_tpu.parallel.mesh import make_mesh as ref_make_mesh
from bellman_mpc_tpu.parallel.sharded import sharded_ntt as ref_sharded_ntt
from bellman_mpc_tpu_torch.curves import host as chost
from bellman_mpc_tpu_torch.curves.device import g1_device, scalars_to_bits
from bellman_mpc_tpu_torch.fields.bls12_381 import R
from bellman_mpc_tpu_torch.fields.mock import mock, mock_host
from bellman_mpc_tpu_torch.ops.msm import digits_from_bits, signed_digits, window_tables, window_tables_affine
from bellman_mpc_tpu_torch.parallel import make_mesh
from bellman_mpc_tpu_torch.parallel.sharded import (
    BaseShards,
    sharded_msm,
    sharded_msm_table,
    sharded_msm_table_affine,
    sharded_ntt,
)

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

CPU8 = ["cpu"] * 8


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the conftest's 8-virtual-device CPU mesh")
def test_sharded_ntt_matches_reference_limbs():
    """Forward and inverse on a (2, 4) mesh at n = 64 over the mock field:
    the reference's raw limbs, and the inverse undoes the forward."""
    rng = random.Random(1)
    coeffs = [rng.randrange(mock_host.p) for _ in range(64)]
    ref_mesh = ref_make_mesh(8, shape=(2, 4))
    mesh = make_mesh(8, shape=(2, 4), devices=CPU8)
    x = mock.encode(coeffs)
    fwd = sharded_ntt(mesh, mock, mock_host, x)
    back = sharded_ntt(mesh, mock, mock_host, fwd, inverse=True)
    with ref_mesh:
        r_fwd = ref_sharded_ntt(ref_mesh, rmock, mock_host, rmock.encode(coeffs))
        r_back = ref_sharded_ntt(ref_mesh, rmock, mock_host, r_fwd, inverse=True)
    assert np.array_equal(np.asarray(r_fwd), fwd.numpy())
    assert np.array_equal(np.asarray(r_back), back.numpy())
    assert mock.decode(back) == coeffs


@pytest.fixture(scope="module")
def msm_case():
    """16 G1 bases (k + 3) G, two proofs' scalars and their host-oracle
    MSMs, (sum_k s_k (k + 3)) G: what chost.G1.msm gives, in one host
    multiplication."""
    rng = random.Random(3)
    n, B = 16, 2
    G = chost.G1.generator
    bases = [chost.G1.mul(G, k + 3) for k in range(n)]
    scalars = [[rng.randrange(R) for _ in range(n)] for _ in range(B)]
    bits = torch.stack([scalars_to_bits(s, 255) for s in scalars], dim=1)
    want = [chost.G1.mul(G, sum(s * (k + 3) for k, s in enumerate(row)) % R) for row in scalars]
    return g1_device.encode_points(bases, "cpu"), bits, want


def _check(out, want):
    assert all(x.shape[-2:] == (len(want), 1) for x in out)
    got = g1_device.decode_points(tuple(x[..., 0] for x in out))
    assert all(chost.G1.eq(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("kind,shape", [("ladder", (1, 2)), ("table", (2, 2)), ("table_affine", (2, 2))])
def test_sharded_msm_matches_host(msm_case, kind, shape):
    """The ladder on a (1, 2) mesh, the gather-table MSMs (c = 4) on
    (2, 2), the affine one over tables placed once (BaseShards).  Each
    logical shard's work runs in turn on the CPU, at a cost that does not
    shrink with its slice (a ladder is 255 sequential doublings), so the
    meshes are small; the (2, 4) mesh and a two-step butterfly run in the
    NTT test above and the (1, 4) mesh case of tests/test_torch_opt_ins.py."""
    pts, bits, want = msm_case
    mesh = make_mesh(shape[0] * shape[1], shape=shape, devices=CPU8)
    c = 4
    if kind == "ladder":
        out = sharded_msm(mesh, g1_device.ops, pts, bits)
    elif kind == "table":
        out = sharded_msm_table(mesh, g1_device.ops, window_tables(g1_device.ops, pts, c), digits_from_bits(bits, c))
    else:
        tables = BaseShards(mesh, window_tables_affine(g1_device.ops, pts, c))
        out = sharded_msm_table_affine(mesh, g1_device.ops, tables, signed_digits(digits_from_bits(bits, c), c))
    _check(out, want)
