"""The port's mesh and sharded functions on CPU meshes (logical shards of
the one CPU device, as XLA's virtual devices are): make_mesh's shape rule
and refusals, the butterfly's power-of-two check, and _h_pipeline_sharded
against _h_pipeline on a batched input (raw limbs).  sharded_ntt against
the reference and the sharded MSMs against the host oracle are in
tests/test_torch_sharded_ntt_msm.py."""

import random

import pytest
import torch

from bellman_mpc_tpu_torch.curves import host as chost
from bellman_mpc_tpu_torch.curves.device import g1_device
from bellman_mpc_tpu_torch.fields.bls12_381 import fr, fr_host
from bellman_mpc_tpu_torch.groth16.prover import _h_pipeline, _h_pipeline_sharded
from bellman_mpc_tpu_torch.parallel import make_mesh
from bellman_mpc_tpu_torch.parallel.mesh import base_shard_spec, proof_batch_spec
from bellman_mpc_tpu_torch.parallel.sharded import shard_batch_inputs, sharded_msm

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("n,shape,want", [(1, None, (1, 1)), (2, None, (2, 1)), (4, None, (2, 2)),
                                          (6, None, (3, 2)), (8, None, (4, 2)), (8, (2, 4), (2, 4))])
def test_make_mesh_shape_rule(n, shape, want):
    mesh = make_mesh(n, shape=shape, devices=CPU8)
    assert mesh.shape == {"data": want[0], "model": want[1]}
    assert mesh.lead == torch.device("cpu") and len(mesh.grid) == want[0]


def test_make_mesh_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh(4, shape=(3, 1), devices=CPU8)
    with pytest.raises(RuntimeError, match="available"):
        make_mesh(4, devices=["cpu"] * 2)
    assert proof_batch_spec() == (None, "data") and base_shard_spec() == (None, "model")
    with pytest.raises(ValueError, match="divide"):
        shard_batch_inputs(make_mesh(4, devices=CPU8), (torch.zeros(3, 4),), batch_axis=0)


def test_butterfly_refuses_non_power_of_two():
    """A (1, 3) mesh over 48 bases: every block divides, so only the
    butterfly's check can fire, and it fires before any shard's work."""
    mesh = make_mesh(3, shape=(1, 3), devices=CPU8)
    pts = g1_device.encode_points([chost.G1.generator] * 48, "cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        sharded_msm(mesh, g1_device.ops, pts, torch.zeros(255, 2, 48, dtype=torch.int32))
    with pytest.raises(ValueError, match="divide"):
        sharded_msm(make_mesh(2, shape=(1, 2), devices=CPU8), g1_device.ops, pts,
                    torch.zeros(255, 2, 47, dtype=torch.int32))


@pytest.mark.parametrize("shape", [(2, 4), (1, 1)])
def test_h_pipeline_sharded_matches_local(shape):
    """Two proofs' (a, b, c) at exp = 5: the same raw limbs as _h_pipeline."""
    exp = 5
    rng = random.Random(5)
    abc = [fr.encode([rng.randrange(fr_host.p) for _ in range(2 << exp)]).reshape(fr.L, 2, 1 << exp)
           for _ in range(3)]
    mesh = make_mesh(shape[0] * shape[1], shape=shape, devices=CPU8)
    assert torch.equal(_h_pipeline_sharded(fr, fr_host, exp, mesh)(*abc), _h_pipeline(fr, fr_host, exp)(*abc))
