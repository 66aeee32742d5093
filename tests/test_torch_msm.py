"""The port's RNS window-fold MSM (ops/msm.py, padded tables, plain fold
kernels on the CPU) vs the host MSM oracle at n=4, B=2, c=4 on G1 and G2,
plus the scalar-digit helpers vs the reference (tolerance 0)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.curves import host as chost
from bellman_mpc_tpu.ops import msm as rmsm
from bellman_mpc_tpu_torch.curves import device as tdev
from bellman_mpc_tpu_torch.curves import rns_point as trp
from bellman_mpc_tpu_torch.fields import bls12_381 as tbc
from bellman_mpc_tpu_torch.fields.bls12_381 import R
from bellman_mpc_tpu_torch.ops import fold_kernels as fk
from bellman_mpc_tpu_torch.ops import msm as tmsm

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers


def test_digits_match_reference():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(255, 2, 4)).astype(np.int32)
    for c in (4, 8):
        rd = rmsm.digits_from_bits(jnp.asarray(bits), c)
        td = tmsm.digits_from_bits(torch.from_numpy(bits), c)
        assert np.array_equal(np.asarray(rd), td.numpy())
        assert np.array_equal(np.asarray(rmsm.signed_digits(rd, c)), tmsm.signed_digits(td, c).numpy())
    assert [tmsm.pick_table_c(n, g2) for n in (512, 1024) for g2 in (False, True)] == [
        rmsm.pick_table_c(n, g2) for n in (512, 1024) for g2 in (False, True)]


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_msm_table_affine_rns_vs_host(g2):
    rng = random.Random(5)
    hostg, dev, rops = (
        (chost.G2, tdev.g2_device, trp.rns_g2_ops()) if g2 else (chost.G1, tdev.g1_device, trp.rns_g1_ops())
    )
    n, B, c = 4, 2, 4
    bases = [hostg.mul(hostg.generator, rng.randrange(2, 500)) for _ in range(n)]
    bases[2] = None  # an identity base: its bucket rows are (0, 0) sentinels
    tab = tmsm.window_tables_affine(dev.ops, dev.encode_points(bases, "cpu"), c)
    rt, bound = tmsm.tables_to_rns(rops, tbc.fp, tab)
    rtp = fk.pad_rns_table(trp.default_rns_field(), rt)
    scal = [[rng.randrange(R) for _ in range(n)] for _ in range(B)]
    bits = torch.stack([tdev.scalars_to_bits(s, 255) for s in scal], dim=1)
    sd = tmsm.signed_digits(tmsm.digits_from_bits(bits, c), c)
    out = tmsm.msm_table_affine_rns(rops, tbc.fp, rtp, sd, bound)
    got = dev.decode_points(tuple(x[..., 0] for x in out))
    for b in range(B):
        want = hostg.msm([p for p in bases if p is not None],
                         [s for p, s in zip(bases, scal[b]) if p is not None])
        assert hostg.eq(got[b], want)


def test_batch_mul_host_ladder():
    rng = random.Random(6)
    g = chost.G1.generator
    exps = [rng.randrange(R) for _ in range(5)]
    got = tmsm.batch_mul_host(tdev.g1_device, g, exps, "cpu")
    assert got == [chost.G1.mul(g, e) for e in exps]
