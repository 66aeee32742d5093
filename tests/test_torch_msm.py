"""The port's MSMs (ops/msm.py) on the CPU against the host MSM oracle: the
RNS window fold (padded tables, plain fold kernels) at n=4, B=2, c=4 on G1
and G2; the limb strategies (bucket method, flat bucket pass, projective and
affine tables) at n=16, B=2, c=4 with an identity base and duplicate
digits; the comb and the host-facing MSM under their opt-in variables; plus
the scalar-digit helpers vs the reference (tolerance 0)."""

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


def _msm_case(hostg, dev, seed, n=16, B=2, c=4):
    """n bases (one the identity), B scalar sets (duplicate digits, 0 and
    R - 1 among them), the encoded bases, window digits and the oracle's
    answers."""
    rng = random.Random(seed)
    bases = [hostg.mul(hostg.generator, rng.randrange(2, 500)) for _ in range(n)]
    bases[3] = None
    scal = [[rng.randrange(R) for _ in range(n)] for _ in range(B)]
    scal[0][:8] = [7] * 8
    scal[0][8:12] = [255] * 4
    scal[1][0], scal[1][1] = 0, R - 1
    bits = torch.stack([tdev.scalars_to_bits(s, 255) for s in scal], dim=1)
    want = [hostg.msm([p for p in bases if p is not None], [s for p, s in zip(bases, sc) if p is not None])
            for sc in scal]
    return dev.encode_points(bases, "cpu"), tmsm.digits_from_bits(bits, c), want


def _assert_points(hostg, dev, out, want):
    got = dev.decode_points(tuple(x[..., 0] for x in out))
    assert len(got) == len(want) and all(hostg.eq(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_msm_pippenger_batched_vs_host(g2):
    hostg, dev = (chost.G2, tdev.g2_device) if g2 else (chost.G1, tdev.g1_device)
    pts, digits, want = _msm_case(hostg, dev, 11)
    _assert_points(hostg, dev, tmsm.msm_pippenger_batched(dev.ops, pts, digits, 4), want)


@pytest.fixture(scope="module")
def g1_case():
    """_msm_case on G1 (seed 12), shared by the limb MSM cases."""
    return _msm_case(chost.G1, tdev.g1_device, 12)


@pytest.mark.parametrize("kind", ["pippenger", "flatpip", "table", "table_affine"])
def test_limb_msms_vs_host(g1_case, kind):
    """msm_pippenger (one scalar set), msm_flat_pippenger over shifted bases,
    msm_table over projective tables and msm_table_affine over affine tables
    with signed digits, on G1."""
    hostg, dev = chost.G1, tdev.g1_device
    ops, c = dev.ops, 4
    pts, digits, want = g1_case
    if kind == "pippenger":
        out = tmsm.msm_pippenger(ops, pts, digits[:, 0], c)
        assert hostg.eq(dev.decode_points(out)[0], want[0])
        return
    if kind == "flatpip":
        out = tmsm.msm_flat_pippenger(ops, tmsm.shifted_bases(ops, pts, c), digits, c)
    elif kind == "table":
        out = tmsm.msm_table(ops, tmsm.window_tables(ops, pts, c), digits)
    else:
        out = tmsm.msm_table_affine(ops, tmsm.window_tables_affine(ops, pts, c),
                                    tmsm.signed_digits(digits, c))
    _assert_points(hostg, dev, out, want)


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_comb_matches_host_and_ladder(g2, monkeypatch):
    """batch_mul_host under BMT_FIXED_BASE=comb (batch_mul_comb_host) on
    tests/test_comb.py's exponents against the host multiply, and against
    batch_mul_host's default, the ladder."""
    rng = random.Random(22 if g2 else 21)
    if g2:
        hostg, dev = chost.G2, tdev.g2_device
        base = hostg.mul(hostg.generator, 999)
        exps = [1, rng.randrange(R), 2, 0]
    else:
        hostg, dev = chost.G1, tdev.g1_device
        base = hostg.mul(hostg.generator, 12345)
        exps = [0, 1, 2, R - 1, rng.randrange(R), rng.randrange(R), 7]
    monkeypatch.setenv("BMT_FIXED_BASE", "comb")
    got = tmsm.batch_mul_host(dev, base, exps, "cpu")
    assert got == [hostg.mul(base, e) for e in exps]
    monkeypatch.delenv("BMT_FIXED_BASE")
    small = [i for i, e in enumerate(exps) if e < 8]  # a short ladder
    assert tmsm.batch_mul_host(dev, base, [exps[i] for i in small], "cpu") == [got[i] for i in small]


def test_msm_host_pippenger_matches_default(monkeypatch):
    """msm_host under BMT_MSM_STRATEGY=pippenger (64 bases, its threshold:
    msm_pippenger_host at c = 8) equals its default, the ladder."""
    rng = random.Random(23)
    g = chost.G1.generator
    bases = [chost.G1.mul(g, rng.randrange(1, 1000)) for _ in range(64)]
    scalars = [rng.randrange(R) for _ in range(64)]
    scalars[:6] = [0, 1, R - 1, 5, 5, 5]
    default = tmsm.msm_host(tdev.g1_device, bases, scalars, "cpu")
    monkeypatch.setenv("BMT_MSM_STRATEGY", "pippenger")
    assert chost.G1.eq(tmsm.msm_host(tdev.g1_device, bases, scalars, "cpu"), default)
