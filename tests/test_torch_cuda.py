"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither jax nor the reference, so it runs on the GPU machine:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

Every test here needs a CUDA card and skips without one.  Lane counts that
are not a multiple of the RNS kernels' 8-lane tile or the limb multiply's
256-thread block exercise the ragged edge; "wave+1" is one lane past a full
wave of the kernel's own persistent blocks (K1, K2: 8-lane tiles, K3: units
of 6 tiles), so one block takes a second, ragged unit.
"""

import random
from fractions import Fraction

import pytest
import torch

from bellman_mpc_tpu_torch.curves import rns_point as rpt
from bellman_mpc_tpu_torch.fields.bls12_381 import fp, fr
from bellman_mpc_tpu_torch.fields.mock import mock
from bellman_mpc_tpu_torch.ops import fold_kernels as fk
from bellman_mpc_tpu_torch.ops import kernel_lib
from bellman_mpc_tpu_torch.ops.mont_kernels import mont_mul

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

F = rpt.default_rns_field()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU machine")
    return torch.device("cuda", 0)


def _tile(rng, n, dev, zero_cols=()):
    t = fk.rns_pad_rows(F, F.encode([rng.randrange(F.p) for _ in range(n)], device=dev).res)
    t[:, list(zero_cols)] = 0
    return t.contiguous()


def _lanes(lanes, wave=fk.fold_wave_lanes):
    return wave() + 1 if lanes == "wave+1" else lanes


TC_LANES = [13, 256, 257, "wave+1"]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", TC_LANES)
def test_k3_matches_plain(dev, lanes):
    lanes = _lanes(lanes, fk.rns_mul_wave_lanes)
    rng = random.Random(lanes)
    x, y = _tile(rng, lanes, dev, [0, lanes - 1]), _tile(rng, lanes, dev)
    before = kernel_lib.launch_counts["rns_mul_many"]
    got = fk.rns_mul_many(F, fk.rns_unpad_rows(F, x), fk.rns_unpad_rows(F, y))
    assert torch.equal(fk.rns_pad_rows(F, got), fk.rns_mul_block_plain(F, x, y))
    assert kernel_lib.launch_counts["rns_mul_many"] == before + 1


def _k1_inputs(rng, lanes, dev):
    q = (_tile(rng, lanes, dev, [0, 5, lanes - 1]), _tile(rng, lanes, dev, [0, 7, lanes - 1]))
    sg = torch.tensor([rng.randrange(2) == 1 for _ in range(lanes)], device=dev)
    return q, sg


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", TC_LANES)
def test_k1_matches_plain(dev, lanes):
    lanes = _lanes(lanes)
    rng = random.Random(lanes + 1)
    acc = tuple(_tile(rng, lanes, dev) for _ in range(3))
    q, sg = _k1_inputs(rng, lanes, dev)
    got = fk.rns_fold_window(F, 12, acc, q, sg, Fraction(37), Fraction(fk.G1_CAP))
    want = fk.fold_window_g1_plain(F, 12, acc, q[0], q[1], sg.to(torch.int32), 37, fk.G1_CAP)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fk.launch_counts["rns_fold_window"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [257, "wave+1"])
def test_k1_chained_windows(dev, lanes):
    """Three windows, each kernel output the next window's accumulator."""
    lanes = _lanes(lanes)
    rng = random.Random(lanes + 3)
    acc = want = tuple(_tile(rng, lanes, dev) for _ in range(3))
    for _ in range(3):
        q, sg = _k1_inputs(rng, lanes, dev)
        acc = fk.rns_fold_window(F, 12, acc, q, sg, Fraction(37), Fraction(fk.G1_CAP))
        want = fk.fold_window_g1_plain(F, 12, want, q[0], q[1], sg.to(torch.int32), 37, fk.G1_CAP)
        assert all(torch.equal(g, w) for g, w in zip(acc, want))


def _fp2_tile(rng, lanes, dev, zero_cols=(), zero_c1=()):
    """(80, 2, lanes): both components zero at zero_cols, component 1 alone
    at zero_c1."""
    c1 = list(zero_cols) + list(zero_c1)
    return torch.stack([_tile(rng, lanes, dev, zero_cols), _tile(rng, lanes, dev, c1)], dim=1)


def _k2_inputs(rng, lanes, dev):
    """Gathered points with the (0, 0) sentinel at the first and last lanes,
    and lanes that are zero only in part, which are not the sentinel: lane 4
    with x1 = y1 = 0 (x0, y0 nonzero), lane 5 with x = 0."""
    qx = _fp2_tile(rng, lanes, dev, [0, 5, lanes - 1], [4])
    qy = _fp2_tile(rng, lanes, dev, [0, lanes - 1], [4])
    sg = torch.tensor([rng.randrange(2) == 1 for _ in range(lanes)], device=dev)
    return (qx, qy), sg


def _k2_plain(acc, q, sg):
    return fk.fold_window_g2_plain_stacked(F, 12, acc, q, sg, 37, fk.G2_CAP)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", TC_LANES)
def test_k2_matches_plain(dev, lanes):
    lanes = _lanes(lanes, fk.fold_g2_wave_lanes)
    rng = random.Random(lanes + 2)
    acc = tuple(_fp2_tile(rng, lanes, dev) for _ in range(3))
    q, sg = _k2_inputs(rng, lanes, dev)
    before = kernel_lib.launch_counts["rns_fold_window_g2"]
    got = fk.rns_fold_window_g2(F, 12, acc, q, sg, Fraction(37), Fraction(fk.G2_CAP))
    assert all(torch.equal(g, w) for g, w in zip(got, _k2_plain(acc, q, sg)))
    assert kernel_lib.launch_counts["rns_fold_window_g2"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [257, "wave+1"])
def test_k2_chained_windows(dev, lanes):
    """Three windows, each kernel output the next window's accumulator."""
    lanes = _lanes(lanes, fk.fold_g2_wave_lanes)
    rng = random.Random(lanes + 4)
    acc = want = tuple(_fp2_tile(rng, lanes, dev) for _ in range(3))
    for _ in range(3):
        q, sg = _k2_inputs(rng, lanes, dev)
        acc = fk.rns_fold_window_g2(F, 12, acc, q, sg, Fraction(37), Fraction(fk.G2_CAP))
        want = _k2_plain(want, q, sg)
        assert all(torch.equal(g, w) for g, w in zip(acc, want))


@pytest.mark.cuda
def test_wrappers_reject_bad_tiles(dev):
    x = torch.zeros((fk.PAD_C, 8), dtype=torch.int32, device=dev)
    sg = torch.zeros(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):  # int64 tiles
        fk.rns_fold_window(F, 12, (x.long(),) * 3, (x, x), sg, Fraction(37), Fraction(128))
    x2 = torch.zeros((fk.PAD_C, 8, 2), dtype=torch.int32, device=dev).transpose(1, 2)
    with pytest.raises(ValueError):  # (80, 2, lanes) views K2 would have to copy
        fk.rns_fold_window_g2(F, 12, (x2,) * 3, (x2,) * 2, sg, Fraction(37), Fraction(256))


def _limbs(f, vals, dev):
    return torch.tensor([[(v >> (11 * i)) & 2047 for v in vals] for i in range(f.L)],
                        dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [13, 257])
@pytest.mark.parametrize("f", [mock, fp, fr], ids=["mock", "Fp", "Fr"])
def test_k4_matches_plain(dev, f, lanes):
    rng = random.Random(f.L * 1000 + lanes)
    near_2p = [2 * f.p - 1 - rng.randrange(1 << 8) for _ in range(lanes // 2)]
    va = near_2p + [rng.randrange(2 * f.p) for _ in range(lanes - len(near_2p))]
    vb = [rng.randrange(2 * f.p) for _ in range(lanes - 1)] + [2 * f.p - 1]
    a, b = _limbs(f, va, dev), _limbs(f, vb, dev)
    before = kernel_lib.launch_counts["mont_mul"]
    got = mont_mul(f, a, b)
    torch.cuda.synchronize()
    assert kernel_lib.launch_counts["mont_mul"] == before + 1
    assert torch.equal(got, f.mul(a, b))  # the plain version


@pytest.mark.cuda
def test_k4_rejects_strided_input(dev):
    x = torch.zeros((fr.L, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        mont_mul(fr, x[:, ::2], x[:, ::2])
