"""Fold kernels: the plain PyTorch K3/K1/K2 vs the reference's Pallas
kernels (run in interpret mode on the CPU, as tests/test_pallas.py runs
them), bit-exact, with (0, 0) sentinels and negative signs mixed in.  The
CUDA kernels against the plain versions are in tests/test_torch_cuda.py."""

import random
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.curves import rns_point as rrp
from bellman_mpc_tpu.ops import pallas_kernels as pk
from bellman_mpc_tpu_torch import interop
from bellman_mpc_tpu_torch.curves import rns_point as trp
from bellman_mpc_tpu_torch.ops import fold_kernels as fk

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

RF, TF = rrp.default_rns_field(), trp.default_rns_field()
N = 16


def _tile(rng, zero_cols=()):
    v = np.asarray(pk.rns_pad_rows(RF, RF.encode([rng.randrange(RF.p) for _ in range(N)]).res)).copy()
    v[:, list(zero_cols)] = 0
    return v


_t = interop.tensor


def test_pad_layout():
    x = RF.encode(list(range(1, N + 1))).res
    padded = fk.rns_pad_rows(TF, _t(x))
    assert np.array_equal(np.asarray(pk.rns_pad_rows(RF, x)), padded.numpy())
    assert np.array_equal(fk.rns_unpad_rows(TF, padded).numpy(), np.asarray(x))


def test_k3_plain_matches_pallas():
    rng = random.Random(1)
    a = RF.encode([rng.randrange(RF.p) for _ in range(N)]).res
    b = RF.encode([rng.randrange(RF.p) for _ in range(N)]).res
    want = np.asarray(pk.rns_mul_many_pallas(RF, a, b))
    assert np.array_equal(want, fk.rns_mul_many(TF, _t(a), _t(b)).numpy())


def test_k1_plain_matches_pallas():
    rng = random.Random(2)
    acc = [_tile(rng) for _ in range(3)]
    q = [_tile(rng, [1, 5]), _tile(rng, [1, 6])]  # lane 1: the (0, 0) sentinel
    sg = np.array([i % 3 == 0 for i in range(N)])
    args = (Fraction(37), Fraction(128))
    want = pk.rns_fold_window_pallas(
        RF, 12, tuple(map(jnp.asarray, acc)), tuple(map(jnp.asarray, q)), jnp.asarray(sg), *args)
    got = fk.rns_fold_window(TF, 12, tuple(map(_t, acc)), tuple(map(_t, q)), _t(sg), *args)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert np.array_equal(got[0][:, 1].numpy(), acc[0][:, 1])  # sentinel keeps acc


def test_k2_plain_matches_pallas():
    rng = random.Random(3)
    acc = [np.stack([_tile(rng), _tile(rng)], 1) for _ in range(3)]
    q = [np.stack([_tile(rng, [2]), _tile(rng, [2, 9])], 1) for _ in range(2)]
    sg = np.array([i % 2 == 1 for i in range(N)])
    args = (Fraction(37), Fraction(256))
    want = pk.rns_fold_window_pallas_g2(
        RF, 12, tuple(map(jnp.asarray, acc)), tuple(map(jnp.asarray, q)), jnp.asarray(sg), *args)
    got = fk.rns_fold_window_g2(TF, 12, tuple(map(_t, acc)), tuple(map(_t, q)), _t(sg), *args)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("g2,count", [(False, fk.G1_NUM_K), (True, fk.G2_NUM_K)], ids=["G1", "G2"])
def test_schedule_matches_kernel_consumption(g2, count):
    """The host replay yields exactly as many K values as the kernel reads."""
    ks = fk.fold_schedule(TF, 12, 37, 256 if g2 else 128, g2)
    assert len(ks) == count and all(k >= 1 for k in ks)


def test_wrappers_reject_other_devices():
    x = torch.zeros((TF.C, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fk.rns_mul_many(TF, x, x)


def test_ext_tables_match_w():
    """K1/K3's padded float64 extension tables hold W1/W2 exactly (zeros in
    the padding), the fragment order maps back to them, and every extension
    sum stays below 2^30, where float64 is exact."""
    W = fk.ext_tables_np(TF)
    k = TF.k
    assert W.shape == (2, fk.EXT_T, fk.EXT_S) and W.dtype == np.float64
    for w, ref in zip(W, (TF.W1_np, TF.W2_np)):
        assert np.array_equal(w[: k + 1, :k], ref.astype(np.float64))
        assert not w[k + 1 :].any() and not w[:, k:].any()
    frag = fk.ext_fragments_np(TF).reshape(2, fk.EXT_T // 8, fk.EXT_S // 4, 32)
    lane = np.arange(32)
    for t in range(fk.EXT_T // 8):
        for s in range(fk.EXT_S // 4):
            assert np.array_equal(frag[:, t, s], W[:, 8 * t + lane // 4, 4 * s + lane % 4])
    assert k * (max(TF.moduli) - 1) ** 2 < 1 << 30


def test_kernel_consts_layout():
    """The kernels' constant block is `Consts` of csrc/fold_kernels.cu word
    for word: per padded row m, floor(2^32 / m), kappa, M^-1, (M'/m'_j)^-1
    and M' mod m, then m_r and M'^-1 mod m_r."""
    words = fk.kernel_consts_np(TF).view(np.uint32).astype(np.int64)
    assert words.shape == (6 * fk.PAD_C + 2,)
    m, mu, kappa, minv, ifac2, mpmod = words[: 6 * fk.PAD_C].reshape(6, fk.PAD_C)
    k, B = TF.k, fk.PAD_B
    hi = B + np.arange(k + 1)  # B' rows, then m_r
    assert np.array_equal(m[np.r_[np.arange(k), hi]], np.asarray(TF.moduli, np.int64))
    assert np.all(np.delete(m, np.r_[np.arange(k), hi]) == 1)  # pad rows
    assert np.array_equal(mu, np.minimum((1 << 32) // m, (1 << 32) - 1))
    assert np.array_equal(kappa[:k], TF.kappa_np[:k]) and not kappa[k:].any()
    assert np.array_equal(minv[hi], TF.minv_np[k:]) and not np.delete(minv, hi).any()
    assert np.array_equal(ifac2[hi[:k]], TF.ifac2_np[k : 2 * k]) and not np.delete(ifac2, hi[:k]).any()
    assert np.array_equal(mpmod[:k], TF.mp_mod_np[:k]) and not mpmod[k:].any()
    assert list(words[6 * fk.PAD_C :]) == [TF.mr, TF.mpinv_mr]


# ------------------------------------------------- the tree reduction's level


def _rand_res(rng, shape):
    n = int(np.prod(shape))
    return TF.encode([rng.randrange(TF.p) for _ in range(n)]).res.reshape((TF.C,) + tuple(shape))


def _ops_cap(g2):
    return (trp.rns_g2_ops(), fk.G2_CAP) if g2 else (trp.rns_g1_ops(), fk.G1_CAP)


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_tree_schedule_matches_formula(g2, monkeypatch):
    """The K sequence the tree kernel is handed is the one rpt.point_add
    over RnsField takes at input bounds (cap, cap) (a stacked G2 sub once
    per component, as the kernel consumes them), as long as the kernel
    reads, and the formula maps the cap into itself."""
    ops, cap = _ops_cap(g2)
    b = ops.b3c if g2 else ops.b3
    ks, real = [], TF.kp_table

    def recording(K, like):  # add_fixpoint's one lane: (C, 1), or (C, 2, 1) stacked
        comps = {(TF.C, 1): 1, (TF.C, 2, 1): 2}[tuple(like.shape)]
        ks.extend([K] * comps)
        return real(K, like)

    monkeypatch.setattr(TF, "kp_table", recording)
    assert trp.add_fixpoint(ops, Fraction(cap)) <= cap
    assert fk.tree_schedule(TF, b, cap, g2) == tuple(ks)
    assert len(ks) == (fk.G2_TREE_NUM_K if g2 else fk.G1_TREE_NUM_K) and all(k >= 1 for k in ks)


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_tree_level_plain_matches_point_add(g2):
    """One padded level (outer 3, n = 8) equals rpt.point_add over RnsField
    on the two halves: the same residues, so the same decoded points."""
    rng = random.Random(30 + g2)
    ops, cap = _ops_cap(g2)
    lead = (2,) if g2 else ()
    pts = [_rand_res(rng, lead + (3, 8)) for _ in range(3)]
    got = fk.rns_tree_level(TF, ops.b3c if g2 else ops.b3, tuple(fk.rns_pad_rows(TF, t) for t in pts), cap, g2)
    p, q = (tuple(ops.wrap(t[..., s], Fraction(cap)) for t in pts) for s in (slice(0, 4), slice(4, 8)))
    want = trp.point_add(ops, p, q)
    for g, w in zip(got, want):
        assert g.shape == (fk.PAD_C,) + lead + (3, 4)
        assert torch.equal(fk.rns_unpad_rows(TF, g), w.res)
        assert TF.decode(trp.RnsVal(TF, fk.rns_unpad_rows(TF, g), w.a)) == TF.decode(w)


@pytest.mark.parametrize("g2,seg_sizes", [(False, None), (True, None), (False, (4, 4, 8, 2, 2))],
                         ids=["G1", "G2", "G1-segments"])
def test_fold_reduce_matches_tree_reduce(g2, seg_sizes):
    """msm._rns_fold_reduce on the padded accumulator gives the limb points
    of the aten route it replaced: unpad, rpt.tree_reduce (per segment),
    the bridge."""
    from bellman_mpc_tpu_torch.fields.bls12_381 import fp
    from bellman_mpc_tpu_torch.ops import msm

    rng = random.Random(40 + g2)
    ops, cap = _ops_cap(g2)
    lead = (2,) if g2 else ()
    n = sum(seg_sizes) if seg_sizes else 16
    acc = [_rand_res(rng, lead + (2, n)) for _ in range(3)]
    got = msm._rns_fold_reduce(ops, fp, tuple(fk.rns_pad_rows(TF, t) for t in acc), Fraction(cap), seg_sizes)
    parts, off = [], 0
    for n_s in seg_sizes or (n,):
        red = trp.tree_reduce(ops, tuple(ops.wrap(t[..., off : off + n_s], Fraction(cap)) for t in acc), cap)
        parts.append(red)
        off += n_s
    want = trp.rns_point_to_limb(ops, TF, fp, tuple(
        ops.wrap(torch.cat([p[k].res for p in parts], dim=-1), Fraction(cap)) for k in range(3)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].shape[-1] == len(seg_sizes or (n,))
