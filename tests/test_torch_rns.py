"""PyTorch RNS engine (fields/rns.py, curves/rns_point.py) vs the JAX
reference: constants, multiply residues channel by channel, the limb <-> RNS
bridge, and the RNS point formulas (tolerance 0: integer residues)."""

import random
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.curves import rns_point as rrp
from bellman_mpc_tpu.fields import bls12_381 as rbc
from bellman_mpc_tpu_torch.curves import rns_point as trp
from bellman_mpc_tpu_torch.fields import bls12_381 as tbc

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

RF, TF = rrp.default_rns_field(), trp.default_rns_field()


def _vals(n, seed):
    rng = random.Random(seed)
    return [0, 1, RF.p - 1] + [rng.randrange(RF.p) for _ in range(n - 3)]


def _same(r, t):
    return np.array_equal(np.asarray(r), t.numpy())


def test_constants():
    assert TF.moduli == RF.moduli and (TF.k, TF.C, TF.mr) == (35, 71, RF.mr)
    assert (TF.M, TF.Mp, TF.mpinv_mr, TF.m_mod_mr_inv) == (RF.M, RF.Mp, RF.mpinv_mr, RF.m_mod_mr_inv)
    for name in ("kappa_np", "minv_np", "ifac2_np", "mp_mod_np"):
        assert np.array_equal(getattr(TF, name), np.asarray(getattr(RF, name)))
    # the int8 block matrices of the reference hold the same W1/W2 entries
    W1 = np.asarray(RF.W1_np, np.int64)
    n = RF.k + 1
    assert np.array_equal(W1[:n, : RF.k] + 64 * W1[n : 2 * n, : RF.k], TF.W1_np)


def test_encode_decode():
    xs = _vals(10, 1)
    assert _same(RF.encode(xs).res, TF.encode(xs).res)
    assert TF.decode(TF.encode(xs)) == [x % RF.p for x in xs]


def test_mul_many_residues():
    xs, ys = _vals(10, 2), _vals(10, 3)
    r = RF.mul_many([(RF.encode(xs), RF.encode(ys)), (RF.encode(ys), RF.encode(ys))])
    t = TF.mul_many([(TF.encode(xs), TF.encode(ys)), (TF.encode(ys), TF.encode(ys))])
    for a, b in zip(r, t):
        assert _same(a.res, b.res) and a.a == b.a
    assert TF.decode(t[0]) == [x * y % RF.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("op", ["add", "sub", "neg", "scale"])
def test_linear_ops(op):
    xs, ys = _vals(8, 4), _vals(8, 5)

    def run(f):
        a = f.mul_many([(f.encode(xs), f.encode(ys))])[0]  # bound > 1
        b = f.encode(ys)
        return {"add": lambda: a + b, "sub": lambda: b - a, "neg": lambda: a.neg(),
                "scale": lambda: a.scale(12)}[op]()

    r, t = run(RF), run(TF)
    assert _same(r.res, t.res) and r.a == t.a


def test_limb_bridge():
    xs = _vals(8, 6)
    u = rrp.limb_coord_to_rns(RF, rbc.fp, rbc.fp.encode(xs))
    v = trp.limb_coord_to_rns(TF, tbc.fp, tbc.fp.encode(xs))
    assert _same(u.res, v.res) and u.a == v.a
    assert _same(RF.to_limb_mont(u, rbc.fp), TF.to_limb_mont(v, tbc.fp))
    assert tbc.fp.decode(TF.to_limb_mont(v, tbc.fp)) == [x % RF.p for x in xs]
    # the exact-zero sentinel survives the conversion
    z = trp.limb_coord_to_rns(TF, tbc.fp, tbc.fp.zeros((3,)))
    assert int(z.res.abs().sum()) == 0


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_point_formulas(g2):
    rng = random.Random(7)
    rops, tops = (rrp.rns_g2_ops(), trp.rns_g2_ops()) if g2 else (rrp.rns_g1_ops(), trp.rns_g1_ops())
    n = 8
    coords = [[rng.randrange(RF.p) for _ in range(n * (2 if g2 else 1))] for _ in range(5)]

    def mk(f, ops, stack, c, a):
        res = f.encode(c).res
        if g2:
            res = stack([res[:, :n], res[:, n:]], 1)
        return ops.wrap(res, Fraction(a))

    cap = 256 if g2 else 128
    for f, ops, stack, out in ((RF, rops, jnp.stack, []), (TF, tops, torch.stack, [])):
        P = tuple(mk(f, ops, stack, c, cap) for c in coords[:3])
        Q = tuple(mk(f, ops, stack, c, 37) for c in coords[3:])
        mod = rrp if f is RF else trp
        out += list(mod.point_add_mixed(ops, P, Q)) + list(mod.point_add(ops, P, P))
        out += list(mod.tree_reduce(ops, P, Fraction(cap)))
        if f is RF:
            ref_out = out
        else:
            port_out = out
    for a, b in zip(ref_out, port_out):
        assert _same(a.res, b.res) and a.a == b.a
