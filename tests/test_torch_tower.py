"""The port's device tower (ops/tower.py) against the JAX reference's.

The same seeded Fp2/Fp6/Fp12 batches (batch 4, with the edge values 0, 1
and p-1 in the first lanes) are encoded by the reference and carried into
the port through `interop.tree_from`; every tower function runs on both
(the reference eagerly, as its own CPU tests do) and the raw limbs must be
equal (tolerance 0: integer arithmetic).  Decoded values are also held
against the exact host tower (fields/tower.py) where it has the function.
"""

import jax
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.fields import tower as ht
from bellman_mpc_tpu.fields.bls12_381 import P
from bellman_mpc_tpu.ops import tower as rt
from bellman_mpc_tpu_torch import interop
from bellman_mpc_tpu_torch.ops import tower as tt

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

N = 4
EDGES = (0, 1, P - 1)


def _fp(rng):
    return int.from_bytes(rng.bytes(48), "little") % P


def _fp12s(seed):
    """N host Fp12 values: lane k < 3 has every coefficient EDGES[k] but
    one random, the last lane is random."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(N):
        cs = [_fp(rng) for _ in range(12)]
        if k < len(EDGES):
            cs = [EDGES[k]] * 11 + [cs[k]]
        it = iter(cs)
        out.append(tuple(tuple((next(it), next(it)) for _ in range(3)) for _ in range(2)))
    return out


def _same(r, t):
    rl = jax.tree_util.tree_leaves(r)
    tl = jax.tree_util.tree_leaves(interop.tree_to(t))
    return len(rl) == len(tl) and all(np.array_equal(np.asarray(a), b) for a, b in zip(rl, tl))


@pytest.fixture(scope="module")
def ops():
    """(host values, reference elements, port elements) for x and y."""
    xs, ys = _fp12s(7), _fp12s(8)
    rx, ry = rt.fp12_encode(xs), rt.fp12_encode(ys)
    return xs, ys, rx, ry, interop.tree_from(rx), interop.tree_from(ry)


def test_encode_decode_match(ops):
    xs, _, rx, _, tx, _ = ops
    assert _same(rx, tt.fp12_encode(xs, "cpu"))
    assert tt.fp12_decode(tx) == xs


def _args(name, x, y):
    """The arguments of tower function `name` built from Fp12 elements x, y
    (sub-elements are taken from their coefficients)."""
    if name == "fp2_mul_many":
        a, b = x[0][0], y[1][2]
        return ([(a, b), (b, a), (a, a)],)
    if name == "fp6_mul":
        return (x[0], y[1])
    if name == "fp6_inv":
        return (x[1],)
    if name == "fp12_mul":
        return (x, y)
    if name == "fp12_mul_by_0bc":
        return (x, y[0][0], y[1][1], y[1][2])
    return (x,)


HOST = {
    "fp6_mul": ht.fp6_mul, "fp6_inv": ht.fp6_inv, "fp12_mul": ht.fp12_mul,
    "fp12_square": ht.fp12_square, "fp12_inv": ht.fp12_inv,
}


@pytest.mark.parametrize("name", [
    "fp2_mul_many", "fp6_mul", "fp6_inv", "fp12_mul", "fp12_square", "fp12_mul_by_0bc",
    "fp12_cyclotomic_square", "fp12_inv", "fp12_frobenius", "fp12_frobenius2",
])
def test_tower_function_matches_reference(ops, name):
    xs, ys, rx, ry, tx, ty = ops
    want = getattr(rt, name)(*_args(name, rx, ry))
    got = getattr(tt, name)(*_args(name, tx, ty))
    assert _same(want, got), f"{name}: raw limbs differ from the reference"
    if name in HOST:  # decoded values against the exact host tower
        host_args = [_args(name, x, y) for x, y in zip(xs, ys)]
        dec = tt.fp12_decode(got) if name.startswith("fp12") else [
            tuple(c) for c in zip(*[tt.fp2_decode(c) for c in got])]
        for k, args in enumerate(host_args):
            assert dec[k] == HOST[name](*args), f"{name} lane {k}"  # inv(0) = 0 on both


def test_frobenius_is_the_p_power(ops):
    """x^p and x^(p^2) on decoded lanes equal the host power."""
    xs, _, _, _, tx, _ = ops
    f1 = tt.fp12_decode(tt.fp12_frobenius(tx))
    f2 = tt.fp12_decode(tt.fp12_frobenius2(tx))
    k = N - 1  # the random lane
    assert f1[k] == ht.fp12_pow(xs[k], P)
    assert f2[k] == ht.fp12_pow(f1[k], P)


def test_lazy_mul_by_xi_matches_reference(ops):
    """LazyFp2.mul_by_xi on the lazy columns of a Karatsuba product: the
    same columns and the same host bounds as the reference's."""
    _, _, rx, ry, tx, ty = ops

    def run(mod, x, y):
        a, b = mod._lz2_op(x[0][1]), mod._lz2_op(y[1][0])
        prod = mod._lz2_mul_many([(a, b)])[0].mul_by_xi()
        return prod

    r, t = run(rt, rx, ry), run(tt, tx, ty)
    for rc, tc in ((r.re, t.re), (r.im, t.im)):
        assert rc.hi == tc.hi
        assert np.array_equal(np.asarray(rc.cols), tc.cols.numpy())
    assert _same(rt._lz2_reduce_many([r]), tt._lz2_reduce_many([t]))


def test_select_and_is_one_broadcast_over_limbs(ops):
    """fp12_select takes an (N,) mask against (L, N) limbs; fp12_is_one
    builds its one on the operand's device."""
    _, _, rx, _, tx, _ = ops
    mask = np.asarray([True, False, True, False])
    one_r, one_t = rt.fp12_one((N,)), tt.fp12_one((N,), "cpu")
    sel_r = rt.fp12_select(mask, rx, one_r)
    sel_t = tt.fp12_select(torch.as_tensor(mask), tx, one_t)
    assert _same(sel_r, sel_t)
    assert tt.fp12_is_one(sel_t).tolist() == [False, True, False, True]
    assert np.asarray(rt.fp12_is_one(sel_r)).tolist() == [False, True, False, True]
