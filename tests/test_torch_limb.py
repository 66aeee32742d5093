"""PyTorch LimbField (Fp L=36, Fr L=24) vs the JAX reference LimbField.

The same inputs, made from a seed, go through both; raw limbs must be equal
(tolerance 0: integer arithmetic) and decoded values equal the host bigints.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.fields import bls12_381 as ref
from bellman_mpc_tpu_torch.fields import bls12_381 as port

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

FIELDS = {"fp": (ref.fp, port.fp), "fr": (ref.fr, port.fr)}


def _vals(p, n, seed):
    rng = random.Random(seed)
    return [0, 1, p - 1, p // 2] + [rng.randrange(p) for _ in range(n - 4)]


@pytest.fixture(params=sorted(FIELDS), scope="module")
def pair(request):
    rf, tf = FIELDS[request.param]
    xs, ys = _vals(rf.p, 12, 1), _vals(rf.p, 12, 2)[::-1]
    return rf, tf, xs, ys


def _same(r, t):
    return np.array_equal(np.asarray(r), t.numpy())


def test_constants_match(pair):
    rf, tf, _, _ = pair
    assert (tf.L, tf.R, tf.n0inv, tf.r2, tf.nbytes) == (rf.L, rf.R, rf.n0inv, rf.r2, rf.nbytes)
    assert tf._dmax_lazy == rf._dmax_lazy


@pytest.mark.parametrize("mont", [True, False])
def test_encode_decode(pair, mont):
    rf, tf, xs, _ = pair
    t = tf.encode(xs, mont=mont)
    assert _same(rf.encode(xs, mont=mont), t)
    assert tf.decode(t, mont=mont) == [x % rf.p for x in xs]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops(pair, op):
    rf, tf, xs, ys = pair
    r = getattr(rf, op)(rf.encode(xs), rf.encode(ys))
    t = getattr(tf, op)(tf.encode(xs), tf.encode(ys))
    assert _same(r, t)
    expect = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b, "mul": lambda a, b: a * b}[op]
    assert tf.decode(t) == [expect(a, b) % rf.p for a, b in zip(xs, ys)]


@pytest.mark.parametrize("op", ["neg", "double", "square", "canon", "to_mont", "from_mont", "inv"])
def test_unary_ops(pair, op):
    rf, tf, xs, _ = pair
    assert _same(getattr(rf, op)(rf.encode(xs)), getattr(tf, op)(tf.encode(xs)))


def test_mul_const_and_pow(pair):
    rf, tf, xs, _ = pair
    c = 0xDEADBEEF12345
    assert _same(rf.mul_const(rf.encode(xs), c), tf.mul_const(tf.encode(xs), c))
    assert _same(rf.pow_const(rf.encode(xs), 77), tf.pow_const(tf.encode(xs), 77))


def test_eq_is_zero_select(pair):
    rf, tf, xs, ys = pair
    a, b = tf.encode(xs), tf.encode(ys)
    assert tf.is_zero(a).tolist() == [x % rf.p == 0 for x in xs]
    assert tf.eq(a, a).all()
    cond = torch.tensor([i % 2 == 0 for i in range(len(xs))])
    assert tf.decode(tf.select(cond, a, b)) == [x if i % 2 == 0 else y for i, (x, y) in enumerate(zip(xs, ys))]


def test_pack_unpack(pair):
    rf, tf, xs, _ = pair
    u8 = tf.pack_std(xs)
    assert np.array_equal(u8, rf.pack_std(xs))
    t = tf.unpack_device(torch.from_numpy(u8.copy()))
    assert _same(rf.unpack_device(jnp.asarray(u8)), t)


def test_lazy_columns(pair):
    """LazyCols: stacked unreduced products, a subtraction with its offset,
    a scale, and one reduction — raw limbs as the reference's."""
    rf, tf, xs, ys = pair

    def run(f, enc):
        a, b = enc(xs), enc(ys)
        p, q = f.lazy_mul_many([(a, b), (b, b)])
        d = 3 * (p - q) + p
        return f.lazy_reduce_many([d, q]) + [f.fold_digits(a + b, tuple(2 * x for x in f._dmax_lazy))[0]]

    for r, t in zip(run(rf, rf.encode), run(tf, tf.encode)):
        assert _same(r, t)
