"""PyTorch limb curve ops (curves/device.py) vs the JAX reference and the
host bigint oracle (curves/host.py), on G1 and G2.  Raw limbs must be
equal (tolerance 0)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.curves import device as rdev
from bellman_mpc_tpu.curves import host as chost
from bellman_mpc_tpu_torch.curves import device as tdev
from bellman_mpc_tpu_torch.curves import host as thost

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

GROUPS = {
    "G1": (rdev.g1_device, tdev.g1_device, chost.G1),
    "G2": (rdev.g2_device, tdev.g2_device, chost.G2),
}


@pytest.fixture(params=sorted(GROUPS), scope="module")
def grp(request):
    rg, tg, hg = GROUPS[request.param]
    rng = random.Random(11)
    pts = [hg.mul(hg.generator, rng.randrange(1, 1 << 40)) for _ in range(6)] + [None, hg.generator]
    return rg, tg, hg, pts


def _same_pt(r, t):
    return all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(r, t))


def test_host_copy_matches(grp):
    _, _, hg, pts = grp
    th = thost.G1 if hg is chost.G1 else thost.G2
    k = 123456789
    assert [th.mul(p, k) for p in pts] == [hg.mul(p, k) for p in pts]


def test_encode_matches(grp):
    rg, tg, _, pts = grp
    assert _same_pt(rg.encode_points(pts), tg.encode_points(pts, "cpu"))


@pytest.mark.parametrize("op", ["add", "double", "add_mixed"])
def test_point_ops(grp, op):
    rg, tg, hg, pts = grp
    rp, tp = rg.encode_points(pts), tg.encode_points(pts, "cpu")
    rq, tq = rg.encode_points(pts[::-1]), tg.encode_points(pts[::-1], "cpu")
    if op == "add":
        r, t = rdev.point_add(rg.ops, rp, rq), tdev.point_add(tg.ops, tp, tq)
        want = [hg.add(a, b) for a, b in zip(pts, pts[::-1])]
    elif op == "double":
        r, t = rdev.point_double(rg.ops, rp), tdev.point_double(tg.ops, tp)
        want = [hg.add(a, a) for a in pts]
    else:  # affine second operand: drop the identities
        aff = [p for p in pts[::-1] if p is not None]
        n = len(aff)
        rq2 = rg.encode_points(aff)[:2]
        tq2 = tg.encode_points(aff, "cpu")[:2]
        rp2 = tuple(x[..., :n] for x in rp)
        tp2 = tuple(x[..., :n] for x in tp)
        r, t = rdev.point_add_mixed(rg.ops, rp2, rq2), tdev.point_add_mixed(tg.ops, tp2, tq2)
        want = [hg.add(a, b) for a, b in zip(pts[:n], aff)]
    assert _same_pt(r, t)
    assert tg.decode_points(t) == want


def test_scalar_mul_and_tree(grp):
    rg, tg, hg, pts = grp
    base = pts[0]
    sc = [0, 1, 5, 2**20 + 3, 7, 99, 12345, 2**30 - 1]
    bits_r = rdev.scalars_to_bits(sc, 31)
    bits_t = tdev.scalars_to_bits(sc, 31)
    r = rdev.scalar_mul_bits(rg.ops, rg.encode_points([base]), bits_r)
    t = tdev.scalar_mul_bits(tg.ops, tg.encode_points([base], "cpu"), bits_t)
    assert _same_pt(r, t)
    assert tg.decode_points(t) == [hg.mul(base, s) for s in sc]
    assert _same_pt(rdev.tree_reduce(rg.ops, r), tdev.tree_reduce(tg.ops, t))
    c1 = rdev.scalar_mul_const(rg.ops, r, 27134)
    c2 = tdev.scalar_mul_const(tg.ops, t, 27134)
    assert _same_pt(c1, c2)


def test_to_affine(grp):
    rg, tg, _, pts = grp
    rp = rdev.point_double(rg.ops, rg.encode_points(pts))
    tp = tdev.point_double(tg.ops, tg.encode_points(pts, "cpu"))
    assert _same_pt(rdev.to_affine(rg.ops, rp), tdev.to_affine(tg.ops, tp))
