"""The port's gadget library and TestConstraintSystem on the CPU.

Ports of every test of tests/test_gadgets.py but its SHA-256 ones (boolean,
num, uint32, multipack, lookup, BLAKE2s; the SHA-256 cases are in
test_torch_gadgets_sha.py, so that pytest-xdist's --dist loadfile puts them
on another worker) and of tests/test_r1cs.py, on the port's modules at the
reference's sizes; then the cross-check that pins the copies: one
circuit of booleans, uint32 words, nums, a lookup and packed inputs built by
both packages gives the same structural hash, constraint count, inputs, and
the same first unsatisfied constraint for each tampered wire.
"""

import hashlib
import itertools
import random

import pytest
import torch

import bellman_mpc_tpu.gadgets as ref_gadgets
from bellman_mpc_tpu.fields.bls12_381 import fr_host as ref_fr_host
from bellman_mpc_tpu.r1cs import TestConstraintSystem as RefTestConstraintSystem
from bellman_mpc_tpu_torch import gadgets as port_gadgets
from bellman_mpc_tpu_torch.fields.bls12_381 import fr_host
from bellman_mpc_tpu_torch.gadgets import (
    AllocatedBit,
    AllocatedNum,
    Boolean,
    MultiEq,
    UInt32,
    blake2s,
    bytes_to_bits,
    bytes_to_bits_le,
    compute_multipacking,
    lookup3_xy,
    pack_into_inputs,
)
from bellman_mpc_tpu_torch.r1cs import TestConstraintSystem

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

R = fr_host.p


def new_cs():
    return TestConstraintSystem(fr_host)


# ------------------------------------------------------------------- boolean
def test_allocated_bit_ops_truth_tables():
    """Truth-table exhaustive tests (boolean.rs:1061+ style)."""
    for op, native, result_name in [
        (AllocatedBit.xor, lambda a, b: a ^ b, "xor result"),
        (AllocatedBit.and_, lambda a, b: a and b, "and result"),
        (AllocatedBit.and_not, lambda a, b: a and not b, "and not result"),
        (AllocatedBit.nor, lambda a, b: not a and not b, "nor result"),
    ]:
        for a_val, b_val in itertools.product([False, True], repeat=2):
            cs = new_cs()
            a = AllocatedBit.alloc(cs.namespace("a"), a_val)
            b = AllocatedBit.alloc(cs.namespace("b"), b_val)
            c = op(cs, a, b)
            assert c.get_value() == native(a_val, b_val)
            assert cs.is_satisfied()
            # corrupt the result wire: must become unsatisfiable
            cs.set(result_name, 1 - int(c.get_value()))
            assert not cs.is_satisfied()


def test_boolean_enum_xor_and():
    """Boolean xor/and across Is/Not/Constant variants."""
    for a_kind in ("is", "not", "const_t", "const_f"):
        for b_kind in ("is", "not", "const_t", "const_f"):
            for a_val, b_val in itertools.product([False, True], repeat=2):
                cs = new_cs()

                def make(kind, val, name):
                    if kind == "is":
                        return Boolean.from_bit(
                            AllocatedBit.alloc(cs.namespace(name), val)
                        ), val
                    if kind == "not":
                        return Boolean.from_bit(
                            AllocatedBit.alloc(cs.namespace(name), not val)
                        ).not_(), val
                    if kind == "const_t":
                        return Boolean.constant(True), True
                    return Boolean.constant(False), False

                a, av = make(a_kind, a_val, "a")
                b, bv = make(b_kind, b_val, "b")
                x = Boolean.xor(cs.namespace("xor"), a, b)
                y = Boolean.and_(cs.namespace("and"), a, b)
                assert x.get_value() == (av ^ bv)
                assert y.get_value() == (av and bv)
                assert cs.is_satisfied()


def test_sha256_ch_maj():
    for a, b, c in itertools.product([False, True], repeat=3):
        cs = new_cs()
        ba = Boolean.from_bit(AllocatedBit.alloc(cs.namespace("a"), a))
        bb = Boolean.from_bit(AllocatedBit.alloc(cs.namespace("b"), b))
        bc = Boolean.from_bit(AllocatedBit.alloc(cs.namespace("c"), c))
        ch = Boolean.sha256_ch(cs.namespace("ch"), ba, bb, bc)
        maj = Boolean.sha256_maj(cs.namespace("maj"), ba, bb, bc)
        assert ch.get_value() == ((a and b) ^ ((not a) and c))
        assert maj.get_value() == ((a and b) ^ (a and c) ^ (b and c))
        assert cs.is_satisfied()
        # ch/maj each cost exactly 1 constraint (+1 AND inside maj)
        assert cs.num_constraints() == 3 + 1 + 2


def test_enforce_equal():
    cs = new_cs()
    a = Boolean.from_bit(AllocatedBit.alloc(cs.namespace("a"), True))
    b = Boolean.from_bit(AllocatedBit.alloc(cs.namespace("b"), True))
    Boolean.enforce_equal(cs.namespace("eq"), a, b)
    assert cs.is_satisfied()
    cs.set("b/boolean", 0)
    assert not cs.is_satisfied()


# ----------------------------------------------------------------------- num
def test_allocated_num_basic():
    cs = new_cs()
    n = AllocatedNum.alloc(cs.namespace("n"), lambda: 5)
    n2 = n.mul(cs.namespace("mul"), n)
    n4 = n2.square(cs.namespace("sq"))
    assert n2.get_value() == 25
    assert n4.get_value() == 625
    n.assert_nonzero(cs.namespace("nz"))
    assert cs.is_satisfied()


def test_assert_nonzero_fails_for_zero():
    from bellman_mpc_tpu_torch.r1cs import DivisionByZero

    cs = new_cs()
    n = AllocatedNum.alloc(cs.namespace("n"), lambda: 0)
    with pytest.raises(DivisionByZero):
        n.assert_nonzero(cs.namespace("nz"))


def test_to_bits_le():
    rng = random.Random(3)
    v = rng.randrange(R)
    cs = new_cs()
    n = AllocatedNum.alloc(cs.namespace("n"), lambda: v)
    bits = n.to_bits_le(cs.namespace("bits"))
    assert cs.is_satisfied()
    got = sum(int(b.get_value()) << i for i, b in enumerate(bits))
    assert got == v


def test_to_bits_le_strict():
    rng = random.Random(4)
    v = rng.randrange(R)
    cs = new_cs()
    n = AllocatedNum.alloc(cs.namespace("n"), lambda: v)
    bits = n.to_bits_le_strict(cs.namespace("bits"))
    assert cs.is_satisfied()
    got = sum(int(b.get_value()) << i for i, b in enumerate(bits))
    assert got == v
    # negate a bit -> unsatisfiable (num.rs test style)
    some_path = [p for p in cs.named_objects if p.startswith("bits/bit ")][0]
    cs.set(some_path + "/boolean", 1 - cs.get(some_path + "/boolean"))
    assert not cs.is_satisfied()


def test_conditionally_reverse():
    for cond in (False, True):
        cs = new_cs()
        a = AllocatedNum.alloc(cs.namespace("a"), lambda: 10)
        b = AllocatedNum.alloc(cs.namespace("b"), lambda: 20)
        cbit = Boolean.from_bit(AllocatedBit.alloc(cs.namespace("cond"), cond))
        c, d = AllocatedNum.conditionally_reverse(cs.namespace("rev"), a, b, cbit)
        assert cs.is_satisfied()
        if cond:
            assert (c.get_value(), d.get_value()) == (20, 10)
        else:
            assert (c.get_value(), d.get_value()) == (10, 20)


# -------------------------------------------------------------------- uint32
def test_uint32_rotr_shr_xor():
    rng = random.Random(7)
    a, b = rng.randrange(2 ** 32), rng.randrange(2 ** 32)
    cs = new_cs()
    ua = UInt32.alloc(cs.namespace("a"), a)
    ub = UInt32.alloc(cs.namespace("b"), b)
    assert ua.rotr(7).value == ((a >> 7) | (a << 25)) & 0xFFFFFFFF
    assert ua.shr(9).value == a >> 9
    x = ua.xor(cs.namespace("xor"), ub)
    assert x.value == a ^ b
    assert cs.is_satisfied()
    # bit conversions round-trip
    assert UInt32.from_bits(ua.into_bits()).value == a
    assert UInt32.from_bits_be(ua.into_bits_be()).value == a


def test_uint32_addmany():
    rng = random.Random(8)
    for _ in range(5):
        vals = [rng.randrange(2 ** 32) for _ in range(4)]
        cs = new_cs()
        with MultiEq(cs) as mcs:
            ops = [
                UInt32.alloc(mcs.namespace(f"op {i}"), v) for i, v in enumerate(vals)
            ]
            res = UInt32.addmany(mcs.namespace("add"), ops)
            assert res.value == sum(vals) & 0xFFFFFFFF
        assert cs.is_satisfied()


def test_uint32_sha256_ch_maj():
    rng = random.Random(9)
    a, b, c = (rng.randrange(2 ** 32) for _ in range(3))
    cs = new_cs()
    ua = UInt32.alloc(cs.namespace("a"), a)
    ub = UInt32.alloc(cs.namespace("b"), b)
    uc = UInt32.alloc(cs.namespace("c"), c)
    ch = UInt32.sha256_ch(cs.namespace("ch"), ua, ub, uc)
    maj = UInt32.sha256_maj(cs.namespace("maj"), ua, ub, uc)
    assert ch.value == (a & b) ^ (~a & 0xFFFFFFFF & c)
    assert maj.value == (a & b) ^ (a & c) ^ (b & c)
    assert cs.is_satisfied()


# ----------------------------------------------------------------- multipack
def test_multipacking():
    """Port of test_multipacking (multipack.rs:74-120), smaller sweep."""
    rng = random.Random(11)
    for num_bits in [0, 1, 7, 8, 254, 255, 256, 300]:
        cs = new_cs()
        bits = [bool(rng.randrange(2)) for _ in range(num_bits)]
        circuit_bits = [
            Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"bit {i}"), b))
            for i, b in enumerate(bits)
        ]
        expected = compute_multipacking(fr_host, bits)
        pack_into_inputs(cs.namespace("pack"), circuit_bits)
        assert cs.is_satisfied()
        assert cs.verify(expected)


def test_bytes_to_bits():
    assert bytes_to_bits(b"\x80") == [True] + [False] * 7
    assert bytes_to_bits_le(b"\x80") == [False] * 7 + [True]


# -------------------------------------------------------------------- lookup
def test_lookup3_xy():
    rng = random.Random(13)
    coords = [(rng.randrange(R), rng.randrange(R)) for _ in range(8)]
    for idx in range(8):
        cs = new_cs()
        bits = [
            Boolean.from_bit(
                AllocatedBit.alloc(cs.namespace(f"b{k}"), bool((idx >> k) & 1))
            )
            for k in range(3)
        ]
        x, y = lookup3_xy(cs.namespace("lookup"), bits, coords)
        assert (x.get_value(), y.get_value()) == coords[idx]
        assert cs.is_satisfied()


# ------------------------------------------------------------------- blake2s
def test_blake2s_blank_hash():
    cs = new_cs()
    out = blake2s(cs, [], b"12345678")
    assert cs.is_satisfied()
    assert cs.num_constraints() == 0
    expected = hashlib.blake2s(b"", digest_size=32, person=b"12345678").digest()
    got = [b.get_value() for b in out]
    want = [bool((byte >> i) & 1) for byte in expected for i in range(8)]
    assert got == want


@pytest.mark.parametrize("input_len", [1, 32, 63, 64, 65, 100])
def test_blake2s_against_hashlib(input_len):
    rng = random.Random(100 + input_len)
    data = bytes(rng.randrange(256) for _ in range(input_len))
    expected = hashlib.blake2s(data, digest_size=32, person=b"12345678").digest()

    cs = new_cs()
    input_bits = [
        Boolean.from_bit(
            AllocatedBit.alloc(cs.namespace(f"input bit {i}"), b)
        )
        for i, b in enumerate(bytes_to_bits_le(data))
    ]
    out = blake2s(cs, input_bits, b"12345678")
    assert cs.is_satisfied()
    got = [b.get_value() for b in out]
    want = [bool((byte >> i) & 1) for byte in expected for i in range(8)]
    assert got == want


# ---------------------------------------------------------------------- r1cs
def test_cs():
    """Port of the reference's test_cs (gadgets/test/mod.rs:428-469)."""
    cs = TestConstraintSystem(fr_host)
    assert cs.is_satisfied()
    assert cs.num_constraints() == 0
    with cs.namespace("a"):
        a = cs.alloc("var", lambda: 10)
    with cs.namespace("b"):
        b = cs.alloc("var", lambda: 4)
    c = cs.alloc("product", lambda: 40)

    cs.enforce("mult", lambda lc: lc + a, lambda lc: lc + b, lambda lc: lc + c)
    assert cs.is_satisfied()
    assert cs.num_constraints() == 1

    cs.set("a/var", 4)

    one = TestConstraintSystem.one()
    cs.enforce("eq", lambda lc: lc + a, lambda lc: lc + one, lambda lc: lc + b)

    assert not cs.is_satisfied()
    assert cs.which_is_unsatisfied() == "mult"

    assert cs.get("product") == 40

    cs.set("product", 16)
    assert cs.is_satisfied()

    with cs.namespace("test1"):
        with cs.namespace("test2"):
            cs.alloc("hehe", lambda: 1)

    assert cs.get("test1/test2/hehe") == 1


def test_lc_operators():
    from bellman_mpc_tpu_torch.r1cs import LinearCombination, Variable, INPUT, AUX

    f = fr_host
    a = Variable(AUX, 0)
    b = Variable(AUX, 1)
    lc = LinearCombination.zero(f) + a + (3, b)
    lc2 = LinearCombination.zero(f) + (2, lc) - a
    # lc2 = 2a + 6b - a = a + 6b
    assert lc2.eval([], [5, 7]) == (5 + 42) % f.p
    lc3 = lc - lc2  # (a + 3b) - (a + 6b) = -3b
    assert lc3.eval([], [5, 7]) == (-21) % f.p


def test_namespace_errors():
    cs = TestConstraintSystem(fr_host)
    with pytest.raises(ValueError):
        cs.alloc("has/slash", lambda: 1)
    cs.alloc("x", lambda: 1)
    with pytest.raises(ValueError):
        cs.alloc("x", lambda: 2)  # duplicate path
    with pytest.raises(KeyError):
        cs.get("nonexistent")


def test_hash_stability():
    """Structural hash changes with structure, not assignments."""
    def build(val):
        cs = TestConstraintSystem(fr_host)
        a = cs.alloc("a", lambda: val)
        cs.enforce("sq", lambda lc: lc + a, lambda lc: lc + a, lambda lc: lc + a)
        return cs

    h1 = build(1).hash()
    h2 = build(999).hash()
    assert h1 == h2
    cs3 = build(1)
    cs3.enforce("extra", lambda lc: lc, lambda lc: lc, lambda lc: lc)
    assert cs3.hash() != h1
    assert len(h1) == 64


# ------------------------------------------------------- port vs reference
def mixed_circuit(g, cs):
    """Booleans, uint32 words, nums, a lookup and packed inputs, built with
    the gadget module `g` on `cs`; returns the paths of its allocated wires."""
    rng = random.Random(21)
    bits = [g.Boolean.from_bit(g.AllocatedBit.alloc(cs.namespace(f"bit {i}"), v))
            for i, v in enumerate([True, False, True, True, False])]
    nb = g.Boolean.from_bit(g.AllocatedBit.alloc(cs.namespace("negated"), True)).not_()
    g.Boolean.xor(cs.namespace("xor"), bits[0], bits[1])
    g.Boolean.and_(cs.namespace("and"), bits[2], nb)
    g.Boolean.sha256_ch(cs.namespace("ch"), bits[0], bits[2], bits[3])
    g.Boolean.sha256_maj(cs.namespace("maj"), bits[1], nb, bits[4])
    g.Boolean.enforce_equal(cs.namespace("eq"), bits[0], bits[2])
    words = [g.UInt32.alloc(cs.namespace(f"word {i}"), rng.randrange(2 ** 32)) for i in range(3)]
    w = words[0].xor(cs.namespace("word xor"), words[1].rotr(7))
    g.UInt32.sha256_maj(cs.namespace("word maj"), w, words[1], words[2].shr(3))
    with g.MultiEq(cs.namespace("multieq")) as mcs:
        g.UInt32.addmany(mcs.namespace("add"), [w, words[1], words[2]])
    n = g.AllocatedNum.alloc(cs.namespace("num"), lambda: rng.randrange(R))
    sq = n.square(cs.namespace("square")).mul(cs.namespace("mul"), n)
    sq.to_bits_le_strict(cs.namespace("strict"))
    g.AllocatedNum.conditionally_reverse(cs.namespace("reverse"), n, sq, bits[3])
    coords = [(rng.randrange(R), rng.randrange(R)) for _ in range(8)]
    g.lookup3_xy(cs.namespace("lookup"), bits[:3], coords)
    g.lookup3_xy_with_conditional_negation(cs.namespace("lookup neg"), bits[2:5], coords[:4])
    g.pack_into_inputs(cs.namespace("pack"), bits + [nb])
    n.inputize(cs.namespace("input"))


def cross_check(build, stride):
    """Build `build(g, cs)` with both packages and compare hash, counts,
    inputs and which_is_unsatisfied after tampering every stride-th wire."""
    out = []
    for g, tcs, f in ((ref_gadgets, RefTestConstraintSystem, ref_fr_host),
                      (port_gadgets, TestConstraintSystem, fr_host)):
        cs = tcs(f)
        build(g, cs)
        assert cs.is_satisfied()
        wires = [p for p, o in cs.named_objects.items() if o[0] == "var" and p != "ONE"]
        unsat = []
        for path in wires[::stride]:
            v = cs.get(path)
            cs.set(path, v + 1)
            unsat.append((path, cs.which_is_unsatisfied()))
            cs.set(path, v)
        out.append((cs.hash(), cs.num_constraints(), cs.num_inputs(), len(cs.aux),
                    [v for v, _ in cs.inputs], unsat))
    assert out[0] == out[1]
    return out[1]


def test_cross_check_mixed_circuit():
    h, n_cons, n_in, n_aux, _, unsat = cross_check(mixed_circuit, 7)
    assert (len(h), n_cons, n_in, n_aux, len(unsat)) == (64, 635, 3, 631, 91)
    assert all(u is not None for _, u in unsat)
    assert unsat[0] == ("bit 0/boolean", "bit 0/boolean constraint")
