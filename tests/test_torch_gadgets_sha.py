"""The port's SHA-256 and BLAKE2s gadgets on the CPU.

Ports of the SHA-256 tests of tests/test_gadgets.py on the port's modules,
at the reference's input lengths (the BLAKE2s tests and the rest of that
file are in test_torch_gadgets.py, on another pytest-xdist worker under
--dist loadfile); then the cross-check that pins the copies: one SHA-256
and one BLAKE2s, built by both packages on their TestConstraintSystem, give
the same structural hash, constraint count and digest, and the same first
unsatisfied constraint with one input bit flipped.
"""

import hashlib
import random

import pytest
import torch

import bellman_mpc_tpu.gadgets as ref_gadgets
from bellman_mpc_tpu.fields.bls12_381 import fr_host as ref_fr_host
from bellman_mpc_tpu.r1cs import TestConstraintSystem as RefTestConstraintSystem
from bellman_mpc_tpu_torch import gadgets as port_gadgets
from bellman_mpc_tpu_torch.fields.bls12_381 import fr_host
from bellman_mpc_tpu_torch.gadgets import AllocatedBit, Boolean, sha256
from bellman_mpc_tpu_torch.r1cs import TestConstraintSystem

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers


def new_cs():
    return TestConstraintSystem(fr_host)


# -------------------------------------------------------------------- sha256
def test_sha256_blank_hash():
    """Port of test_blank_hash (sha256.rs): all-constant input, 0 constraints."""
    from bellman_mpc_tpu_torch.gadgets.sha256 import get_sha256_iv, sha256_compression_function

    cs = new_cs()
    input_bits = [Boolean.constant(False)] * 512
    input_bits[0] = Boolean.constant(True)
    out = sha256_compression_function(cs, input_bits, get_sha256_iv())
    out_bits = [b for w in out for b in w.into_bits_be()]
    assert cs.is_satisfied()
    assert cs.num_constraints() == 0
    expected = hashlib.sha256(b"").digest()
    got_bits = [b.get_value() for b in out_bits]
    want_bits = [bool((byte >> i) & 1) for byte in expected for i in range(7, -1, -1)]
    assert got_bits == want_bits


def test_sha256_full_block_constraint_count():
    """Port of test_full_block (sha256.rs): 25840 constraints per block."""
    from bellman_mpc_tpu_torch.gadgets.sha256 import get_sha256_iv, sha256_compression_function

    rng = random.Random(17)
    cs = new_cs()
    input_bits = [
        Boolean.from_bit(
            AllocatedBit.alloc(cs.namespace(f"input bit {i}"), bool(rng.randrange(2)))
        )
        for i in range(512)
    ]
    sha256_compression_function(cs.namespace("sha256"), input_bits, get_sha256_iv())
    assert cs.is_satisfied()
    assert cs.num_constraints() - 512 == 25840


@pytest.mark.parametrize("input_len", [0, 1, 31, 32, 55, 56, 64, 100])
def test_sha256_against_hashlib(input_len):
    """Port of test_against_vectors (sha256.rs)."""
    rng = random.Random(input_len)
    data = bytes(rng.randrange(256) for _ in range(input_len))
    expected = hashlib.sha256(data).digest()

    cs = new_cs()
    input_bits = []
    for byte_i, byte in enumerate(data):
        for bit_i in range(7, -1, -1):
            input_bits.append(
                Boolean.from_bit(
                    AllocatedBit.alloc(
                        cs.namespace(f"input bit {byte_i} {bit_i}"),
                        bool((byte >> bit_i) & 1),
                    )
                )
            )
    out = sha256(cs, input_bits)
    assert cs.is_satisfied()
    want = [bool((b >> i) & 1) for b in expected for i in range(7, -1, -1)]
    got = [b.get_value() for b in out]
    assert got == want


# ------------------------------------------------------- port vs reference
def _hash_circuit(g, cs, name, data):
    bits = (g.bytes_to_bits if name == "sha256" else g.bytes_to_bits_le)(data)
    inputs = [g.Boolean.from_bit(g.AllocatedBit.alloc(cs.namespace(f"input bit {i}"), b))
              for i, b in enumerate(bits)]
    if name == "sha256":
        return g.sha256(cs, inputs)
    return g.blake2s(cs, inputs, b"12345678")


@pytest.mark.parametrize("name,input_len", [("sha256", 3), ("blake2s", 3)])
def test_cross_check_hash(name, input_len):
    data = bytes(random.Random(200 + input_len).randrange(256) for _ in range(input_len))
    out = []
    for g, tcs, f in ((ref_gadgets, RefTestConstraintSystem, ref_fr_host),
                      (port_gadgets, TestConstraintSystem, fr_host)):
        cs = tcs(f)
        digest = [b.get_value() for b in _hash_circuit(g, cs, name, data)]
        assert cs.is_satisfied()
        cs.set("input bit 5/boolean", 1 - cs.get("input bit 5/boolean"))
        out.append((cs.hash(), cs.num_constraints(), len(cs.aux), digest, cs.which_is_unsatisfied()))
    assert out[0] == out[1]
    h = getattr(hashlib, name)(data, **({} if name == "sha256" else {"person": b"12345678"})).digest()
    order = range(7, -1, -1) if name == "sha256" else range(8)
    assert out[1][3] == [bool((byte >> i) & 1) for byte in h for i in order]
    assert out[1][4] is not None
