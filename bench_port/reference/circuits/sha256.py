"""SHA-256 in-circuit.

Port of bellman/src/gadgets/sha256.rs: padding (:52-66), message schedule
(:102-122), 64-round compression with deferred additions (the `Maybe` enum,
:126-146) under a single MultiEq, `sha256_block_no_padding` (:29-45),
`sha256` (:47-74).  Round constants and IV are the standard FIPS 180-4
values (sha256.rs:13-27).
"""

from __future__ import annotations

from typing import List, Optional

from .boolean import Boolean, _consume
from .multieq import MultiEq
from .uint32 import UInt32

ROUND_CONSTANTS = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def get_sha256_iv() -> List[UInt32]:
    return [UInt32.constant(v) for v in IV]


@_consume
def sha256_block_no_padding(cs, input_bits: List[Boolean]) -> List[Boolean]:
    assert len(input_bits) == 512
    out = sha256_compression_function(cs, input_bits, get_sha256_iv())
    return [b for w in out for b in w.into_bits_be()]


@_consume
def sha256(cs, input_bits: List[Boolean]) -> List[Boolean]:
    """Full SHA-256 with padding (sha256.rs:47-74)."""
    assert len(input_bits) % 8 == 0
    padded = list(input_bits)
    plen = len(padded)
    padded.append(Boolean.constant(True))
    while (len(padded) + 64) % 512 != 0:
        padded.append(Boolean.constant(False))
    for i in range(63, -1, -1):
        padded.append(Boolean.constant(bool((plen >> i) & 1)))
    assert len(padded) % 512 == 0

    cur = get_sha256_iv()
    for i in range(0, len(padded), 512):
        cur = sha256_compression_function(
            cs.namespace(f"block {i // 512}"), padded[i : i + 512], cur
        )
    return [b for w in cur for b in w.into_bits_be()]


class _Maybe:
    """Deferred addition chain (sha256.rs:126-146)."""

    def __init__(self, concrete: Optional[UInt32] = None, deferred: Optional[List[UInt32]] = None):
        self.concrete = concrete
        self.deferred = deferred

    def compute(self, cs, others: List[UInt32]) -> UInt32:
        if self.concrete is not None:
            from .core import Namespace

            if isinstance(cs, Namespace):
                cs.pop()
            return self.concrete
        return UInt32.addmany(cs, self.deferred + list(others))


@_consume
def sha256_compression_function(
    cs, input_bits: List[Boolean], current_hash_value: List[UInt32]
) -> List[UInt32]:
    assert len(input_bits) == 512
    assert len(current_hash_value) == 8

    w = [
        UInt32.from_bits_be(input_bits[i : i + 32]) for i in range(0, 512, 32)
    ]

    with MultiEq(cs) as mcs:
        for i in range(16, 64):
            with mcs.namespace(f"w extension {i}") as ns:
                s0 = w[i - 15].rotr(7)
                s0 = s0.xor(ns.namespace("first xor for s0"), w[i - 15].rotr(18))
                s0 = s0.xor(ns.namespace("second xor for s0"), w[i - 15].shr(3))
                s1 = w[i - 2].rotr(17)
                s1 = s1.xor(ns.namespace("first xor for s1"), w[i - 2].rotr(19))
                s1 = s1.xor(ns.namespace("second xor for s1"), w[i - 2].shr(10))
                w.append(
                    UInt32.addmany(
                        ns.namespace("computation of w[i]"),
                        [w[i - 16], s0, w[i - 7], s1],
                    )
                )

        assert len(w) == 64

        a = _Maybe(concrete=current_hash_value[0])
        b = current_hash_value[1]
        c = current_hash_value[2]
        d = current_hash_value[3]
        e = _Maybe(concrete=current_hash_value[4])
        f = current_hash_value[5]
        g = current_hash_value[6]
        h = current_hash_value[7]

        for i in range(64):
            with mcs.namespace(f"compression round {i}") as ns:
                new_e = e.compute(ns.namespace("deferred e computation"), [])
                s1 = new_e.rotr(6)
                s1 = s1.xor(ns.namespace("first xor for s1"), new_e.rotr(11))
                s1 = s1.xor(ns.namespace("second xor for s1"), new_e.rotr(25))
                ch = UInt32.sha256_ch(ns.namespace("ch"), new_e, f, g)
                temp1 = [h, s1, ch, UInt32.constant(ROUND_CONSTANTS[i]), w[i]]

                new_a = a.compute(ns.namespace("deferred a computation"), [])
                s0 = new_a.rotr(2)
                s0 = s0.xor(ns.namespace("first xor for s0"), new_a.rotr(13))
                s0 = s0.xor(ns.namespace("second xor for s0"), new_a.rotr(22))
                maj = UInt32.sha256_maj(ns.namespace("maj"), new_a, b, c)
                temp2 = [s0, maj]

                h = g
                g = f
                f = new_e
                e = _Maybe(deferred=temp1 + [d])
                d = c
                c = b
                b = new_a
                a = _Maybe(deferred=temp1 + temp2)

        h0 = a.compute(
            mcs.namespace("deferred h0 computation"), [current_hash_value[0]]
        )
        h1 = UInt32.addmany(mcs.namespace("new h1"), [current_hash_value[1], b])
        h2 = UInt32.addmany(mcs.namespace("new h2"), [current_hash_value[2], c])
        h3 = UInt32.addmany(mcs.namespace("new h3"), [current_hash_value[3], d])
        h4 = e.compute(
            mcs.namespace("deferred h4 computation"), [current_hash_value[4]]
        )
        h5 = UInt32.addmany(mcs.namespace("new h5"), [current_hash_value[5], f])
        h6 = UInt32.addmany(mcs.namespace("new h6"), [current_hash_value[6], g])
        h7 = UInt32.addmany(mcs.namespace("new h7"), [current_hash_value[7], h])

    return [h0, h1, h2, h3, h4, h5, h6, h7]
