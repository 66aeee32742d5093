"""(Frozen copy of the program's gadgets/blake2s.py.)

BLAKE2s in-circuit (with personalization support).

Port of bellman/src/gadgets/blake2s.rs: rotation constants R1..R4 (:26-29),
SIGMA schedule (:49-60), `mixing_g` (:86-120), `blake2s_compression`
(:171-290) under a MultiEq, and the `blake2s` entry point (:315-377) with
the 0x01010000 ^ (kk<<8) ^ nn parameter block and 8-byte personalization
xored into h[6..8].
"""

from __future__ import annotations

from typing import List

from .boolean import Boolean, _consume
from .multieq import MultiEq
from .uint32 import UInt32

R1, R2, R3, R4 = 16, 12, 8, 7

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def _mixing_g(cs, v: List[UInt32], abcd, x: UInt32, y: UInt32) -> None:
    a, b, c, d = abcd
    v[a] = UInt32.addmany(cs.namespace("mixing step 1"), [v[a], v[b], x])
    v[d] = v[d].xor(cs.namespace("mixing step 2"), v[a]).rotr(R1)
    v[c] = UInt32.addmany(cs.namespace("mixing step 3"), [v[c], v[d]])
    v[b] = v[b].xor(cs.namespace("mixing step 4"), v[c]).rotr(R2)
    v[a] = UInt32.addmany(cs.namespace("mixing step 5"), [v[a], v[b], y])
    v[d] = v[d].xor(cs.namespace("mixing step 6"), v[a]).rotr(R3)
    v[c] = UInt32.addmany(cs.namespace("mixing step 7"), [v[c], v[d]])
    v[b] = v[b].xor(cs.namespace("mixing step 8"), v[c]).rotr(R4)


@_consume
def blake2s_compression(
    cs, h: List[UInt32], m: List[UInt32], t: int, f: bool
) -> None:
    assert len(h) == 8
    assert len(m) == 16

    v = list(h) + [UInt32.constant(iv) for iv in IV]
    v[12] = v[12].xor(cs.namespace("first xor"), UInt32.constant(t & 0xFFFFFFFF))
    v[13] = v[13].xor(cs.namespace("second xor"), UInt32.constant((t >> 32) & 0xFFFFFFFF))
    if f:
        v[14] = v[14].xor(cs.namespace("third xor"), UInt32.constant(0xFFFFFFFF))

    with MultiEq(cs) as mcs:
        for i in range(10):
            with mcs.namespace(f"round {i}") as ns:
                s = SIGMA[i % 10]
                for inv, abcd, xi, yi in [
                    (1, (0, 4, 8, 12), s[0], s[1]),
                    (2, (1, 5, 9, 13), s[2], s[3]),
                    (3, (2, 6, 10, 14), s[4], s[5]),
                    (4, (3, 7, 11, 15), s[6], s[7]),
                    (5, (0, 5, 10, 15), s[8], s[9]),
                    (6, (1, 6, 11, 12), s[10], s[11]),
                    (7, (2, 7, 8, 13), s[12], s[13]),
                    (8, (3, 4, 9, 14), s[14], s[15]),
                ]:
                    with ns.namespace(f"mixing invocation {inv}") as gns:
                        _mixing_g(gns, v, abcd, m[xi], m[yi])

    for i in range(8):
        with cs.namespace(f"h[{i}] ^ v[{i}] ^ v[{i} + 8]") as ns:
            h[i] = h[i].xor(ns.namespace("first xor"), v[i])
            h[i] = h[i].xor(ns.namespace("second xor"), v[i + 8])


@_consume
def blake2s(cs, input_bits: List[Boolean], personalization: bytes) -> List[Boolean]:
    """32-byte BLAKE2s digest of a bit vector (blake2s.rs:315-377)."""
    assert len(personalization) == 8
    assert len(input_bits) % 8 == 0

    h = [
        UInt32.constant(0x6A09E667 ^ 0x01010000 ^ 32),
        UInt32.constant(0xBB67AE85),
        UInt32.constant(0x3C6EF372),
        UInt32.constant(0xA54FF53A),
        UInt32.constant(0x510E527F),
        UInt32.constant(0x9B05688C),
        UInt32.constant(0x1F83D9AB ^ int.from_bytes(personalization[0:4], "little")),
        UInt32.constant(0x5BE0CD19 ^ int.from_bytes(personalization[4:8], "little")),
    ]

    blocks: List[List[UInt32]] = []
    for start in range(0, len(input_bits), 512):
        block = input_bits[start : start + 512]
        this_block = []
        for wstart in range(0, len(block), 32):
            word = block[wstart : wstart + 32]
            word = word + [Boolean.constant(False)] * (32 - len(word))
            this_block.append(UInt32.from_bits(word))
        while len(this_block) < 16:
            this_block.append(UInt32.constant(0))
        blocks.append(this_block)

    if not blocks:
        blocks.append([UInt32.constant(0) for _ in range(16)])

    for i, block in enumerate(blocks[:-1]):
        blake2s_compression(cs.namespace(f"block {i}"), h, block, (i + 1) * 64, False)

    blake2s_compression(
        cs.namespace("final block"), h, blocks[-1], len(input_bits) // 8, True
    )

    return [b for w in h for b in w.into_bits()]
