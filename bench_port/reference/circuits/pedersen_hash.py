"""The Sapling Pedersen hash in-circuit.

Port of zcash_proofs/src/circuit/pedersen_hash.rs: the 6 personalization
bits are prepended as constants, the bits read in 3-bit chunks, each chunk
a `lookup3_xy_with_conditional_negation` into its window of the segment's
generator table (Montgomery [1..4] * 16^w * I); the chunks of a 63-chunk
segment are summed in Montgomery form, each segment converted to Edwards
form and the segments summed there.  Tables: reference/jubjub.py
(frozen copy of the program's gadgets/pedersen_hash.py).
"""

from __future__ import annotations

from typing import List, Sequence

from .. import jubjub
from .boolean import Boolean, _consume
from .ecc import EdwardsPoint, MontgomeryPoint
from .lookup import lookup3_xy_with_conditional_negation


class Personalization:
    """The hash's domain: a note commitment, or level `depth` of the note
    commitment tree (0 at the leaves)."""

    def __init__(self, bits: List[bool]):
        assert len(bits) == 6
        self.bits = bits

    @staticmethod
    def note_commitment() -> "Personalization":
        return Personalization(jubjub.note_commitment_personalization())

    @staticmethod
    def merkle_tree(depth: int) -> "Personalization":
        return Personalization(jubjub.merkle_personalization(depth))


@_consume
def pedersen_hash(cs, personalization: Personalization, bits: Sequence[Boolean]) -> EdwardsPoint:
    bits = [Boolean.constant(b) for b in personalization.bits] + list(bits)
    bits += [Boolean.constant(False)] * (-len(bits) % 3)
    chunks = [bits[i : i + 3] for i in range(0, len(bits), 3)]
    per_segment = jubjub.PEDERSEN_HASH_CHUNKS_PER_GENERATOR
    result = None
    for segment_i, (start, windows) in enumerate(
            zip(range(0, len(chunks), per_segment), jubjub.pedersen_circuit_tables())):
        segment = None
        for window_i, chunk in enumerate(chunks[start : start + per_segment]):
            x, y = lookup3_xy_with_conditional_negation(
                cs.namespace(f"segment {segment_i}, window {window_i}"), chunk, windows[window_i])
            pt = MontgomeryPoint.interpret_unchecked(x, y)
            segment = pt if segment is None else pt.add(
                cs.namespace(f"addition of segment {segment_i}, window {window_i}"), segment)
        edwards = segment.into_edwards(cs.namespace(f"conversion of segment {segment_i} into edwards"))
        result = edwards if result is None else edwards.add(
            cs.namespace(f"addition of segment {segment_i} to accumulator"), result)
    assert len(chunks) <= per_segment * jubjub.PEDERSEN_HASH_GENERATORS, "too many bits"
    return result
