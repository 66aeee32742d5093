"""sha256-block, the reference's side: messages from the seed, their
SHA-256 digests (hashlib) packed into public inputs, and the frozen
circuit."""

from __future__ import annotations

import hashlib
import random
from typing import List

from reference.bls12_381 import R
from reference.circuits.boolean import AllocatedBit, Boolean
from reference.circuits.core import Circuit
from reference.circuits.multipack import pack_into_inputs
from reference.circuits.sha256 import sha256_block_no_padding

CAPACITY = R.bit_length() - 1  # bits per packed public input


def padded_block(msg: bytes) -> bytes:
    """The one 64-byte block SHA-256 makes of a message of at most 55 bytes."""
    assert len(msg) <= 55
    return msg + b"\x80" + bytes(55 - len(msg)) + (8 * len(msg)).to_bytes(8, "big")


def draw_witnesses(cfg, rng: random.Random, n: int) -> List[bytes]:
    """n padded blocks of messages of cfg["message_bytes"] random bytes."""
    return [padded_block(bytes(rng.randrange(256) for _ in range(cfg["message_bytes"]))) for _ in range(n)]


def block_bits(block: bytes) -> List[bool]:
    return [bool((byte >> i) & 1) for byte in block for i in range(7, -1, -1)]


def public_inputs(cfg, block: bytes) -> List[int]:
    """hashlib's digest of the message, its bits packed little-end first
    into field elements of CAPACITY bits (bellman's multipack)."""
    msg_len = int.from_bytes(block[-8:], "big") // 8
    bits = block_bits(hashlib.sha256(block[:msg_len]).digest())
    return [sum(1 << i for i, bit in enumerate(bits[s : s + CAPACITY]) if bit)
            for s in range(0, len(bits), CAPACITY)]


class Sha256Block(Circuit):
    def synthesize(self, cs) -> None:
        bits = [Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"input bit {i}"), None))
                for i in range(512)]
        digest = sha256_block_no_padding(cs.namespace("sha256"), bits)
        pack_into_inputs(cs.namespace("pack digest"), digest)


def circuit(cfg):
    return Sha256Block()
