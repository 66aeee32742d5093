"""The prime field the frozen circuits are written against: its modulus
and bit sizes, all that the gadgets read of it."""

from __future__ import annotations


class PrimeField:
    def __init__(self, modulus: int, name: str = "F"):
        self.p = modulus
        self.name = name
        self.num_bits = modulus.bit_length()
        self.capacity = self.num_bits - 1
