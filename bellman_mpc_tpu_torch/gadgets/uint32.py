"""UInt32: a 32-bit word over Booleans (little-endian bits).

Port of bellman/src/gadgets/uint32.rs: constant/alloc (:25-77), be/le bit
conversions (:79-165), free rotr (:166-182) / shr (:184-205), sha256
triop mappings (:240-282), xor (:283-306), and `addmany` modular
multi-operand addition with carry-bit allocation enforced through MultiEq
(:308-404).
"""

from __future__ import annotations

from typing import List, Optional

from ..r1cs.core import LinearCombination
from .boolean import AllocatedBit, Boolean, _consume
from .multieq import MultiEq


class UInt32:
    def __init__(self, bits: List[Boolean], value: Optional[int]):
        self.bits = bits  # LSB first
        self.value = value

    @staticmethod
    def constant(value: int) -> "UInt32":
        value &= 0xFFFFFFFF
        return UInt32(
            [Boolean.constant(bool((value >> i) & 1)) for i in range(32)], value
        )

    @staticmethod
    @_consume
    def alloc(cs, value: Optional[int]) -> "UInt32":
        values = (
            [bool((value >> i) & 1) for i in range(32)]
            if value is not None
            else [None] * 32
        )
        bits = [
            Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"allocated bit {i}"), v))
            for i, v in enumerate(values)
        ]
        return UInt32(bits, value)

    def into_bits_be(self) -> List[Boolean]:
        return list(reversed(self.bits))

    @staticmethod
    def from_bits_be(bits: List[Boolean]) -> "UInt32":
        assert len(bits) == 32
        value = 0
        for b in bits:
            v = b.get_value()
            if v is None:
                value = None
                break
            value = ((value << 1) | int(v)) & 0xFFFFFFFF
        return UInt32(list(reversed(bits)), value)

    def into_bits(self) -> List[Boolean]:
        return list(self.bits)

    @staticmethod
    def from_bits(bits: List[Boolean]) -> "UInt32":
        assert len(bits) == 32
        value = 0
        for b in reversed(bits):
            v = b.get_value()
            if v is None:
                value = None
                break
            value = ((value << 1) | int(v)) & 0xFFFFFFFF
        return UInt32(list(bits), value)

    def rotr(self, by: int) -> "UInt32":
        by %= 32
        new_bits = (self.bits[by:] + self.bits)[:32]
        value = (
            ((self.value >> by) | (self.value << (32 - by))) & 0xFFFFFFFF
            if self.value is not None and by
            else self.value
        )
        return UInt32(new_bits, value)

    def shr(self, by: int) -> "UInt32":
        by %= 32
        fill = Boolean.constant(False)
        new_bits = (self.bits[by:] + [fill] * 32)[:32]
        value = (self.value >> by) if self.value is not None else None
        return UInt32(new_bits, value)

    @staticmethod
    def _triop(cs, a: "UInt32", b: "UInt32", c: "UInt32", tri_fn, circuit_fn, name):
        value = (
            tri_fn(a.value, b.value, c.value)
            if None not in (a.value, b.value, c.value)
            else None
        )
        bits = [
            circuit_fn(cs.namespace(f"{name} {i}"), x, y, z)
            for i, (x, y, z) in enumerate(zip(a.bits, b.bits, c.bits))
        ]
        return UInt32(bits, value)

    @staticmethod
    @_consume
    def sha256_maj(cs, a: "UInt32", b: "UInt32", c: "UInt32") -> "UInt32":
        return UInt32._triop(
            cs, a, b, c,
            lambda x, y, z: (x & y) ^ (x & z) ^ (y & z),
            Boolean.sha256_maj,
            "maj",
        )

    @staticmethod
    @_consume
    def sha256_ch(cs, a: "UInt32", b: "UInt32", c: "UInt32") -> "UInt32":
        return UInt32._triop(
            cs, a, b, c,
            lambda x, y, z: (x & y) ^ ((~x & 0xFFFFFFFF) & z),
            Boolean.sha256_ch,
            "ch",
        )

    def xor(self, cs, other: "UInt32") -> "UInt32":
        from ..r1cs.core import Namespace

        try:
            value = (
                self.value ^ other.value
                if self.value is not None and other.value is not None
                else None
            )
            bits = [
                Boolean.xor(cs.namespace(f"xor of bit {i}"), a, b)
                for i, (a, b) in enumerate(zip(self.bits, other.bits))
            ]
            return UInt32(bits, value)
        finally:
            if isinstance(cs, Namespace):
                cs.pop()

    @staticmethod
    @_consume
    def addmany(cs, operands: List["UInt32"]) -> "UInt32":
        """Modular addition via one MultiEq-packed equality (uint32.rs:308-404).

        `cs` must be (rooted in) a MultiEq.
        """
        field = cs.field
        assert field.num_bits >= 64
        assert 2 <= len(operands) <= 10

        max_value = len(operands) * 0xFFFFFFFF
        result_value = 0
        all_constants = True
        lc = LinearCombination.zero(field)
        for op in operands:
            if op.value is None:
                result_value = None
            elif result_value is not None:
                result_value += op.value
            coeff = 1
            for bit in op.bits:
                lc = lc + bit.lc(field, coeff)
                all_constants &= bit.is_constant()
                coeff = coeff * 2 % field.p

        modular_value = result_value & 0xFFFFFFFF if result_value is not None else None
        if all_constants and modular_value is not None:
            return UInt32.constant(modular_value)

        result_bits: List[Boolean] = []
        result_lc = LinearCombination.zero(field)
        coeff = 1
        i = 0
        while max_value != 0:
            b = AllocatedBit.alloc(
                cs.namespace(f"result bit {i}"),
                bool((result_value >> i) & 1) if result_value is not None else None,
            )
            result_lc = result_lc + (coeff, b.get_variable())
            result_bits.append(Boolean.from_bit(b))
            max_value >>= 1
            i += 1
            coeff = coeff * 2 % field.p

        root = cs.get_root()
        assert isinstance(root, MultiEq), "addmany requires a MultiEq-rooted CS"
        root.enforce_equal(i, lc, result_lc)

        return UInt32(result_bits[:32], modular_value)
