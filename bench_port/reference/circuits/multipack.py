"""Packing bit vectors into field-capacity public inputs.

Port of bellman/src/gadgets/multipack.rs: `pack_into_inputs` (:11-37),
`bytes_to_bits` / `bytes_to_bits_le` (:39-51), `compute_multipacking`
(:53-72).
"""

from __future__ import annotations

from typing import List

from .core import ConstraintSystem
from .boolean import Boolean, _consume, need
from .num import Num


@_consume
def pack_into_inputs(cs: ConstraintSystem, bits: List[Boolean]) -> None:
    field = cs.field
    cap = field.capacity
    for idx, start in enumerate(range(0, len(bits), cap)):
        chunk = bits[start : start + cap]
        num = Num.zero(field)
        coeff = 1
        for bit in chunk:
            num = num.add_bool_with_coeff(cs.one(), bit, coeff)
            coeff = coeff * 2 % field.p
        input_var = cs.alloc_input(f"input {idx}", lambda: need(num.get_value()))
        cs.enforce(
            f"packing constraint {idx}",
            lambda lc: lc + num.lc(1),
            lambda lc: lc + cs.one(),
            lambda lc: lc + input_var,
        )


def bytes_to_bits(data: bytes) -> List[bool]:
    return [bool((v >> i) & 1) for v in data for i in range(7, -1, -1)]


def bytes_to_bits_le(data: bytes) -> List[bool]:
    return [bool((v >> i) & 1) for v in data for i in range(8)]


def compute_multipacking(field, bits: List[bool]) -> List[int]:
    out = []
    cap = field.capacity
    for start in range(0, len(bits), cap):
        cur = 0
        coeff = 1
        for bit in bits[start : start + cap]:
            if bit:
                cur = (cur + coeff) % field.p
            coeff = coeff * 2 % field.p
        out.append(cur)
    return out
