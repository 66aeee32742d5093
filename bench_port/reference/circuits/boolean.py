"""Boolean gadgets: allocated bits and boolean logic in-circuit.

Port of bellman/src/gadgets/boolean.rs: `AllocatedBit` with the boolean
constraint (1-a)*a = 0 (:70-99), conditional allocation (:29-66), xor
(:103-151, the (a+a)*b = a+b-c form), and (:155-190), and_not (:193-228),
nor (:231-266); `u64_into_boolean_vec_le` (:269-298),
`field_into_boolean_vec_le` / `field_into_allocated_bits_le` (:300-356); the
`Boolean` enum {Is, Not, Constant} (:358-368) with free negation, `lc`
(:429-448), `enforce_equal` (:375-420) and the constraint-optimized
`sha256_ch` (:515-618: a(b-c) = ch-c) and `sha256_maj` (:622-719:
(2bc-b-c)*a = bc-maj with one AND).

Namespace convention: where the Rust call sites pass
`cs.namespace(|| name)` (RAII-dropped), Python call sites pass
`cs.namespace(name)` and gadget entry points auto-pop it on exit
(the `_consume` helper) — producing identical TestConstraintSystem paths.
"""

from __future__ import annotations

import functools
from typing import List, Optional

from .core import (
    AssignmentMissing,
    ConstraintSystem,
    LinearCombination,
    Namespace,
    Unsatisfiable,
    Variable,
)


def need(value):
    """Option::get()? — raise AssignmentMissing for absent witnesses."""
    if value is None:
        raise AssignmentMissing()
    return value


def _consume(fn):
    """Pop a passed-in Namespace on exit (Rust drop semantics)."""

    @functools.wraps(fn)
    def wrapper(cs, *args, **kwargs):
        try:
            return fn(cs, *args, **kwargs)
        finally:
            if isinstance(cs, Namespace):
                cs.pop()

    return wrapper


class AllocatedBit:
    """A variable constrained to be 0 or 1 (boolean.rs:12-15)."""

    def __init__(self, variable: Variable, value: Optional[bool]):
        self.variable = variable
        self.value = value

    def get_value(self) -> Optional[bool]:
        return self.value

    def get_variable(self) -> Variable:
        return self.variable

    @staticmethod
    @_consume
    def alloc(cs: ConstraintSystem, value: Optional[bool]) -> "AllocatedBit":
        var = cs.alloc("boolean", lambda: 1 if need(value) else 0)
        cs.enforce(
            "boolean constraint",
            lambda lc: lc + cs.one() - var,
            lambda lc: lc + var,
            lambda lc: lc,
        )
        return AllocatedBit(var, value)

    @staticmethod
    @_consume
    def alloc_conditionally(
        cs: ConstraintSystem, value: Optional[bool], must_be_false: "AllocatedBit"
    ) -> "AllocatedBit":
        """(1 - must_be_false - a) * a = 0 (boolean.rs:29-66)."""
        var = cs.alloc("boolean", lambda: 1 if need(value) else 0)
        cs.enforce(
            "boolean constraint",
            lambda lc: lc + cs.one() - must_be_false.variable - var,
            lambda lc: lc + var,
            lambda lc: lc,
        )
        return AllocatedBit(var, value)

    @staticmethod
    @_consume
    def xor(cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = None if a.value is None or b.value is None else a.value ^ b.value
        var = cs.alloc("xor result", lambda: 1 if need(value) else 0)
        # (a + a) * b = a + b - c
        cs.enforce(
            "xor constraint",
            lambda lc: lc + a.variable + a.variable,
            lambda lc: lc + b.variable,
            lambda lc: lc + a.variable + b.variable - var,
        )
        return AllocatedBit(var, value)

    @staticmethod
    @_consume
    def and_(cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = None if a.value is None or b.value is None else a.value and b.value
        var = cs.alloc("and result", lambda: 1 if need(value) else 0)
        cs.enforce(
            "and constraint",
            lambda lc: lc + a.variable,
            lambda lc: lc + b.variable,
            lambda lc: lc + var,
        )
        return AllocatedBit(var, value)

    @staticmethod
    @_consume
    def and_not(cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = (
            None if a.value is None or b.value is None else a.value and not b.value
        )
        var = cs.alloc("and not result", lambda: 1 if need(value) else 0)
        cs.enforce(
            "and not constraint",
            lambda lc: lc + a.variable,
            lambda lc: lc + cs.one() - b.variable,
            lambda lc: lc + var,
        )
        return AllocatedBit(var, value)

    @staticmethod
    @_consume
    def nor(cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = (
            None
            if a.value is None or b.value is None
            else (not a.value) and (not b.value)
        )
        var = cs.alloc("nor result", lambda: 1 if need(value) else 0)
        cs.enforce(
            "nor constraint",
            lambda lc: lc + cs.one() - a.variable,
            lambda lc: lc + cs.one() - b.variable,
            lambda lc: lc + var,
        )
        return AllocatedBit(var, value)


@_consume
def u64_into_boolean_vec_le(cs, value: Optional[int]) -> List["Boolean"]:
    """64 allocated bits, little-endian (boolean.rs:269-298)."""
    values = (
        [bool((value >> i) & 1) for i in range(64)] if value is not None else [None] * 64
    )
    return [
        Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"bit {i}"), b))
        for i, b in enumerate(values)
    ]


@_consume
def field_into_allocated_bits_le(cs, field, value: Optional[int]) -> List[AllocatedBit]:
    """NUM_BITS allocated bits of a field element, LE (boolean.rs:313-356)."""
    n = field.num_bits
    values = (
        [bool((value >> i) & 1) for i in range(n)] if value is not None else [None] * n
    )
    return [
        AllocatedBit.alloc(cs.namespace(f"bit {i}"), b) for i, b in enumerate(values)
    ]


@_consume
def field_into_boolean_vec_le(cs, field, value: Optional[int]) -> List["Boolean"]:
    return [
        Boolean.from_bit(b)
        for b in field_into_allocated_bits_le(cs, field, value)
    ]


class Boolean:
    """Constant / direct / negated view of a bit (boolean.rs:358-368)."""

    IS = "is"
    NOT = "not"
    CONST = "const"

    def __init__(self, kind: str, bit=None, const=None):
        self.kind = kind
        self.bit = bit
        self.const = const

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_bit(bit: AllocatedBit) -> "Boolean":
        return Boolean(Boolean.IS, bit=bit)

    @staticmethod
    def constant(b: bool) -> "Boolean":
        return Boolean(Boolean.CONST, const=b)

    def is_constant(self) -> bool:
        return self.kind == Boolean.CONST

    def not_(self) -> "Boolean":
        if self.kind == Boolean.CONST:
            return Boolean.constant(not self.const)
        return Boolean(
            Boolean.NOT if self.kind == Boolean.IS else Boolean.IS, bit=self.bit
        )

    def get_value(self) -> Optional[bool]:
        if self.kind == Boolean.CONST:
            return self.const
        v = self.bit.get_value()
        if v is None:
            return None
        return v if self.kind == Boolean.IS else not v

    def lc(self, field, coeff: int = 1) -> LinearCombination:
        """Linear-combination view (boolean.rs:429-448)."""
        one = ConstraintSystem.one()
        zero = LinearCombination.zero(field)
        if self.kind == Boolean.CONST:
            return zero + (coeff, one) if self.const else zero
        if self.kind == Boolean.IS:
            return zero + (coeff, self.bit.get_variable())
        return zero + (coeff, one) - (coeff, self.bit.get_variable())

    # -- logic --------------------------------------------------------------
    @staticmethod
    @_consume
    def enforce_equal(cs, a: "Boolean", b: "Boolean") -> None:
        f = cs.field
        if a.is_constant() and b.is_constant():
            if a.const != b.const:
                raise Unsatisfiable()
            return
        if (a.is_constant() and a.const) or (b.is_constant() and b.const):
            x = b if a.is_constant() else a
            cs.enforce(
                "enforce equal to one",
                lambda lc: lc,
                lambda lc: lc,
                lambda lc: (lc + cs.one()) - x.lc(f, 1),
            )
            return
        if (a.is_constant() and not a.const) or (b.is_constant() and not b.const):
            x = b if a.is_constant() else a
            cs.enforce(
                "enforce equal to zero",
                lambda lc: lc,
                lambda lc: lc,
                lambda lc: lc + x.lc(f, 1),
            )
            return
        cs.enforce(
            "enforce equal",
            lambda lc: lc,
            lambda lc: lc,
            lambda lc: lc + a.lc(f, 1) - b.lc(f, 1),
        )

    @staticmethod
    def xor(cs, a: "Boolean", b: "Boolean") -> "Boolean":
        if a.is_constant() and not a.const:
            return b
        if b.is_constant() and not b.const:
            return a
        if a.is_constant() and a.const:
            return b.not_()
        if b.is_constant() and b.const:
            return a.not_()
        if a.kind != b.kind:  # Is ^ Not = !(Is ^ Is)
            is_b, not_b = (a, b) if a.kind == Boolean.IS else (b, a)
            return Boolean.xor(cs, is_b, not_b.not_()).not_()
        return Boolean.from_bit(AllocatedBit.xor(cs, a.bit, b.bit))

    @staticmethod
    def and_(cs, a: "Boolean", b: "Boolean") -> "Boolean":
        if (a.is_constant() and not a.const) or (b.is_constant() and not b.const):
            if isinstance(cs, Namespace):
                cs.pop()
            return Boolean.constant(False)
        if a.is_constant() and a.const:
            if isinstance(cs, Namespace):
                cs.pop()
            return b
        if b.is_constant() and b.const:
            if isinstance(cs, Namespace):
                cs.pop()
            return a
        if a.kind == Boolean.IS and b.kind == Boolean.NOT:
            return Boolean.from_bit(AllocatedBit.and_not(cs, a.bit, b.bit))
        if a.kind == Boolean.NOT and b.kind == Boolean.IS:
            return Boolean.from_bit(AllocatedBit.and_not(cs, b.bit, a.bit))
        if a.kind == Boolean.NOT and b.kind == Boolean.NOT:
            return Boolean.from_bit(AllocatedBit.nor(cs, a.bit, b.bit))
        return Boolean.from_bit(AllocatedBit.and_(cs, a.bit, b.bit))

    @staticmethod
    @_consume
    def sha256_ch(cs, a: "Boolean", b: "Boolean", c: "Boolean") -> "Boolean":
        """(a and b) xor ((not a) and c) in one constraint (boolean.rs:515-618)."""
        va, vb, vc = a.get_value(), b.get_value(), c.get_value()
        ch_value = (
            (va and vb) ^ ((not va) and vc)
            if None not in (va, vb, vc)
            else None
        )
        # constant short-circuits (boolean.rs:536-585)
        if a.is_constant() and b.is_constant() and c.is_constant():
            return Boolean.constant(ch_value)
        if a.is_constant() and not a.const:
            return c
        if b.is_constant() and not b.const:
            return Boolean.and_(cs, a.not_(), c)
        if c.is_constant() and not c.const:
            return Boolean.and_(cs, a, b)
        if c.is_constant() and c.const:
            return Boolean.and_(cs, a, b.not_()).not_()
        if b.is_constant() and b.const:
            return Boolean.and_(cs, a.not_(), c.not_()).not_()
        # (a constant true falls through, as in the reference)

        f = cs.field
        ch = cs.alloc("ch", lambda: 1 if need(ch_value) else 0)
        # a(b - c) = ch - c
        cs.enforce(
            "ch computation",
            lambda lc: lc + b.lc(f, 1) - c.lc(f, 1),
            lambda lc: lc + a.lc(f, 1),
            lambda lc: (lc + ch) - c.lc(f, 1),
        )
        return Boolean.from_bit(AllocatedBit(ch, ch_value))

    @staticmethod
    @_consume
    def sha256_maj(cs, a: "Boolean", b: "Boolean", c: "Boolean") -> "Boolean":
        """(a and b) xor (a and c) xor (b and c) (boolean.rs:622-719)."""
        va, vb, vc = a.get_value(), b.get_value(), c.get_value()
        maj_value = (
            (va and vb) ^ (va and vc) ^ (vb and vc)
            if None not in (va, vb, vc)
            else None
        )
        if a.is_constant() and b.is_constant() and c.is_constant():
            return Boolean.constant(maj_value)
        if a.is_constant() and not a.const:
            return Boolean.and_(cs, b, c)
        if b.is_constant() and not b.const:
            return Boolean.and_(cs, a, c)
        if c.is_constant() and not c.const:
            return Boolean.and_(cs, a, b)
        if c.is_constant() and c.const:
            return Boolean.and_(cs, a.not_(), b.not_()).not_()
        if b.is_constant() and b.const:
            return Boolean.and_(cs, a.not_(), c.not_()).not_()
        if a.is_constant() and a.const:
            return Boolean.and_(cs, b.not_(), c.not_()).not_()

        f = cs.field
        maj = cs.alloc("maj", lambda: 1 if need(maj_value) else 0)
        bc = Boolean.and_(cs.namespace("b and c"), b, c)
        # (2bc - b - c) * a = bc - maj
        cs.enforce(
            "maj computation",
            lambda lc: lc
            + bc.lc(f, 2)
            - b.lc(f, 1)
            - c.lc(f, 1),
            lambda lc: lc + a.lc(f, 1),
            lambda lc: lc + bc.lc(f, 1) - maj,
        )
        return Boolean.from_bit(AllocatedBit(maj, maj_value))
