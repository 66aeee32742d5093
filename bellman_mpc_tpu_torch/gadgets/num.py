"""Field-element gadgets: AllocatedNum and the lazy Num accumulator.

Port of bellman/src/gadgets/num.rs: `AllocatedNum` alloc (:26-47), inputize
(:49-63), strict little-endian bit decomposition rejecting non-canonical
representations via k-ary ANDs over the runs of ones in (r-1) (:70-198),
`to_bits_le` (:199-223), mul (:224-255), square (:256-285), assert_nonzero
via an ephemeral inverse witness (:287-318), conditionally_reverse
(:320-360); the lazy `Num` linear-combination accumulator (:371-407).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..r1cs.core import ConstraintSystem, DivisionByZero, LinearCombination, Variable
from .boolean import AllocatedBit, Boolean, _consume, need


class AllocatedNum:
    def __init__(self, value: Optional[int], variable: Variable):
        self.value = value
        self.variable = variable

    def get_value(self) -> Optional[int]:
        return self.value

    def get_variable(self) -> Variable:
        return self.variable

    @staticmethod
    @_consume
    def alloc(cs: ConstraintSystem, value_fn) -> "AllocatedNum":
        holder = {}

        def f():
            v = value_fn() % cs.field.p
            holder["v"] = v
            return v

        var = cs.alloc("num", f)
        return AllocatedNum(holder.get("v"), var)

    @staticmethod
    @_consume
    def alloc_value(cs: ConstraintSystem, value: Optional[int]) -> "AllocatedNum":
        """Convenience: allocate from an optional concrete value."""
        return AllocatedNum.alloc(cs, lambda: need(value))

    @_consume
    def inputize(self, cs: ConstraintSystem) -> None:
        """Expose as a public input with an equality constraint (num.rs:49-63)."""
        input_var = cs.alloc_input("input variable", lambda: need(self.value))
        cs.enforce(
            "enforce input is correct",
            lambda lc: lc + input_var,
            lambda lc: lc + cs.one(),
            lambda lc: lc + self.variable,
        )

    # `self` is the first arg; wrap manually for namespace consumption.
    def to_bits_le_strict(self, cs) -> List[Boolean]:
        """Strict decomposition: representation must be < r (num.rs:70-198)."""
        try:
            return self._to_bits_le_strict(cs)
        finally:
            from ..r1cs.core import Namespace

            if isinstance(cs, Namespace):
                cs.pop()

    def _to_bits_le_strict(self, cs) -> List[Boolean]:
        field = cs.field

        def kary_and(cs, v: List[AllocatedBit]) -> AllocatedBit:
            assert v
            cur = v[0]
            for i, bit in enumerate(v):
                if i == 0:
                    continue
                cur = AllocatedBit.and_(cs.namespace(f"and {i}"), cur, bit)
            return cur

        n = field.num_bits
        char_minus_one = field.p - 1
        a_bits = (
            [bool((self.value >> j) & 1) for j in range(n)][::-1]
            if self.value is not None
            else [None] * n
        )  # big-endian
        b_bits = [bool((char_minus_one >> j) & 1) for j in range(n)][::-1]

        result: List[AllocatedBit] = []
        last_run: Optional[AllocatedBit] = None
        current_run: List[AllocatedBit] = []
        i = 0
        for b, a_bit in zip(b_bits, a_bits):
            if b:
                bit = AllocatedBit.alloc(cs.namespace(f"bit {i}"), a_bit)
                current_run.append(bit)
                result.append(bit)
            else:
                if current_run:
                    if last_run is not None:
                        current_run.append(last_run)
                    last_run = kary_and(
                        cs.namespace(f"run ending at {i}"), current_run
                    )
                    current_run = []
                bit = AllocatedBit.alloc_conditionally(
                    cs.namespace(f"bit {i}"), a_bit, last_run
                )
                result.append(bit)
            i += 1
        assert not current_run  # r is prime: always ends on a zero run

        # unpacking constraint: sum 2^j bit_j - self = 0
        lc = LinearCombination.zero(field)
        coeff = 1
        for bit in reversed(result):
            lc = lc + (coeff, bit.get_variable())
            coeff = coeff * 2 % field.p
        lc = lc - self.variable
        cs.enforce("unpacking constraint", lambda l: l, lambda l: l, lambda l: l + lc)

        return [Boolean.from_bit(b) for b in reversed(result)]

    def to_bits_le(self, cs) -> List[Boolean]:
        """Non-strict decomposition (num.rs:199-223)."""
        from ..r1cs.core import Namespace
        from .boolean import field_into_allocated_bits_le

        try:
            field = cs.field
            bits = field_into_allocated_bits_le(cs, field, self.value)
            lc = LinearCombination.zero(field)
            coeff = 1
            for bit in bits:
                lc = lc + (coeff, bit.get_variable())
                coeff = coeff * 2 % field.p
            lc = lc - self.variable
            cs.enforce(
                "unpacking constraint", lambda l: l, lambda l: l, lambda l: l + lc
            )
            return [Boolean.from_bit(b) for b in bits]
        finally:
            if isinstance(cs, Namespace):
                cs.pop()

    def mul(self, cs, other: "AllocatedNum") -> "AllocatedNum":
        from ..r1cs.core import Namespace

        try:
            p = cs.field.p
            value = (
                self.value * other.value % p
                if self.value is not None and other.value is not None
                else None
            )
            var = cs.alloc("product num", lambda: need(value))
            cs.enforce(
                "multiplication constraint",
                lambda lc: lc + self.variable,
                lambda lc: lc + other.variable,
                lambda lc: lc + var,
            )
            return AllocatedNum(value, var)
        finally:
            if isinstance(cs, Namespace):
                cs.pop()

    def square(self, cs) -> "AllocatedNum":
        from ..r1cs.core import Namespace

        try:
            p = cs.field.p
            value = self.value * self.value % p if self.value is not None else None
            var = cs.alloc("squared num", lambda: need(value))
            cs.enforce(
                "squaring constraint",
                lambda lc: lc + self.variable,
                lambda lc: lc + self.variable,
                lambda lc: lc + var,
            )
            return AllocatedNum(value, var)
        finally:
            if isinstance(cs, Namespace):
                cs.pop()

    def assert_nonzero(self, cs) -> None:
        from ..r1cs.core import Namespace

        try:
            p = cs.field.p

            def inv_fn():
                v = need(self.value) % p
                if v == 0:
                    raise DivisionByZero()
                return pow(v, p - 2, p)

            inv = cs.alloc("ephemeral inverse", inv_fn)
            cs.enforce(
                "nonzero assertion constraint",
                lambda lc: lc + self.variable,
                lambda lc: lc + inv,
                lambda lc: lc + cs.one(),
            )
        finally:
            if isinstance(cs, Namespace):
                cs.pop()

    @staticmethod
    @_consume
    def conditionally_reverse(
        cs, a: "AllocatedNum", b: "AllocatedNum", condition: Boolean
    ) -> Tuple["AllocatedNum", "AllocatedNum"]:
        """(b, a) if condition else (a, b) (num.rs:320-360)."""
        f = cs.field

        c = AllocatedNum.alloc(
            cs.namespace("conditional reversal result 1"),
            lambda: need(b.value) if need(condition.get_value()) else need(a.value),
        )
        cs.enforce(
            "first conditional reversal",
            lambda lc: lc + a.variable - b.variable,
            lambda lc: lc + condition.lc(f, 1),
            lambda lc: lc + a.variable - c.variable,
        )
        d = AllocatedNum.alloc(
            cs.namespace("conditional reversal result 2"),
            lambda: need(a.value) if need(condition.get_value()) else need(b.value),
        )
        cs.enforce(
            "second conditional reversal",
            lambda lc: lc + b.variable - a.variable,
            lambda lc: lc + condition.lc(f, 1),
            lambda lc: lc + b.variable - d.variable,
        )
        return c, d


class Num:
    """Lazy linear-combination accumulator (num.rs:371-407)."""

    def __init__(self, field, value: Optional[int], lc: LinearCombination):
        self.field = field
        self.value = value
        self._lc = lc

    @staticmethod
    def zero(field) -> "Num":
        return Num(field, 0, LinearCombination.zero(field))

    @staticmethod
    def from_allocated(num: AllocatedNum, field) -> "Num":
        return Num(field, num.value, LinearCombination.zero(field) + num.variable)

    def get_value(self) -> Optional[int]:
        return self.value

    def lc(self, coeff: int) -> LinearCombination:
        return LinearCombination.zero(self.field) + (coeff, self._lc)

    def add_bool_with_coeff(self, one: Variable, bit: Boolean, coeff: int) -> "Num":
        bval = bit.get_value()
        newval = (
            (self.value + (coeff if bval else 0)) % self.field.p
            if self.value is not None and bval is not None
            else None
        )
        return Num(self.field, newval, self._lc + bit.lc(self.field, coeff))
