"""MultiEq: pack many fixed-width equalities into single field constraints.

Port of bellman/src/gadgets/multieq.rs: accumulates lhs/rhs linear
combinations shifted by 2^bits_used until Scalar::CAPACITY bits are exhausted
(:40-57), emitting one `multieq {n}` constraint per flush (:25-38, drop-flush
:60-66).  Acts as a ConstraintSystem wrapper; in Python use it as a context
manager (`with MultiEq(cs) as mcs:`) — exit flushes.
"""

from __future__ import annotations

from .core import ConstraintSystem, LinearCombination


class MultiEq(ConstraintSystem):
    def __init__(self, cs: ConstraintSystem):
        super().__init__(cs.field)
        self.cs = cs
        self.ops = 0
        self.bits_used = 0
        self.lhs = LinearCombination.zero(cs.field)
        self.rhs = LinearCombination.zero(cs.field)

    def _accumulate(self) -> None:
        ops = self.ops
        lhs, rhs = self.lhs, self.rhs
        self.cs.enforce(
            f"multieq {ops}",
            lambda lc: lc + lhs,
            lambda lc: lc + self.one(),
            lambda lc: lc + rhs,
        )
        self.lhs = LinearCombination.zero(self.field)
        self.rhs = LinearCombination.zero(self.field)
        self.bits_used = 0
        self.ops += 1

    def enforce_equal(
        self, num_bits: int, lhs: LinearCombination, rhs: LinearCombination
    ) -> None:
        if self.field.capacity <= self.bits_used + num_bits:
            self._accumulate()
        assert self.field.capacity > self.bits_used + num_bits
        coeff = pow(2, self.bits_used, self.field.p)
        self.lhs = self.lhs + (coeff, lhs)
        self.rhs = self.rhs + (coeff, rhs)
        self.bits_used += num_bits

    # -- context manager (Rust drop) ----------------------------------------
    def __enter__(self) -> "MultiEq":
        return self

    def __exit__(self, *exc) -> None:
        if self.bits_used > 0:
            self._accumulate()

    # -- CS delegation ------------------------------------------------------
    def alloc(self, annotation, f):
        return self.cs.alloc(annotation, f)

    def alloc_input(self, annotation, f):
        return self.cs.alloc_input(annotation, f)

    def enforce(self, annotation, a, b, c):
        return self.cs.enforce(annotation, a, b, c)

    def push_namespace(self, name: str) -> None:
        self.cs.get_root().push_namespace(name)

    def pop_namespace(self) -> None:
        self.cs.get_root().pop_namespace()

    def get_root(self):
        return self
