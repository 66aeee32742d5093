"""R1CS circuit IR: variables, linear combinations, constraint systems.

Python re-design of the reference's constraint-system core
(bellman/src/lib.rs:203-623): `Circuit::synthesize` (lib.rs:207-210),
`Variable`/`Index` (lib.rs:212-236), `LinearCombination` with the full set of
operator overloads (lib.rs:241-350), the `ConstraintSystem` trait surface
(lib.rs:431-494), RAII `Namespace` (lib.rs:498-566, here a context manager),
and the `SynthesisError` (lib.rs:355-403) / `VerificationError` (lib.rs:406-427)
taxonomies.

Field elements are plain Python ints in [0, p); each constraint system is
bound to a host `PrimeField` which supplies the modulus.  Synthesis is pure
host work (sparse, pointer-chasing — same placement as the reference); the
assembled sparse QAP tables are later bulk-converted to device limb arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

from ..fields.host import PrimeField


# --------------------------------------------------------------------- errors
class SynthesisError(Exception):
    """Base of the synthesis error taxonomy (lib.rs:355-370)."""


class AssignmentMissing(SynthesisError):
    """Lacked knowledge of a variable assignment."""


class DivisionByZero(SynthesisError):
    """Division by zero during synthesis."""


class Unsatisfiable(SynthesisError):
    """Constructed an unsatisfiable constraint system."""


class PolynomialDegreeTooLarge(SynthesisError):
    """Polynomial degree exceeds the field's 2-adic domain capacity."""


class UnexpectedIdentity(SynthesisError):
    """Encountered an identity element in the CRS."""


class IoError(SynthesisError):
    """I/O error with the CRS."""


class UnconstrainedVariable(SynthesisError):
    """An auxiliary variable was unconstrained during CRS generation."""


class VerificationError(Exception):
    """Base of the verification error taxonomy (lib.rs:406-412)."""


class InvalidVerifyingKey(VerificationError):
    pass


class InvalidProof(VerificationError):
    pass


# ------------------------------------------------------------------ variables
INPUT = "input"
AUX = "aux"


@dataclass(frozen=True)
class Variable:
    """A wire: either a public input or an auxiliary witness (lib.rs:212-236)."""

    kind: str  # INPUT or AUX
    index: int

    def __repr__(self) -> str:
        tag = "Input" if self.kind == INPUT else "Aux"
        return f"Variable({tag}({self.index}))"


ONE = Variable(INPUT, 0)


# -------------------------------------------------------- linear combinations
_Term = Tuple[Variable, int]


class LinearCombination:
    """An ordered list of (variable, coefficient) terms (lib.rs:241-350).

    Mirrors the reference's operator surface:
        lc + var            lc - var
        lc + (coeff, var)   lc - (coeff, var)
        lc + other_lc       lc - other_lc
        lc + (coeff, lc2)   lc - (coeff, lc2)
    Terms are kept in insertion order (like the Vec push in lib.rs:258-260);
    normalization/merging happens only at consumption sites.
    """

    __slots__ = ("field", "terms")

    def __init__(self, field: PrimeField, terms: Optional[List[_Term]] = None):
        self.field = field
        self.terms = list(terms) if terms else []

    @staticmethod
    def zero(field: PrimeField) -> "LinearCombination":
        return LinearCombination(field)

    def _with(self, extra: List[_Term]) -> "LinearCombination":
        return LinearCombination(self.field, self.terms + extra)

    def _coerce(self, other, sign: int) -> "LinearCombination":
        f = self.field
        if isinstance(other, Variable):
            return self._with([(other, sign % f.p)])
        if isinstance(other, LinearCombination):
            return self._with([(v, c * sign % f.p) for (v, c) in other.terms])
        if isinstance(other, tuple) and len(other) == 2:
            coeff, target = other
            coeff = coeff % f.p
            if isinstance(target, Variable):
                return self._with([(target, coeff * sign % f.p)])
            if isinstance(target, LinearCombination):
                return self._with(
                    [(v, c * coeff * sign % f.p) for (v, c) in target.terms]
                )
        return NotImplemented

    def __add__(self, other):
        return self._coerce(other, 1)

    def __sub__(self, other):
        return self._coerce(other, -1)

    def eval(self, input_assignment: List[int], aux_assignment: List[int]) -> int:
        """Evaluate against assignments (cf. prover eval, prover.rs:19-53)."""
        f = self.field
        acc = 0
        for var, coeff in self.terms:
            val = (
                input_assignment[var.index]
                if var.kind == INPUT
                else aux_assignment[var.index]
            )
            acc += val * coeff
        return acc % f.p

    def __repr__(self) -> str:
        return f"LC({self.terms})"


LcFn = Callable[[LinearCombination], LinearCombination]


def _annotation_str(annotation) -> str:
    return annotation() if callable(annotation) else str(annotation)


# ---------------------------------------------------------- constraint system
class ConstraintSystem:
    """The trait surface circuits synthesize into (lib.rs:431-494)."""

    def __init__(self, field: PrimeField):
        self.field = field

    @staticmethod
    def one() -> Variable:
        return ONE

    def lc(self) -> LinearCombination:
        return LinearCombination.zero(self.field)

    # Subclasses implement:
    def alloc(self, annotation, f: Callable[[], int]) -> Variable:
        raise NotImplementedError

    def alloc_input(self, annotation, f: Callable[[], int]) -> Variable:
        raise NotImplementedError

    def enforce(self, annotation, a: LcFn, b: LcFn, c: LcFn) -> None:
        raise NotImplementedError

    def push_namespace(self, name: str) -> None:
        raise NotImplementedError

    def pop_namespace(self) -> None:
        raise NotImplementedError

    def get_root(self) -> "ConstraintSystem":
        return self

    def namespace(self, name) -> "Namespace":
        root = self.get_root()
        root.push_namespace(_annotation_str(name))
        return Namespace(root)


class Namespace(ConstraintSystem):
    """Scoped view that pops its namespace on exit (lib.rs:498-566).

    Usable both as a context manager (`with cs.namespace("x") as ns:`) and as
    a plain prefix object that auto-pops when consumed by gadget helpers.
    """

    def __init__(self, root: ConstraintSystem):
        super().__init__(root.field)
        self.root = root
        self._popped = False

    def __enter__(self) -> "Namespace":
        return self

    def __exit__(self, *exc) -> None:
        self.pop()

    def pop(self) -> None:
        if not self._popped:
            self.root.pop_namespace()
            self._popped = True

    def alloc(self, annotation, f):
        return self.root.alloc(annotation, f)

    def alloc_input(self, annotation, f):
        return self.root.alloc_input(annotation, f)

    def enforce(self, annotation, a, b, c):
        return self.root.enforce(annotation, a, b, c)

    def push_namespace(self, name: str) -> None:
        self.root.push_namespace(name)

    def pop_namespace(self) -> None:
        self.root.pop_namespace()

    def get_root(self) -> ConstraintSystem:
        return self.root


class Circuit:
    """A synthesizable circuit (lib.rs:207-210)."""

    def synthesize(self, cs: ConstraintSystem) -> None:
        raise NotImplementedError
