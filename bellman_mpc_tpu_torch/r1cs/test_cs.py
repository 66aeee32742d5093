"""TestConstraintSystem — the named, inspectable CS used to test gadgets.

Byte-exact port of the reference harness (bellman/src/gadgets/test/mod.rs):
named variable/constraint registry (:31-37), `pretty_print` (:163-224), the
blake2s structural `hash()` of the whole constraint system (:226-249) —
including the exact serialization (u64 big-endian lengths, 'I'/'A' tags,
big-endian coefficient bytes, input-before-aux ordering) so hash values can
be compared against the reference's pinned hex literals —
`which_is_unsatisfied` (:251-265), `is_satisfied` (:267-269), `set`/`get` by
path (:275-325), and `verify(expected_inputs)` (:289-299).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from ..fields.host import PrimeField
from .core import (
    AUX,
    INPUT,
    ConstraintSystem,
    LinearCombination,
    Variable,
    _annotation_str,
)


def _proc_lc(lc: LinearCombination) -> List[Tuple[Variable, int]]:
    """Merge duplicate variables, drop zero coefficients, sort inputs-first.

    Mirrors proc_lc at gadgets/test/mod.rs:68-89 (BTreeMap ordering:
    Input(i) < Aux(j) for all i, j; ascending index within each kind).
    """
    p = lc.field.p
    acc: Dict[Variable, int] = {}
    for var, coeff in lc.terms:
        acc[var] = (acc.get(var, 0) + coeff) % p
    items = [(v, c) for (v, c) in acc.items() if c != 0]
    items.sort(key=lambda vc: (0 if vc[0].kind == INPUT else 1, vc[0].index))
    return items


def _coeff_repr_len(field: PrimeField) -> int:
    # bls12-381 Fr repr is 32 bytes; the mock field uses a u64 repr
    # (dummy_engine.rs:257). Generalize: at least 8 bytes.
    return max(8, (field.num_bits + 7) // 8)


class TestConstraintSystem(ConstraintSystem):
    __test__ = False  # not a pytest class

    def __init__(self, field: PrimeField):
        super().__init__(field)
        self.named_objects: Dict[str, object] = {"ONE": ("var", Variable(INPUT, 0))}
        self.current_namespace: List[str] = []
        # constraints: (a, b, c, path)
        self.constraints: List[Tuple[LinearCombination, LinearCombination, LinearCombination, str]] = []
        self.inputs: List[Tuple[int, str]] = [(1, "ONE")]
        self.aux: List[Tuple[int, str]] = []

    # ---------------------------------------------------------------- naming
    def _compute_path(self, this: str) -> str:
        if "/" in this:
            raise ValueError("'/' is not allowed in names")
        return "/".join(self.current_namespace + [this])

    def _set_named_obj(self, path: str, obj) -> None:
        if path in self.named_objects:
            raise ValueError(f"tried to create object at existing path: {path}")
        self.named_objects[path] = obj

    # ------------------------------------------------------------ CS surface
    def alloc(self, annotation, f) -> Variable:
        index = len(self.aux)
        path = self._compute_path(_annotation_str(annotation))
        self.aux.append((f() % self.field.p, path))
        var = Variable(AUX, index)
        self._set_named_obj(path, ("var", var))
        return var

    def alloc_input(self, annotation, f) -> Variable:
        index = len(self.inputs)
        path = self._compute_path(_annotation_str(annotation))
        self.inputs.append((f() % self.field.p, path))
        var = Variable(INPUT, index)
        self._set_named_obj(path, ("var", var))
        return var

    def enforce(self, annotation, a, b, c) -> None:
        path = self._compute_path(_annotation_str(annotation))
        index = len(self.constraints)
        self._set_named_obj(path, ("constraint", index))
        zero = LinearCombination.zero(self.field)
        self.constraints.append(
            (a(zero), b(zero), c(zero), path)
        )

    def push_namespace(self, name: str) -> None:
        path = self._compute_path(name)
        self._set_named_obj(path, ("namespace",))
        self.current_namespace.append(name)

    def pop_namespace(self) -> None:
        assert self.current_namespace, "pop on empty namespace stack"
        self.current_namespace.pop()

    # ------------------------------------------------------------ inspection
    def _eval_lc(self, lc: LinearCombination) -> int:
        acc = 0
        for var, coeff in lc.terms:
            val = (
                self.inputs[var.index][0]
                if var.kind == INPUT
                else self.aux[var.index][0]
            )
            acc += val * coeff
        return acc % self.field.p

    def which_is_unsatisfied(self) -> Optional[str]:
        for a, b, c, path in self.constraints:
            if self._eval_lc(a) * self._eval_lc(b) % self.field.p != self._eval_lc(c):
                return path
        return None

    def is_satisfied(self) -> bool:
        return self.which_is_unsatisfied() is None

    def num_constraints(self) -> int:
        return len(self.constraints)

    def num_inputs(self) -> int:
        return len(self.inputs)

    def set(self, path: str, to: int) -> None:
        obj = self.named_objects.get(path)
        if obj is None:
            raise KeyError(f"no variable exists at path: {path}")
        if not (isinstance(obj, tuple) and obj[0] == "var"):
            raise ValueError(
                f"tried to set path `{path}` to value, but `{obj}` already exists there."
            )
        var = obj[1]
        if var.kind == INPUT:
            self.inputs[var.index] = (to % self.field.p, self.inputs[var.index][1])
        else:
            self.aux[var.index] = (to % self.field.p, self.aux[var.index][1])

    def get(self, path: str) -> int:
        obj = self.named_objects.get(path)
        if obj is None:
            raise KeyError(f"no variable exists at path: {path}")
        if not (isinstance(obj, tuple) and obj[0] == "var"):
            raise ValueError(
                f"tried to get value of path `{path}`, but `{obj}` exists there (not a variable)"
            )
        var = obj[1]
        return (
            self.inputs[var.index][0] if var.kind == INPUT else self.aux[var.index][0]
        )

    def get_input(self, index: int, path: str) -> int:
        value, name = self.inputs[index]
        assert path == name, f"{path} != {name}"
        return value

    def verify(self, expected: List[int]) -> bool:
        assert len(expected) + 1 == len(self.inputs)
        return all(
            a[0] == e % self.field.p for a, e in zip(self.inputs[1:], expected)
        )

    # ------------------------------------------------------- structural hash
    def hash(self) -> str:
        """blake2s-256 over the CS structure (gadgets/test/mod.rs:226-249)."""
        h = hashlib.blake2s(digest_size=32)
        h.update(len(self.inputs).to_bytes(8, "big"))
        h.update(len(self.aux).to_bytes(8, "big"))
        h.update(len(self.constraints).to_bytes(8, "big"))
        rlen = _coeff_repr_len(self.field)
        for a, b, c, _path in self.constraints:
            for lc in (a, b, c):
                items = _proc_lc(lc)
                h.update(len(items).to_bytes(8, "big"))
                for var, coeff in items:
                    tag = b"I" if var.kind == INPUT else b"A"
                    # little-endian repr flipped to big-endian, as in
                    # gadgets/test/mod.rs:110-114
                    h.update(tag + var.index.to_bytes(8, "big"))
                    h.update(coeff.to_bytes(rlen, "little")[::-1])
        return h.hexdigest()

    # ---------------------------------------------------------- pretty print
    def pretty_print(self) -> str:
        f = self.field
        negone = f.p - 1
        powers_of_two = [pow(2, i, f.p) for i in range(f.num_bits)]

        def pp(lc: LinearCombination) -> str:
            out = ["("]
            first = True
            for var, coeff in _proc_lc(lc):
                if coeff == negone:
                    out.append(" - ")
                elif not first:
                    out.append(" + ")
                first = False
                if coeff not in (1, negone):
                    for i, x in enumerate(powers_of_two):
                        if x == coeff:
                            out.append(f"2^{i} . ")
                            break
                    out.append(f"{coeff:#x} . ")
                name = (
                    self.inputs[var.index][1]
                    if var.kind == INPUT
                    else self.aux[var.index][1]
                )
                out.append(f"`{name}`")
            if first:
                out.append("0")
            out.append(")")
            return "".join(out)

        lines = []
        for a, b, c, name in self.constraints:
            lines.append(f"\n{name}: {pp(a)} * {pp(b)} = {pp(c)}")
        return "".join(lines) + "\n"
