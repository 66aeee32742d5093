"""Synthesis targets: QAP assembly (setup) and witness assignment (proving).

Ports the two ConstraintSystem implementations the protocol synthesizes
circuits into:

  * `KeypairAssembly` (bellman/src/groth16/generator.rs:44-156): records the
    sparse QAP columns at/bt/ct per variable as (coeff, constraint) entries.
  * `ProvingAssignment` (bellman/src/groth16/prover.rs:55-156): evaluates
    each constraint's A/B/C linear combinations against the witness and
    tracks query densities.
  * `DensityTracker` (bellman/src/multiexp.rs:117-157): boolean usage map of
    variables in a query, so zero-density CRS bases are skipped.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

from ..fields.host import PrimeField
from ..r1cs.core import AUX, INPUT, ConstraintSystem, LinearCombination, Variable


class DensityTracker:
    def __init__(self):
        self.bv: List[bool] = []
        self.total_density = 0

    def add_element(self) -> None:
        self.bv.append(False)

    def inc(self, idx: int) -> None:
        if not self.bv[idx]:
            self.bv[idx] = True
            self.total_density += 1

    def get_total_density(self) -> int:
        return self.total_density


class KeypairAssembly(ConstraintSystem):
    """Sparse QAP table builder (generator.rs:44-156)."""

    def __init__(self, field: PrimeField):
        super().__init__(field)
        self.num_inputs = 0
        self.num_aux = 0
        self.num_constraints = 0
        self.at_inputs: List[List[Tuple[int, int]]] = []
        self.bt_inputs: List[List[Tuple[int, int]]] = []
        self.ct_inputs: List[List[Tuple[int, int]]] = []
        self.at_aux: List[List[Tuple[int, int]]] = []
        self.bt_aux: List[List[Tuple[int, int]]] = []
        self.ct_aux: List[List[Tuple[int, int]]] = []

    def alloc(self, annotation, f) -> Variable:
        index = self.num_aux
        self.num_aux += 1
        self.at_aux.append([])
        self.bt_aux.append([])
        self.ct_aux.append([])
        return Variable(AUX, index)

    def alloc_input(self, annotation, f) -> Variable:
        index = self.num_inputs
        self.num_inputs += 1
        self.at_inputs.append([])
        self.bt_inputs.append([])
        self.ct_inputs.append([])
        return Variable(INPUT, index)

    def enforce(self, annotation, a, b, c) -> None:
        def record(lc: LinearCombination, inputs, aux):
            for var, coeff in lc.terms:
                if var.kind == INPUT:
                    inputs[var.index].append((coeff, self.num_constraints))
                else:
                    aux[var.index].append((coeff, self.num_constraints))

        zero = LinearCombination.zero(self.field)
        record(a(zero), self.at_inputs, self.at_aux)
        record(b(zero), self.bt_inputs, self.bt_aux)
        record(c(zero), self.ct_inputs, self.ct_aux)
        self.num_constraints += 1

    def push_namespace(self, name: str) -> None:
        pass

    def pop_namespace(self) -> None:
        pass


class ProvingAssignment(ConstraintSystem):
    """Witness evaluator + density tracking (prover.rs:55-156)."""

    def __init__(self, field: PrimeField):
        super().__init__(field)
        self.a_aux_density = DensityTracker()
        self.b_input_density = DensityTracker()
        self.b_aux_density = DensityTracker()
        self.a: List[int] = []
        self.b: List[int] = []
        self.c: List[int] = []
        self.input_assignment: List[int] = []
        self.aux_assignment: List[int] = []

    def alloc(self, annotation, f: Callable[[], int]) -> Variable:
        self.aux_assignment.append(f() % self.field.p)
        self.a_aux_density.add_element()
        self.b_aux_density.add_element()
        return Variable(AUX, len(self.aux_assignment) - 1)

    def alloc_input(self, annotation, f: Callable[[], int]) -> Variable:
        self.input_assignment.append(f() % self.field.p)
        self.b_input_density.add_element()
        return Variable(INPUT, len(self.input_assignment) - 1)

    def _eval(self, lc: LinearCombination, input_density, aux_density) -> int:
        """LC evaluation with density increments (prover.rs:19-53)."""
        acc = 0
        for var, coeff in lc.terms:
            if var.kind == INPUT:
                val = self.input_assignment[var.index]
                if input_density is not None:
                    input_density.inc(var.index)
            else:
                val = self.aux_assignment[var.index]
                if aux_density is not None:
                    aux_density.inc(var.index)
            acc += val * coeff
        return acc % self.field.p

    def enforce(self, annotation, a, b, c) -> None:
        zero = LinearCombination.zero(self.field)
        # Inputs have full density in the A query because of the per-input
        # dummy constraints (prover.rs:111-120).
        self.a.append(self._eval(a(zero), None, self.a_aux_density))
        self.b.append(self._eval(b(zero), self.b_input_density, self.b_aux_density))
        self.c.append(self._eval(c(zero), None, None))

    def push_namespace(self, name: str) -> None:
        pass

    def pop_namespace(self) -> None:
        pass
