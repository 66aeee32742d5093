"""Compiled circuits: synthesize once, evaluate witnesses fast.

(Copy of bellman_mpc_tpu/groth16/compiled.py; its native evaluator is the
port's loader of the same C source, native/__init__.py.)

The reference re-synthesizes the circuit on every proof, evaluating each
constraint's linear combinations inline (prover.rs:99-139).  Here a circuit
is synthesized ONCE into packed per-constraint sparse tables (plus the
static density maps), and per-proof work reduces to:

  1. a witness-only synthesis pass (allocation closures only — no LC work),
  2. the native C evaluator (native/bmt_native.c) for all A/B/C values
     (pure-Python fallback included).
"""

from __future__ import annotations

from typing import List, Tuple

from ..r1cs.core import AUX, INPUT, Circuit, ConstraintSystem, Variable
from ..utils import profiling
from .assembly import KeypairAssembly, ProvingAssignment
from .generator import synthesize_keypair


class WitnessOnlyCS(ConstraintSystem):
    """Runs allocation closures, skips constraint bookkeeping entirely."""

    def __init__(self, field):
        super().__init__(field)
        self.input_assignment: List[int] = []
        self.aux_assignment: List[int] = []

    def alloc(self, annotation, f) -> Variable:
        self.aux_assignment.append(f() % self.field.p)
        return Variable(AUX, len(self.aux_assignment) - 1)

    def alloc_input(self, annotation, f) -> Variable:
        self.input_assignment.append(f() % self.field.p)
        return Variable(INPUT, len(self.input_assignment) - 1)

    def enforce(self, annotation, a, b, c) -> None:
        pass

    def push_namespace(self, name: str) -> None:
        pass

    def pop_namespace(self) -> None:
        pass


def _transpose_tables(per_var, n_cons, kind) -> List[List[Tuple[int, int, int]]]:
    out: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_cons)]
    for var_idx, entries in enumerate(per_var):
        for coeff, cons_idx in entries:
            out[cons_idx].append((kind, var_idx, coeff))
    return out


class CompiledCircuit:
    """One-time synthesis product: packed LC tables + density maps."""

    def __init__(self, engine, template: Circuit):
        self.engine = engine
        self.field = engine.fr_host
        assembly = synthesize_keypair(engine, template)
        self.num_inputs = assembly.num_inputs
        self.num_aux = assembly.num_aux
        self.num_constraints = assembly.num_constraints

        def merge(inputs_tbl, aux_tbl):
            a = _transpose_tables(inputs_tbl, self.num_constraints, 0)
            b = _transpose_tables(aux_tbl, self.num_constraints, 1)
            return [x + y for x, y in zip(a, b)]

        self.a_terms = merge(assembly.at_inputs, assembly.at_aux)
        self.b_terms = merge(assembly.bt_inputs, assembly.bt_aux)
        self.c_terms = merge(assembly.ct_inputs, assembly.ct_aux)

        from .. import native

        self._native = native.available()
        if self._native:
            self._packed = tuple(
                native.PackedLcTable(t)
                for t in (self.a_terms, self.b_terms, self.c_terms)
            )

        # Density maps from a template ProvingAssignment run (static).
        densities = ProvingAssignment(self.field)
        densities.alloc_input("", lambda: 1)
        for _ in range(self.num_aux):
            densities.alloc("", lambda: 0)
        for _ in range(1, self.num_inputs):
            densities.alloc_input("", lambda: 0)
        for terms_a, terms_b in zip(self.a_terms, self.b_terms):
            for kind, idx, _ in terms_a:
                if kind == 1:
                    densities.a_aux_density.inc(idx)
            for kind, idx, _ in terms_b:
                (densities.b_input_density if kind == 0 else densities.b_aux_density).inc(idx)
        self.a_aux_density = densities.a_aux_density
        self.b_input_density = densities.b_input_density
        self.b_aux_density = densities.b_aux_density

    def witness(self, circuit: Circuit) -> Tuple[List[int], List[int]]:
        """Fast witness-only synthesis (includes the implicit ONE input),
        timed as the span "encode.synthesize" (utils/profiling.py)."""
        cs = WitnessOnlyCS(self.field)
        cs.alloc_input("", lambda: 1)
        with profiling.span("encode.synthesize"):
            circuit.synthesize(cs)
        return cs.input_assignment, cs.aux_assignment

    def eval_abc(
        self, inputs: List[int], aux: List[int]
    ) -> Tuple[List[int], List[int], List[int]]:
        """Per-constraint A/B/C values (native fast path, Python fallback)."""
        p = self.field.p
        if self._native:
            from .. import native

            return tuple(
                native.lc_eval(t, inputs, aux, p) for t in self._packed
            )

        def eval_table(terms):
            out = []
            for row in terms:
                acc = 0
                for kind, idx, coeff in row:
                    val = inputs[idx] if kind == 0 else aux[idx]
                    acc += val * coeff
                out.append(acc % p)
            return out

        return (
            eval_table(self.a_terms),
            eval_table(self.b_terms),
            eval_table(self.c_terms),
        )

    def prove_bytes(self, circuit: Circuit, nbytes: int):
        """Fast per-proof path: witness synthesis + native LC eval straight
        to packed wire bytes (no Python bigints for a/b/c).

        Returns (in_limbs (n_in,4) u64, aux_limbs (n_aux,4) u64,
        a8/b8/c8 (n_cons, nbytes) uint8) — the byte rows are exactly what
        `LimbField.pack_std` would produce.  Requires the native library."""
        from .. import native

        inputs, aux = self.witness(circuit)
        in_arr = native.vals_to_limbs(inputs)
        aux_arr = native.vals_to_limbs(aux)
        p = self.field.p
        a8, b8, c8 = (
            native.lc_eval_bytes(t, in_arr, aux_arr, p, nbytes)
            for t in self._packed
        )
        return in_arr, aux_arr, a8, b8, c8

    def prove_assignment(self, circuit: Circuit) -> ProvingAssignment:
        """A ProvingAssignment equivalent to full synthesis, built fast."""
        inputs, aux = self.witness(circuit)
        a, b, c = self.eval_abc(inputs, aux)
        pa = ProvingAssignment(self.field)
        pa.input_assignment = inputs
        pa.aux_assignment = aux
        pa.a, pa.b, pa.c = list(a), list(b), list(c)
        pa.a_aux_density = self.a_aux_density
        pa.b_input_density = self.b_input_density
        pa.b_aux_density = self.b_aux_density
        return pa
