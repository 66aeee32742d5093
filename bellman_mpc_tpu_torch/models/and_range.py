"""AndDemo and RangeDemo circuits.

Port of bellman/src/and_mod.rs: `AndDemo` (:77-134, boolean constraint on a
plus a*b=c with c public) and `RangeDemo` (:148-251, binary-decomposition
range proof: w = 2^(n-1) + b - a, bit constraints on wArray, the carry chain
crArray with cr_i = 1 - (cr_{i-1}-1)(w_i-1), `not_all_zeros`, and the
less-or-equal / less outputs).  The stray root-level variant with an
explicit crArray witness (bellman/range_mod.rs — not reachable in the
reference build) is RangeDemoExplicit below.

Host copy of bellman_mpc_tpu/models/and_range.py on the port's r1cs core.
"""

from __future__ import annotations

from typing import List, Optional

from ..r1cs.core import AssignmentMissing, Circuit, ConstraintSystem, LinearCombination


def _need(v):
    if v is None:
        raise AssignmentMissing()
    return v


def _b2i(v: Optional[bool]) -> Optional[int]:
    return None if v is None else int(bool(v))


class AndDemo(Circuit):
    """a (boolean-constrained) AND b = c, c public (and_mod.rs:77-134)."""

    def __init__(self, a: Optional[bool] = None, b: Optional[bool] = None):
        self.a, self.b = a, b

    def synthesize(self, cs: ConstraintSystem) -> None:
        a_var = cs.alloc("a", lambda: _need(_b2i(self.a)))
        cs.enforce(
            "a_boolean_constraint",
            lambda lc: lc + cs.one() - a_var,
            lambda lc: lc + a_var,
            lambda lc: lc,
        )
        b_var = cs.alloc("b", lambda: _need(_b2i(self.b)))
        c_var = cs.alloc_input(
            "c",
            lambda: _need(
                None if self.a is None or self.b is None else int(self.a and self.b)
            ),
        )
        cs.enforce(
            "c_and_constraint",
            lambda lc: lc + a_var,
            lambda lc: lc + b_var,
            lambda lc: lc + c_var,
        )


class RangeDemoExplicit(Circuit):
    """The stray root-level RangeDemo variant (bellman/range_mod.rs:6-115).

    Not reachable in the reference build (no `mod` declaration — SURVEY.md
    §2.5), but ported for inventory completeness: identical constraint
    structure to RangeDemo except the crArray carry chain is an EXPLICIT
    caller-supplied witness, and `b` is private (no public inputs).
    """

    def __init__(self, a=None, b=None, n=None, w=None, wArray=None,
                 less_or_equal=None, less=None, not_all_zeros=None, crArray=None):
        self.a, self.b, self.n, self.w = a, b, n, w
        self.wArray, self.crArray = wArray, crArray
        self.less_or_equal, self.less = less_or_equal, less
        self.not_all_zeros = not_all_zeros

    def synthesize(self, cs: ConstraintSystem) -> None:
        w_bits = _need(self.wArray)
        cr_bits = _need(self.crArray)
        wArray_var = [
            cs.alloc(f"wArray {i}", lambda v=wi: v) for i, wi in enumerate(w_bits)
        ]
        crArray_var = [
            cs.alloc(f"crArray {i}", lambda v=ci: v) for i, ci in enumerate(cr_bits)
        ]

        a = cs.alloc("a", lambda: _need(self.a))
        b = cs.alloc("b", lambda: _need(self.b))
        w = cs.alloc("w", lambda: _need(self.w))
        not_all_zeros = cs.alloc("not_all_zeros", lambda: _need(self.not_all_zeros))
        less_or_equal = cs.alloc("less_or_equal", lambda: _need(self.less_or_equal))
        less = cs.alloc("less", lambda: _need(self.less))

        t = 1 << (_need(self.n) - 1)
        cs.enforce(
            "w=2^n+b-a",
            lambda lc: lc + w,
            lambda lc: lc + cs.one(),
            lambda lc: lc + (t, cs.one()) + b - a,
        )
        lc1 = LinearCombination.zero(cs.field)
        for i, wv in enumerate(wArray_var):
            lc1 = lc1 + (1 << i, wv)
        lc1 = lc1 - w
        cs.enforce(
            "2^0*w0+.......-w=0",
            lambda lc: lc + lc1,
            lambda lc: lc + cs.one(),
            lambda lc: lc,
        )
        for i, wv in enumerate(wArray_var):
            cs.enforce(
                f"w{i}(1-w{i})=0",
                lambda lc, wv=wv: lc + wv,
                lambda lc, wv=wv: lc + cs.one() - wv,
                lambda lc: lc,
            )
        cs.enforce(
            "w0=cr0",
            lambda lc: lc + wArray_var[0],
            lambda lc: lc + cs.one(),
            lambda lc: lc + crArray_var[0],
        )
        for i in range(1, len(crArray_var)):
            cs.enforce(
                f"(cr_{i - 1}-1)(w{i}-1)=1-cr_{i}",
                lambda lc, i=i: lc + crArray_var[i - 1] - cs.one(),
                lambda lc, i=i: lc + wArray_var[i] - cs.one(),
                lambda lc, i=i: lc + cs.one() - crArray_var[i],
            )
        cs.enforce(
            "not_all_zeros=cr_n",
            lambda lc: lc + not_all_zeros,
            lambda lc: lc + cs.one(),
            lambda lc: lc + crArray_var[-1],
        )
        cs.enforce(
            "wn=less_or_equal*wn",
            lambda lc: lc + wArray_var[-1],
            lambda lc: lc + less_or_equal,
            lambda lc: lc + wArray_var[-1],
        )
        cs.enforce(
            "wn*less_or_equal=less",
            lambda lc: lc + wArray_var[-1],
            lambda lc: lc + not_all_zeros,
            lambda lc: lc + less,
        )


class RangeDemo(Circuit):
    """Binary-decomposition less-than proof (and_mod.rs:148-251).

    Witnesses mirror the reference's struct: a, b, n, w, wArray (4 bits),
    less_or_equal, less, not_all_zeros.  The crArray carry chain is computed
    internally exactly as and_mod.rs:159-175 does.
    """

    def __init__(
        self,
        a: Optional[int] = None,
        b: Optional[int] = None,
        n: Optional[int] = None,
        w: Optional[int] = None,
        wArray: Optional[List[int]] = None,
        less_or_equal: Optional[int] = None,
        less: Optional[int] = None,
        not_all_zeros: Optional[int] = None,
    ):
        self.a, self.b, self.n, self.w = a, b, n, w
        self.wArray = wArray
        self.less_or_equal = less_or_equal
        self.less = less
        self.not_all_zeros = not_all_zeros

    def synthesize(self, cs: ConstraintSystem) -> None:
        w_bits = _need(self.wArray)
        wArray_var = []
        crArray_var = []
        cr_vals = []
        for i, wi in enumerate(w_bits):
            wArray_var.append(cs.alloc(f"wArray {i}", lambda v=wi: v))
            if i != 0:
                ci = 1 - (cr_vals[i - 1] - 1) * (wi - 1)
            else:
                ci = wi
            cr_vals.append(ci)
            crArray_var.append(cs.alloc(f"crArray {i}", lambda v=ci: v))

        a = cs.alloc("a", lambda: _need(self.a))
        b = cs.alloc_input("b", lambda: _need(self.b))
        w = cs.alloc("w", lambda: _need(self.w))
        not_all_zeros = cs.alloc("not_all_zeros", lambda: _need(self.not_all_zeros))
        less_or_equal = cs.alloc("less_or_equal", lambda: _need(self.less_or_equal))
        less = cs.alloc("less", lambda: _need(self.less))

        t = 1 << (_need(self.n) - 1)
        cs.enforce(
            "w=2^n+b-a",
            lambda lc: lc + w,
            lambda lc: lc + cs.one(),
            lambda lc: lc + (t, cs.one()) + b - a,
        )

        lc1 = LinearCombination.zero(cs.field)
        for i, wv in enumerate(wArray_var):
            lc1 = lc1 + (1 << i, wv)
        lc1 = lc1 - w
        cs.enforce(
            "2^0*w0+.......-w=0",
            lambda lc: lc + lc1,
            lambda lc: lc + cs.one(),
            lambda lc: lc,
        )

        for i, wv in enumerate(wArray_var):
            cs.enforce(
                f"w{i}(1-w{i})=0",
                lambda lc, wv=wv: lc + wv,
                lambda lc, wv=wv: lc + cs.one() - wv,
                lambda lc: lc,
            )

        cs.enforce(
            "w0=cr0",
            lambda lc: lc + wArray_var[0],
            lambda lc: lc + cs.one(),
            lambda lc: lc + crArray_var[0],
        )

        for i in range(1, len(crArray_var)):
            cs.enforce(
                f"(cr_{i - 1}-1)(w{i}-1)=1-cr_{i}",
                lambda lc, i=i: lc + crArray_var[i - 1] - cs.one(),
                lambda lc, i=i: lc + wArray_var[i] - cs.one(),
                lambda lc, i=i: lc + cs.one() - crArray_var[i],
            )

        cs.enforce(
            "not_all_zeros=cr_n",
            lambda lc: lc + not_all_zeros,
            lambda lc: lc + cs.one(),
            lambda lc: lc + crArray_var[-1],
        )

        cs.enforce(
            "wn=less_or_equal*wn",
            lambda lc: lc + wArray_var[-1],
            lambda lc: lc + less_or_equal,
            lambda lc: lc + wArray_var[-1],
        )

        cs.enforce(
            "wn*less_or_equal=less",
            lambda lc: lc + wArray_var[-1],
            lambda lc: lc + not_all_zeros,
            lambda lc: lc + less,
        )
