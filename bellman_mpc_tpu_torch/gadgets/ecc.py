"""Jubjub in-circuit: twisted Edwards and Montgomery points over the
circuit's field.

Port of zcash_proofs/src/circuit/ecc.rs: `EdwardsPoint` witness (u, v with
the curve equation, 4 constraints), `assert_not_small_order` (three
doublings and u != 0), `inputize`, `repr` (v's strict bits and the sign of
u), `conditionally_select` (the point or the identity, 2 constraints),
variable-base `mul` over little-endian bits, `add` (6 constraints) and
`double` (5) by the complete formulas for a = -1; `MontgomeryPoint` with
`add` (3 constraints, not for coincident points) and `into_edwards` (2);
and `fixed_base_multiplication` over 3-bit window tables read with
`lookup3_xy`.  Curve constants and tables: curves/jubjub.py.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Sequence, Tuple

from ..curves import jubjub
from ..r1cs.core import DivisionByZero, Namespace
from .boolean import Boolean, _consume, need
from .lookup import lookup3_xy
from .num import AllocatedNum, Num


def _div(num: int, den: int, p: int) -> int:
    if den % p == 0:
        raise DivisionByZero()
    return num * pow(den, -1, p) % p


def _consumes(method):
    """`_consume` for a method: pop the Namespace passed after self."""

    @functools.wraps(method)
    def wrapper(self, cs, *args):
        try:
            return method(self, cs, *args)
        finally:
            if isinstance(cs, Namespace):
                cs.pop()

    return wrapper


@contextlib.contextmanager
def closed(cs):
    """Run a block of gadget calls and close the namespaces they leave open
    on a constraint system that keeps names (TestConstraintSystem):
    AllocatedNum.inputize, the runs of to_bits_le_strict and UInt32.xor
    push names they never pop, which would nest everything after them."""
    stack = getattr(cs.get_root(), "current_namespace", None)
    depth = None if stack is None else len(stack)
    try:
        yield
    finally:
        while stack is not None and len(stack) > depth:
            cs.get_root().pop_namespace()


def _values(*xs):
    """The values of nums, or None where one is missing."""
    vals = [x.get_value() for x in xs]
    return None if None in vals else vals


class EdwardsPoint:
    def __init__(self, u: AllocatedNum, v: AllocatedNum):
        self.u = u
        self.v = v

    def get_u(self) -> AllocatedNum:
        return self.u

    def get_v(self) -> AllocatedNum:
        return self.v

    @staticmethod
    @_consume
    def witness(cs, point: Optional[Tuple[int, int]]) -> "EdwardsPoint":
        """Allocate (u, v) and check that they lie on the curve."""
        u = AllocatedNum.alloc(cs.namespace("u"), lambda: need(point)[0])
        v = AllocatedNum.alloc(cs.namespace("v"), lambda: need(point)[1])
        return EdwardsPoint.interpret(cs.namespace("point interpretation"), u, v)

    @staticmethod
    @_consume
    def interpret(cs, u: AllocatedNum, v: AllocatedNum) -> "EdwardsPoint":
        # -u^2 + v^2 = 1 + d u^2 v^2
        u2 = u.square(cs.namespace("u^2"))
        v2 = v.square(cs.namespace("v^2"))
        u2v2 = u2.mul(cs.namespace("u^2 v^2"), v2)
        one = cs.one()
        cs.enforce(
            "on curve check",
            lambda lc: lc - u2.get_variable() + v2.get_variable(),
            lambda lc: lc + one,
            lambda lc: lc + one + (jubjub.D, u2v2.get_variable()),
        )
        return EdwardsPoint(u, v)

    @_consumes
    def assert_not_small_order(self, cs) -> None:
        tmp = self.double(cs.namespace("first doubling"))
        tmp = tmp.double(cs.namespace("second doubling"))
        tmp = tmp.double(cs.namespace("third doubling"))
        # (0, 1) is the identity and (0, -1) cannot follow three
        # doublings, so u != 0 leaves no small order.
        tmp.u.assert_nonzero(cs.namespace("check u != 0"))

    @_consumes
    def inputize(self, cs) -> None:
        with closed(cs):
            self.u.inputize(cs.namespace("u"))
        with closed(cs):
            self.v.inputize(cs.namespace("v"))

    @_consumes
    def repr(self, cs) -> List[Boolean]:
        """256 bits: v's 255 little-endian bits, then the sign of u."""
        with closed(cs):
            u = self.u.to_bits_le_strict(cs.namespace("unpack u"))
        with closed(cs):
            v = self.v.to_bits_le_strict(cs.namespace("unpack v"))
        return v + [u[0]]

    @_consumes
    def conditionally_select(self, cs, condition: Boolean) -> "EdwardsPoint":
        """This point where `condition` holds, the identity (0, 1) otherwise."""
        f = cs.field
        one = cs.one()
        u_prime = AllocatedNum.alloc(
            cs.namespace("u'"), lambda: need(self.u.get_value()) if need(condition.get_value()) else 0)
        # condition * u = u'
        cs.enforce(
            "u' computation",
            lambda lc: lc + self.u.get_variable(),
            lambda lc: lc + condition.lc(f, 1),
            lambda lc: lc + u_prime.get_variable(),
        )
        v_prime = AllocatedNum.alloc(
            cs.namespace("v'"), lambda: need(self.v.get_value()) if need(condition.get_value()) else 1)
        # condition * v = v' - (1 - condition)
        cs.enforce(
            "v' computation",
            lambda lc: lc + self.v.get_variable(),
            lambda lc: lc + condition.lc(f, 1),
            lambda lc: lc + v_prime.get_variable() - condition.not_().lc(f, 1),
        )
        return EdwardsPoint(u_prime, v_prime)

    @_consumes
    def mul(self, cs, by: Sequence[Boolean]) -> "EdwardsPoint":
        """[by] self, `by` little-endian: the point doubled per bit, each
        multiple selected by its bit and summed."""
        curbase = result = None
        for i, bit in enumerate(by):
            curbase = self if curbase is None else curbase.double(cs.namespace(f"doubling {i}"))
            thisbase = curbase.conditionally_select(cs.namespace(f"selection {i}"), bit)
            result = thisbase if result is None else result.add(cs.namespace(f"addition {i}"), thisbase)
        return need(result)

    @_consumes
    def add(self, cs, other: "EdwardsPoint") -> "EdwardsPoint":
        p = cs.field.p
        d = jubjub.D
        one = cs.one()
        vals = _values(self.u, self.v, other.u, other.v)
        u1, v1, u2, v2 = vals if vals is not None else (None,) * 4

        # U = (u1 + v1) * (u2 + v2)
        big_u = AllocatedNum.alloc(cs.namespace("U"), lambda: (need(u1) + v1) * (u2 + v2) % p)
        cs.enforce(
            "U computation",
            lambda lc: lc + self.u.get_variable() + self.v.get_variable(),
            lambda lc: lc + other.u.get_variable() + other.v.get_variable(),
            lambda lc: lc + big_u.get_variable(),
        )
        a = other.v.mul(cs.namespace("A computation"), self.u)  # A = v2 u1
        b = other.u.mul(cs.namespace("B computation"), self.v)  # B = u2 v1
        ab = _values(a, b)
        c = AllocatedNum.alloc(cs.namespace("C"), lambda: d * need(ab)[0] % p * ab[1] % p)
        cs.enforce(
            "C computation",
            lambda lc: lc + (d, a.get_variable()),
            lambda lc: lc + b.get_variable(),
            lambda lc: lc + c.get_variable(),
        )
        # u3 = (A + B) / (1 + C)
        u3 = AllocatedNum.alloc(
            cs.namespace("u3"), lambda: _div(need(ab)[0] + ab[1], 1 + need(c.get_value()), p))
        cs.enforce(
            "u3 computation",
            lambda lc: lc + one + c.get_variable(),
            lambda lc: lc + u3.get_variable(),
            lambda lc: lc + a.get_variable() + b.get_variable(),
        )
        # v3 = (U - A - B) / (1 - C)
        v3 = AllocatedNum.alloc(
            cs.namespace("v3"),
            lambda: _div(need(big_u.get_value()) - need(ab)[0] - ab[1], 1 - need(c.get_value()), p))
        cs.enforce(
            "v3 computation",
            lambda lc: lc + one - c.get_variable(),
            lambda lc: lc + v3.get_variable(),
            lambda lc: lc + big_u.get_variable() - a.get_variable() - b.get_variable(),
        )
        return EdwardsPoint(u3, v3)

    @_consumes
    def double(self, cs) -> "EdwardsPoint":
        p = cs.field.p
        d = jubjub.D
        one = cs.one()
        uv = _values(self.u, self.v)

        # T = (u + v)^2
        t = AllocatedNum.alloc(cs.namespace("T"), lambda: (need(uv)[0] + uv[1]) ** 2 % p)
        cs.enforce(
            "T computation",
            lambda lc: lc + self.u.get_variable() + self.v.get_variable(),
            lambda lc: lc + self.u.get_variable() + self.v.get_variable(),
            lambda lc: lc + t.get_variable(),
        )
        a = self.u.mul(cs.namespace("A computation"), self.v)  # A = u v
        c = AllocatedNum.alloc(cs.namespace("C"), lambda: d * need(a.get_value()) ** 2 % p)
        cs.enforce(
            "C computation",
            lambda lc: lc + (d, a.get_variable()),
            lambda lc: lc + a.get_variable(),
            lambda lc: lc + c.get_variable(),
        )
        # u3 = 2A / (1 + C)
        u3 = AllocatedNum.alloc(
            cs.namespace("u3"), lambda: _div(2 * need(a.get_value()), 1 + need(c.get_value()), p))
        cs.enforce(
            "u3 computation",
            lambda lc: lc + one + c.get_variable(),
            lambda lc: lc + u3.get_variable(),
            lambda lc: lc + a.get_variable() + a.get_variable(),
        )
        # v3 = (T - 2A) / (1 - C)
        v3 = AllocatedNum.alloc(
            cs.namespace("v3"),
            lambda: _div(need(t.get_value()) - 2 * need(a.get_value()), 1 - need(c.get_value()), p))
        cs.enforce(
            "v3 computation",
            lambda lc: lc + one - c.get_variable(),
            lambda lc: lc + v3.get_variable(),
            lambda lc: lc + t.get_variable() - a.get_variable() - a.get_variable(),
        )
        return EdwardsPoint(u3, v3)


class MontgomeryPoint:
    """An (x, y) pair of lazy nums on y^2 = x^3 + A x^2 + x, unchecked: the
    window lookups give points known to lie on the curve."""

    def __init__(self, x: Num, y: Num):
        self.x = x
        self.y = y

    @staticmethod
    def interpret_unchecked(x: Num, y: Num) -> "MontgomeryPoint":
        return MontgomeryPoint(x, y)

    @_consumes
    def into_edwards(self, cs) -> EdwardsPoint:
        """u = SCALE x / y, v = (x - 1) / (x + 1), for the prime-order
        subgroup's points."""
        p = cs.field.p
        scale = jubjub.MONTGOMERY_SCALE
        one = cs.one()
        xy = (self.x.get_value(), self.y.get_value())
        u = AllocatedNum.alloc(cs.namespace("u"), lambda: _div(need(xy[0]) * scale, need(xy[1]), p))
        cs.enforce(
            "u computation",
            lambda lc: lc + self.y.lc(1),
            lambda lc: lc + u.get_variable(),
            lambda lc: lc + self.x.lc(scale),
        )
        v = AllocatedNum.alloc(cs.namespace("v"), lambda: _div(need(xy[0]) - 1, xy[0] + 1, p))
        cs.enforce(
            "v computation",
            lambda lc: lc + self.x.lc(1) + one,
            lambda lc: lc + v.get_variable(),
            lambda lc: lc + self.x.lc(1) - one,
        )
        return EdwardsPoint(u, v)

    @_consumes
    def add(self, cs, other: "MontgomeryPoint") -> "MontgomeryPoint":
        """Affine addition of points with different x."""
        f = cs.field
        p = f.p
        one = cs.one()
        vals = (self.x.get_value(), self.y.get_value(), other.x.get_value(), other.y.get_value())
        x1, y1, x2, y2 = vals

        # lambda = (y' - y) / (x' - x)
        lam = AllocatedNum.alloc(cs.namespace("lambda"), lambda: _div(need(y2) - need(y1), need(x2) - need(x1), p))
        cs.enforce(
            "evaluate lambda",
            lambda lc: lc + other.x.lc(1) - self.x.lc(1),
            lambda lc: lc + lam.get_variable(),
            lambda lc: lc + other.y.lc(1) - self.y.lc(1),
        )
        # x'' = lambda^2 - A - x - x'
        xprime = AllocatedNum.alloc(
            cs.namespace("xprime"),
            lambda: (need(lam.get_value()) ** 2 - jubjub.MONTGOMERY_A - x1 - x2) % p)
        cs.enforce(
            "evaluate xprime",
            lambda lc: lc + lam.get_variable(),
            lambda lc: lc + lam.get_variable(),
            lambda lc: lc + (jubjub.MONTGOMERY_A, one) + self.x.lc(1) + other.x.lc(1)
            + xprime.get_variable(),
        )
        # y'' = -(y + lambda (x'' - x))
        yprime = AllocatedNum.alloc(
            cs.namespace("yprime"),
            lambda: -(need(y1) + need(lam.get_value()) * (need(xprime.get_value()) - x1)) % p)
        cs.enforce(
            "evaluate yprime",
            lambda lc: lc + self.x.lc(1) - xprime.get_variable(),
            lambda lc: lc + lam.get_variable(),
            lambda lc: lc + yprime.get_variable() + self.y.lc(1),
        )
        return MontgomeryPoint(Num.from_allocated(xprime, f), Num.from_allocated(yprime, f))


@_consume
def fixed_base_multiplication(cs, base: Sequence[Sequence[Tuple[int, int]]],
                              by: Sequence[Boolean]) -> EdwardsPoint:
    """[by] G for the fixed G whose window table is `base` (windows of
    [0..7] * 8^w * G); `by` little-endian, read 3 bits per window."""
    result = None
    false = Boolean.constant(False)
    for i, window in zip(range(0, len(by), 3), base):
        chunk = list(by[i : i + 3]) + [false] * max(0, i + 3 - len(by))
        u, v = lookup3_xy(cs.namespace(f"window table lookup {i // 3}"), chunk, window)
        pt = EdwardsPoint(u, v)
        result = pt if result is None else result.add(cs.namespace(f"addition {i // 3}"), pt)
    return need(result)
