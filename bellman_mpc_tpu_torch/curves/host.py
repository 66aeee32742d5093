"""Host (exact bigint) elliptic-curve arithmetic for BLS12-381 G1 and G2.

Affine short-Weierstrass points over a pluggable coordinate field, used for:
  * the test oracle for the TPU projective kernels,
  * scalar-sized host work (ceremony bookkeeping, key assembly, (de)serialization),
  * generating golden vectors.

Replaces the capability surface of the `group`/`bls12_381` crates consumed by
the reference (bellman/Cargo.toml:15-32): generator, identity, add, double,
scalar mul, (de)compression with subgroup checks.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..fields import bls12_381 as bc
from ..fields.bls12_381 import P, R
from ..fields import tower as tw


class CoordOps:
    """Interface of coordinate-field operations for generic curve formulas."""

    def add(self, a, b):
        raise NotImplementedError

    def sub(self, a, b):
        raise NotImplementedError

    def mul(self, a, b):
        raise NotImplementedError

    def inv(self, a):
        raise NotImplementedError

    def neg(self, a):
        raise NotImplementedError

    def is_zero(self, a):
        raise NotImplementedError

    def eq(self, a, b):
        raise NotImplementedError


class FpOps(CoordOps):
    zero = 0
    one = 1

    def add(self, a, b):
        return (a + b) % P

    def sub(self, a, b):
        return (a - b) % P

    def mul(self, a, b):
        return (a * b) % P

    def inv(self, a):
        return pow(a, P - 2, P)

    def neg(self, a):
        return (-a) % P

    def is_zero(self, a):
        return a % P == 0

    def eq(self, a, b):
        return (a - b) % P == 0

    def mul_int(self, a, k):
        return a * k % P


class Fp2Ops(CoordOps):
    zero = tw.FP2_ZERO
    one = tw.FP2_ONE

    def add(self, a, b):
        return tw.fp2_add(a, b)

    def sub(self, a, b):
        return tw.fp2_sub(a, b)

    def mul(self, a, b):
        return tw.fp2_mul(a, b)

    def inv(self, a):
        return tw.fp2_inv(a)

    def neg(self, a):
        return tw.fp2_neg(a)

    def is_zero(self, a):
        return tw.fp2_is_zero(a)

    def eq(self, a, b):
        return (a[0] - b[0]) % P == 0 and (a[1] - b[1]) % P == 0

    def mul_int(self, a, k):
        return tw.fp2_mul_scalar(a, k)


FP_OPS = FpOps()
FP2_OPS = Fp2Ops()


class CurveGroup:
    """An affine point group y^2 = x^3 + b over a coordinate field."""

    def __init__(self, ops: CoordOps, b, generator_xy, name: str):
        self.ops = ops
        self.b = b
        self.gen_xy = generator_xy
        self.name = name

    # Points are either None (identity) or (x, y) coordinate pairs.
    @property
    def identity(self):
        return None

    @property
    def generator(self):
        return self.gen_xy

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        o = self.ops
        return o.eq(o.mul(y, y), o.add(o.mul(o.mul(x, x), x), self.b))

    def eq(self, p, q) -> bool:
        if p is None or q is None:
            return p is None and q is None
        return self.ops.eq(p[0], q[0]) and self.ops.eq(p[1], q[1])

    def neg(self, p):
        if p is None:
            return None
        return (p[0], self.ops.neg(p[1]))

    def add(self, p, q):
        o = self.ops
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if o.eq(x1, x2):
            if o.eq(y1, o.neg(y2)):
                return None
            # doubling: lambda = 3x^2 / 2y
            num = o.mul_int(o.mul(x1, x1), 3)
            den = o.mul_int(y1, 2)
        else:
            num = o.sub(y2, y1)
            den = o.sub(x2, x1)
        lam = o.mul(num, o.inv(den))
        x3 = o.sub(o.sub(o.mul(lam, lam), x1), x2)
        y3 = o.sub(o.mul(lam, o.sub(x1, x3)), y1)
        return (x3, y3)

    def double(self, p):
        return self.add(p, p)

    def mul(self, p, k: int):
        k = k % R
        if k == 0 or p is None:
            return None
        acc = None
        for bit in bin(k)[2:]:
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, p)
        return acc

    def msm(self, points, scalars):
        """Naive host multi-scalar mul (oracle for the TPU MSM kernel)."""
        acc = None
        for pt, s in zip(points, scalars):
            acc = self.add(acc, self.mul(pt, s))
        return acc

    def in_subgroup(self, p) -> bool:
        return self.mul(p, R) is None


G1 = CurveGroup(FP_OPS, bc.B_G1, (bc.G1_X, bc.G1_Y), "G1")
G2 = CurveGroup(FP2_OPS, (4, 4), ((bc.G2_X_C0, bc.G2_X_C1), (bc.G2_Y_C0, bc.G2_Y_C1)), "G2")
