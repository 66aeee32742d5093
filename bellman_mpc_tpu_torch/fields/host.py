"""Host-side (pure Python bigint) prime-field arithmetic.

This is the exact-arithmetic substrate used for circuit synthesis, constants
generation (roots of unity, Montgomery factors, Frobenius coefficients) and as
the test oracle for the TPU limb kernels.  It plays the role of the `ff`
crate's `PrimeField` trait in the reference (reference: bellman/src/lib.rs and
the `ff`/`bls12_381` dependencies in bellman/Cargo.toml:15-32), re-designed as
a lightweight Python object: field *elements are plain ints* in [0, p) and the
`PrimeField` object carries the modulus and derived constants.  Keeping
elements as raw ints makes host-side circuit synthesis (pointer-chasing sparse
work the reference also does on CPU) fast, and makes conversion to the
limb-decomposed device representation trivial.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Optional


class PrimeField:
    """A prime field GF(p) with optional 2-adic NTT structure.

    Mirrors the capability surface of `ff::PrimeField` used by the reference
    (two-adicity `S`, `root_of_unity`, `multiplicative_generator`,
    NUM_BITS/CAPACITY; see e.g. the mock field impl at
    bellman/src/groth16/tests/dummy_engine.rs:289-317).
    """

    def __init__(self, modulus: int, generator: Optional[int] = None, name: str = "F"):
        if modulus < 3 or modulus % 2 == 0:
            raise ValueError("modulus must be an odd prime")
        self.p = modulus
        self.name = name
        self.num_bits = modulus.bit_length()
        self.capacity = self.num_bits - 1
        # two-adicity: p - 1 = 2^S * t with t odd
        t = modulus - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.S = s
        self.t_odd = t
        self.generator = generator
        if generator is not None:
            self.root_of_unity = pow(generator, t, modulus)
        else:
            self.root_of_unity = None

    # -- element constructors -------------------------------------------------
    def from_int(self, v: int) -> int:
        return v % self.p

    @property
    def zero(self) -> int:
        return 0

    @property
    def one(self) -> int:
        return 1

    # -- arithmetic -----------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def square(self, a: int) -> int:
        return (a * a) % self.p

    def double(self, a: int) -> int:
        return (2 * a) % self.p

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("inversion of zero in %s" % self.name)
        return pow(a, self.p - 2, self.p)

    def div(self, a: int, b: int) -> int:
        return (a * self.inv(b)) % self.p

    def sqrt(self, a: int) -> Optional[int]:
        """Tonelli-Shanks square root (None when `a` is a non-residue).

        Mirrors ff's sqrt used for point decompression; algorithm as in
        bellman/src/groth16/tests/dummy_engine.rs:220-253 (generic T-S).
        """
        p = self.p
        a = a % p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # general Tonelli-Shanks
        q, s = self.t_odd, self.S
        z = self.generator
        if z is None:
            z = 2
            while pow(z, (p - 1) // 2, p) != p - 1:
                z += 1
        c = pow(z, q, p)
        r = pow(a, (q + 1) // 2, p)
        t = pow(a, q, p)
        m = s
        while t != 1:
            i = 0
            t2i = t
            while t2i != 1:
                t2i = (t2i * t2i) % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            r = (r * b) % p
            c = (b * b) % p
            t = (t * c) % p
            m = i
        return r

    # -- NTT helpers ----------------------------------------------------------
    def nth_root_of_unity(self, log_n: int) -> int:
        """Primitive 2^log_n-th root of unity (requires log_n <= S).

        Reference: omega derivation in bellman/src/domain.rs:56-66.
        """
        if self.root_of_unity is None:
            raise ValueError("field has no configured generator")
        if log_n > self.S:
            raise ValueError("domain too large for field two-adicity")
        omega = self.root_of_unity
        for _ in range(self.S - log_n):
            omega = (omega * omega) % self.p
        return omega

    def __repr__(self) -> str:
        return f"PrimeField({self.name}, bits={self.num_bits})"


def batch_inv(field: PrimeField, xs: List[int]) -> List[int]:
    """Montgomery batch inversion on the host."""
    p = field.p
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * (x if x != 0 else 1) % p
    inv_all = pow(prefix[n], p - 2, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        x = xs[i]
        if x == 0:
            raise ZeroDivisionError("batch_inv of zero")
        out[i] = inv_all * prefix[i] % p
        inv_all = inv_all * x % p
    return out
