"""Plain BLS12-381 arithmetic for judging proofs: Python integers only.

The fields Fp, Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 - (u + 1)),
Fp12 = Fp6[w]/(w^2 - v); the curves E: y^2 = x^3 + 4 over Fp (G1) and its
twist E': y^2 = x^3 + 4(u + 1) over Fp2 (G2); the zcash compressed point
encoding; and the optimal ate pairing as a product of Miller loops with one
final exponentiation, enough to test a product of pairings against 1.

Nothing here comes from the program: the constants are the curve's
published ones and every routine is written from its textbook definition.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X = -0xD201000000010000  # the BLS parameter: r = x^4 - x^2 + 1

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)

assert X ** 4 - X ** 2 + 1 == R
assert (X - 1) ** 2 * (X ** 4 - X ** 2 + 1) // 3 + X == P

# ---------------------------------------------------------------------- Fp2
Fp2 = Tuple[int, int]
FP2_ZERO: Fp2 = (0, 0)
FP2_ONE: Fp2 = (1, 0)


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return (-a[0] % P, -a[1] % P)


def f2_mul(a, b):
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def f2_sqr(a):
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def f2_scale(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a):
    return (a[0], -a[1] % P)


def f2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return (a[0] * d % P, -a[1] * d % P)


def f2_mul_xi(a):
    """Times xi = u + 1."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def f2_pow(a, e: int):
    out = FP2_ONE
    while e:
        if e & 1:
            out = f2_mul(out, a)
        a = f2_sqr(a)
        e >>= 1
    return out


# ---------------------------------------------------------------- Fp6, Fp12
def f6_add(a, b):
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a, b):
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a):
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_v(a):
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_inv(f2_add(f2_mul(a0, c0), f2_mul_xi(f2_add(f2_mul(a1, c2), f2_mul(a2, c1)))))
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


F6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
F12_ONE = ((FP2_ONE, FP2_ZERO, FP2_ZERO), F6_ZERO)


def f12_mul(a, b):
    t0 = f6_mul(a[0], b[0])
    t1 = f6_mul(a[1], b[1])
    c1 = f6_sub(f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])), f6_add(t0, t1))
    return (f6_add(t0, f6_mul_v(t1)), c1)


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    t = f6_inv(f6_sub(f6_mul(a[0], a[0]), f6_mul_v(f6_mul(a[1], a[1]))))
    return (f6_mul(a[0], t), f6_neg(f6_mul(a[1], t)))


def f12_pow(a, e: int):
    out = F12_ONE
    while e:
        if e & 1:
            out = f12_mul(out, a)
        a = f12_mul(a, a)
        e >>= 1
    return out


def f12_is_one(a) -> bool:
    return a == F12_ONE


# Frobenius: with a = sum_j g_j w^j (g_j in Fp2, w^6 = xi), a^p = sum_j
# conj(g_j) gamma^j w^j where gamma = w^(p-1) = xi^((p-1)/6).
_GAMMA = [f2_pow((1, 1), j * (P - 1) // 6) for j in range(6)]


def f12_frob(a):
    (g0, g2, g4), (g1, g3, g5) = a
    g = [f2_mul(f2_conj(x), _GAMMA[j]) for j, x in enumerate((g0, g1, g2, g3, g4, g5))]
    return ((g[0], g[2], g[4]), (g[1], g[3], g[5]))


def _mul_line(f, a, b, c: int):
    """f * l for the sparse line l = (a + b v) + (c v) w, with a, b in Fp2
    and c in Fp."""
    f0, f1 = f
    x0, x1, x2 = f0
    y0, y1, y2 = f1
    # f0 * (a + b v)
    u0 = f2_add(f2_mul(x0, a), f2_mul_xi(f2_mul(x2, b)))
    u1 = f2_add(f2_mul(x0, b), f2_mul(x1, a))
    u2 = f2_add(f2_mul(x1, b), f2_mul(x2, a))
    # f1 * (a + b v)
    s0 = f2_add(f2_mul(y0, a), f2_mul_xi(f2_mul(y2, b)))
    s1 = f2_add(f2_mul(y0, b), f2_mul(y1, a))
    s2 = f2_add(f2_mul(y1, b), f2_mul(y2, a))
    # (f0 + f1 w)(l0 + c v w) = (f0 l0 + v (f1 c v)) + (f1 l0 + f0 c v) w, as w^2 = v
    cv1 = (f2_mul_xi(f2_scale(y2, c)), f2_scale(y0, c), f2_scale(y1, c))  # f1 * c v
    cv0 = (f2_mul_xi(f2_scale(x2, c)), f2_scale(x0, c), f2_scale(x1, c))  # f0 * c v
    r0 = f6_add((u0, u1, u2), f6_mul_v(cv1))
    r1 = f6_add((s0, s1, s2), cv0)
    return (r0, r1)


_X_BITS = bin(-X)[3:]  # |x| below its leading bit


def miller_loop(pairs: Sequence[Tuple[Tuple[int, int], Tuple[Fp2, Fp2]]]):
    """prod_i f_{|x|, Q_i}(P_i), conjugated since x < 0, for affine P_i in
    G1 and Q_i in G2 (pairs with the identity, None, are left out).  Each
    line through T (on the twist) is scaled by w^3, which lies in a proper
    subfield and so vanishes under the final exponentiation:
    l = (lambda x_T - y_T) - lambda x_P v + y_P v w."""
    pairs = [(p, q) for p, q in pairs if p is not None and q is not None]
    ts = [q for _, q in pairs]
    f = F12_ONE
    for bit in _X_BITS:
        f = f12_mul(f, f)
        for i, (p, q) in enumerate(pairs):
            xt, yt = ts[i]
            lam = f2_mul(f2_scale(f2_sqr(xt), 3), f2_inv(f2_scale(yt, 2)))
            f = _mul_line(f, f2_sub(f2_mul(lam, xt), yt), f2_neg(f2_scale(lam, p[0])), p[1])
            x3 = f2_sub(f2_sqr(lam), f2_scale(xt, 2))
            ts[i] = (x3, f2_sub(f2_mul(lam, f2_sub(xt, x3)), yt))
        if bit == "1":
            for i, (p, q) in enumerate(pairs):
                xt, yt = ts[i]
                lam = f2_mul(f2_sub(q[1], yt), f2_inv(f2_sub(q[0], xt)))
                f = _mul_line(f, f2_sub(f2_mul(lam, xt), yt), f2_neg(f2_scale(lam, p[0])), p[1])
                x3 = f2_sub(f2_sub(f2_sqr(lam), xt), q[0])
                ts[i] = (x3, f2_sub(f2_mul(lam, f2_sub(xt, x3)), yt))
    return f12_conj(f)


def _exp_x(a):
    """a^x for a in the cyclotomic subgroup (x < 0: the inverse is the
    conjugate)."""
    return f12_conj(f12_pow(a, -X))


def final_exponentiation(f):
    """f^(3 (p^12 - 1) / r): the easy part f^((p^6 - 1)(p^2 + 1)), then the
    hard part to 3 (p^4 - p^2 + 1) / r = (x - 1)^2 (x + p)(x^2 + p^2 - 1) + 3.
    The factor 3 is prime to r, so the result is 1 exactly where e(...) is."""
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frob(f12_frob(f)), f)
    a = f12_mul(_exp_x(f), f12_conj(f))
    a = f12_mul(_exp_x(a), f12_conj(a))
    b = f12_mul(_exp_x(a), f12_frob(a))
    c = f12_mul(f12_mul(_exp_x(_exp_x(b)), f12_frob(f12_frob(b))), f12_conj(b))
    return f12_mul(c, f12_mul(f12_mul(f, f), f))


def pairing_product_is_one(pairs) -> bool:
    return f12_is_one(final_exponentiation(miller_loop(pairs)))


HARD_PART_IDENTITY = (X - 1) ** 2 * (X + P) * (X ** 2 + P ** 2 - 1) + 3 == 3 * (P ** 4 - P ** 2 + 1) // R
assert HARD_PART_IDENTITY and (P ** 4 - P ** 2 + 1) % R == 0


# ------------------------------------------------------------------- curves
class Curve:
    """Short Weierstrass y^2 = x^3 + b over Fp (G1) or Fp2 (G2); affine
    points are tuples, None is the identity.  Jacobian coordinates inside
    scalar multiplication."""

    def __init__(self, fp2: bool):
        self.fp2 = fp2
        if fp2:
            self.add_, self.sub_, self.mul_, self.sqr_ = f2_add, f2_sub, f2_mul, f2_sqr
            self.inv_, self.zero, self.one, self.b = f2_inv, FP2_ZERO, FP2_ONE, (4, 4)
        else:
            self.add_ = lambda a, b: (a + b) % P
            self.sub_ = lambda a, b: (a - b) % P
            self.mul_ = lambda a, b: a * b % P
            self.sqr_ = lambda a: a * a % P
            self.inv_ = lambda a: pow(a, -1, P)
            self.zero, self.one, self.b = 0, 1, 4

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return self.sqr_(y) == self.add_(self.mul_(self.sqr_(x), x), self.b)

    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], f2_neg(pt[1]) if self.fp2 else -pt[1] % P)

    def _double_j(self, pt):
        x, y, z = pt
        if z == self.zero:
            return pt
        a = self.sqr_(x)
        b = self.sqr_(y)
        c = self.sqr_(b)
        d = self.sub_(self.sub_(self.sqr_(self.add_(x, b)), a), c)
        d = self.add_(d, d)
        e = self.add_(self.add_(a, a), a)
        f = self.sqr_(e)
        x3 = self.sub_(f, self.add_(d, d))
        c8 = self.add_(c, c)
        c8 = self.add_(c8, c8)
        c8 = self.add_(c8, c8)
        y3 = self.sub_(self.mul_(e, self.sub_(d, x3)), c8)
        z3 = self.mul_(y, z)
        return (x3, y3, self.add_(z3, z3))

    def _add_mixed_j(self, pt, q):
        """Jacobian pt + affine q."""
        x1, y1, z1 = pt
        if z1 == self.zero:
            return (q[0], q[1], self.one)
        z1z1 = self.sqr_(z1)
        u2 = self.mul_(q[0], z1z1)
        s2 = self.mul_(self.mul_(q[1], z1), z1z1)
        if u2 == x1:
            if s2 == y1:
                return self._double_j(pt)
            return (self.one, self.one, self.zero)
        h = self.sub_(u2, x1)
        hh = self.sqr_(h)
        i = self.add_(hh, hh)
        i = self.add_(i, i)
        j = self.mul_(h, i)
        r = self.sub_(s2, y1)
        r = self.add_(r, r)
        v = self.mul_(x1, i)
        x3 = self.sub_(self.sub_(self.sqr_(r), j), self.add_(v, v))
        y1j = self.mul_(y1, j)
        y3 = self.sub_(self.mul_(r, self.sub_(v, x3)), self.add_(y1j, y1j))
        z3 = self.sub_(self.sub_(self.sqr_(self.add_(z1, h)), z1z1), hh)
        return (x3, y3, z3)

    def _affine(self, pt):
        x, y, z = pt
        if z == self.zero:
            return None
        zi = self.inv_(z)
        zi2 = self.sqr_(zi)
        return (self.mul_(x, zi2), self.mul_(self.mul_(y, zi2), zi))

    def mul(self, pt, k: int):
        """k * pt for k >= 0 (double-and-add, most significant bit first)."""
        if pt is None or k == 0:
            return None
        acc = (self.one, self.one, self.zero)
        for bit in bin(k)[2:]:
            acc = self._double_j(acc)
            if bit == "1":
                acc = self._add_mixed_j(acc, pt)
        return self._affine(acc)

    def add(self, p, q):
        if p is None:
            return q
        if q is None:
            return p
        return self._affine(self._add_mixed_j((p[0], p[1], self.one), q))

    def sum(self, pts: Sequence) -> Optional[tuple]:
        acc = (self.one, self.one, self.zero)
        for q in pts:
            if q is not None:
                acc = self._add_mixed_j(acc, q)
        return self._affine(acc)


G1 = Curve(fp2=False)
G2 = Curve(fp2=True)
assert G1.on_curve(G1_GEN) and G2.on_curve(G2_GEN)


# ----------------------------------------------------------- point encoding
class EncodingError(ValueError):
    pass


_COMPRESSED, _INFINITY, _SORT = 0x80, 0x40, 0x20


def _fp_sqrt(a: int) -> Optional[int]:
    y = pow(a, (P + 1) // 4, P)  # p = 3 mod 4
    return y if y * y % P == a % P else None


def _fp2_sqrt(a: Fp2) -> Optional[Fp2]:
    """Square root in Fp2 for p = 3 mod 4 (Adj and Rodriguez-Henriquez,
    algorithm 9), checked by squaring."""
    if a == FP2_ZERO:
        return FP2_ZERO
    a1 = f2_pow(a, (P - 3) // 4)
    x0 = f2_mul(a1, a)
    alpha = f2_mul(a1, x0)
    if alpha == (P - 1, 0):
        x = f2_mul((0, 1), x0)
    else:
        x = f2_mul(f2_pow(f2_add(FP2_ONE, alpha), (P - 1) // 2), x0)
    return x if f2_sqr(x) == a else None


def _flags(data: bytes):
    flags = data[0]
    if not flags & _COMPRESSED:
        raise EncodingError("not a compressed point")
    if flags & _INFINITY:
        if flags & _SORT or data[0] & 0x1F or any(data[1:]):
            raise EncodingError("malformed point at infinity")
        return None
    return bool(flags & _SORT)


def g1_decompress(data: bytes):
    """48 bytes -> affine G1 point (None for the identity); raises
    EncodingError where the bytes name no point of E."""
    if len(data) != 48:
        raise EncodingError("a G1 point takes 48 bytes")
    largest = _flags(data)
    if largest is None:
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise EncodingError("x is not below p")
    y = _fp_sqrt((x * x * x + 4) % P)
    if y is None:
        raise EncodingError("x is not on the curve")
    if (y > P - y) != largest:
        y = P - y
    return (x, y)


def g2_decompress(data: bytes):
    """96 bytes (x.c1 then x.c0) -> affine G2 point on the twist."""
    if len(data) != 96:
        raise EncodingError("a G2 point takes 96 bytes")
    largest = _flags(data)
    if largest is None:
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise EncodingError("x is not in Fp2")
    x = (x0, x1)
    y = _fp2_sqrt(f2_add(f2_mul(f2_sqr(x), x), (4, 4)))
    if y is None:
        raise EncodingError("x is not on the twist")
    ny = f2_neg(y)
    if ((y[1], y[0]) > (ny[1], ny[0])) != largest:
        y = ny
    return (x, y)


def g1_compress(pt) -> bytes:
    if pt is None:
        return bytes([_COMPRESSED | _INFINITY]) + bytes(47)
    x, y = pt
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _COMPRESSED | (_SORT if y > P - y else 0)
    return bytes(out)


def g2_compress(pt) -> bytes:
    if pt is None:
        return bytes([_COMPRESSED | _INFINITY]) + bytes(95)
    x, y = pt
    ny = f2_neg(y)
    out = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    out[0] |= _COMPRESSED | (_SORT if (y[1], y[0]) > (ny[1], ny[0]) else 0)
    return bytes(out)


def proof_decompress(data: bytes):
    """192 bytes -> (A in G1, B in G2, C in G1); raises EncodingError."""
    if len(data) != 192:
        raise EncodingError("a proof takes 192 bytes")
    return g1_decompress(data[:48]), g2_decompress(data[48:144]), g1_decompress(data[144:])


def proof_compress(a, b, c) -> bytes:
    return g1_compress(a) + g2_compress(b) + g1_compress(c)
