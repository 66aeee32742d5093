"""Jubjub on the host: the twisted Edwards curve over BLS12-381's Fr that
the Sapling circuits compute on.

    -u^2 + v^2 = 1 + d u^2 v^2,   d = -10240/10241,

with a subgroup of prime order R_J and cofactor 8.  Points are affine
(u, v) pairs of ints; the Edwards formulas are complete, so the identity
(0, 1) and the small-order points need no special case.  Also here:

  * the 32-byte encoding (v little-endian, the sign of u in bit 255) and
    its inverse, as the jubjub crate's `to_bytes` / `from_bytes`;
  * GroupHash (BLAKE2s-256 of the URS block and a tag under an 8-byte
    personalization, decoded, times the cofactor) and FindGroupHash
    (a counter byte appended until GroupHash gives a point);
  * the Sapling generators, derived as the protocol specification does;
  * the gadgets' window tables: for fixed-base multiplication, 84 windows
    of [0..7] * 8^w * G in Edwards form; for the Pedersen hash, per
    generator 63 windows of [1..4] * 16^w * I in Montgomery form;
  * the native Pedersen hash, the value of the in-circuit one.
"""

from __future__ import annotations

import functools
import hashlib
from typing import List, Optional, Sequence, Tuple

from ..fields.bls12_381 import R as FR_MODULUS
from ..fields.bls12_381 import fr_host
from ..fields.host import PrimeField

Point = Tuple[int, int]

P = FR_MODULUS
D = -10240 * pow(10241, -1, P) % P
R_J = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7
COFACTOR = 8
fs_host = PrimeField(R_J, name="Fs")  # the scalar field: 252 bits, capacity 251

IDENTITY: Point = (0, 1)

# The birational Montgomery form y^2 = x^3 + A x^2 + x, with the Edwards
# u = SCALE x / y; SCALE^2 = -40964 = 4 / (a - d).  Either root gives the
# same Edwards points, but the Montgomery coordinates of the Pedersen
# tables follow the root: this is librustzcash's (its jubjub parameters'
# `scale`), the odd one.
MONTGOMERY_A = 40962
MONTGOMERY_SCALE = 17814886934372412843466061268024708274627479829237077604635722030778476050649
assert MONTGOMERY_SCALE * MONTGOMERY_SCALE % P == -40964 % P

# The uniform random string that GroupHash absorbs first (the spec's URS).
GH_FIRST_BLOCK = b"096b36a5804bfacef1691e173c366a47ff5ba84a44f26ddd7e8d9f79d5b42df0"

FIXED_BASE_CHUNKS_PER_GENERATOR = 84  # 3-bit windows of a 252-bit scalar
PEDERSEN_HASH_CHUNKS_PER_GENERATOR = 63  # 3-bit chunks per segment
PEDERSEN_HASH_GENERATORS = 6


def on_curve(p: Point) -> bool:
    u2, v2 = p[0] * p[0] % P, p[1] * p[1] % P
    return (v2 - u2 - 1 - D * u2 * v2) % P == 0


def add(p: Point, q: Point) -> Point:
    u1, v1 = p
    u2, v2 = q
    t = D * u1 % P * u2 % P * v1 % P * v2 % P
    u3 = (u1 * v2 + v1 * u2) * pow(1 + t, -1, P) % P
    v3 = (v1 * v2 + u1 * u2) * pow(1 - t, -1, P) % P
    return u3, v3


def neg(p: Point) -> Point:
    return (-p[0] % P, p[1])


def double(p: Point) -> Point:
    return add(p, p)


def _add_ext(p, q):
    """(X : Y : T : Z) with u = X/Z, v = Y/Z, T = XY/Z: the complete a = -1
    addition of Hisil, Wong, Carter and Dawson, without inversions."""
    x1, y1, t1, z1 = p
    x2, y2, t2, z2 = q
    a, b = x1 * x2 % P, y1 * y2 % P
    c, dd = D * t1 % P * t2 % P, z1 * z2 % P
    e = ((x1 + y1) * (x2 + y2) - a - b) % P
    f, g, h = (dd - c) % P, (dd + c) % P, (a + b) % P
    return e * f % P, g * h % P, e * h % P, f * g % P


def mul(p: Point, k: int) -> Point:
    """[k] p by double-and-add over the bits of k >= 0, in extended
    coordinates, one inversion at the end."""
    base = (p[0], p[1], p[0] * p[1] % P, 1)
    acc = (0, 1, 0, 1)
    for bit in bin(k)[2:]:
        acc = _add_ext(acc, acc)
        if bit == "1":
            acc = _add_ext(acc, base)
    zi = pow(acc[3], -1, P)
    return acc[0] * zi % P, acc[1] * zi % P


def in_subgroup(p: Point) -> bool:
    return on_curve(p) and mul(p, R_J) == IDENTITY


def to_bytes(p: Point) -> bytes:
    return (p[1] | ((p[0] & 1) << 255)).to_bytes(32, "little")


def from_bytes(data: bytes) -> Optional[Point]:
    """The encoded point, or None: v not below P, no u on the curve, or the
    non-canonical sign of u = 0."""
    raw = int.from_bytes(data, "little")
    sign, v = raw >> 255, raw & ((1 << 255) - 1)
    if v >= P:
        return None
    v2 = v * v % P
    u = fr_host.sqrt((v2 - 1) * pow(1 + D * v2, -1, P) % P)
    if u is None or (u == 0 and sign):
        return None
    if u & 1 != sign:
        u = -u % P
    return u, v


def repr_bits(p: Point) -> List[bool]:
    """The 256 bits of the encoding, little-endian: v's 255 bits, then the
    sign of u (the circuit's `EdwardsPoint.repr`)."""
    return [bool((p[1] >> i) & 1) for i in range(255)] + [bool(p[0] & 1)]


def group_hash(tag: bytes, personalization: bytes) -> Optional[Point]:
    assert len(personalization) == 8
    h = hashlib.blake2s(GH_FIRST_BLOCK + tag, digest_size=32, person=personalization).digest()
    p = from_bytes(h)
    if p is None:
        return None
    p = mul(p, COFACTOR)
    return None if p == IDENTITY else p


def find_group_hash(m: bytes, personalization: bytes) -> Point:
    for i in range(256):
        p = group_hash(m + bytes([i]), personalization)
        if p is not None:
            return p
    raise ValueError("no point for this tag")


@functools.lru_cache(maxsize=None)
def generators() -> dict:
    """The Sapling generators by name."""
    return {
        "spending_key": find_group_hash(b"", b"Zcash_G_"),
        "proof_generation_key": find_group_hash(b"", b"Zcash_H_"),
        "note_commitment_randomness": find_group_hash(b"r", b"Zcash_PH"),
        "nullifier_position": find_group_hash(b"", b"Zcash_J_"),
        "value_commitment_value": find_group_hash(b"v", b"Zcash_cv"),
        "value_commitment_randomness": find_group_hash(b"r", b"Zcash_cv"),
    }


@functools.lru_cache(maxsize=None)
def pedersen_generators() -> Tuple[Point, ...]:
    return tuple(find_group_hash(i.to_bytes(4, "little"), b"Zcash_PH")
                 for i in range(PEDERSEN_HASH_GENERATORS))


@functools.lru_cache(maxsize=None)
def fixed_base_table(name: str) -> Tuple[Tuple[Point, ...], ...]:
    """84 windows of (u, v) for [0..7] * 8^w * G, G the named generator."""
    gen = generators()[name]
    windows = []
    for _ in range(FIXED_BASE_CHUNKS_PER_GENERATOR):
        row, g = [IDENTITY], gen
        for _ in range(7):
            row.append(g)
            g = add(g, gen)
        windows.append(tuple(row))
        gen = g
    return tuple(windows)


def to_montgomery(p: Point) -> Point:
    """Edwards (u, v) -> Montgomery (x, y), for points other than the
    identity and (0, -1)."""
    u, v = p
    x = (1 + v) * pow(1 - v, -1, P) % P
    return x, x * pow(u, -1, P) % P * MONTGOMERY_SCALE % P


@functools.lru_cache(maxsize=None)
def pedersen_circuit_tables() -> Tuple[Tuple[Tuple[Point, ...], ...], ...]:
    """Per Pedersen generator, 63 windows of Montgomery [1..4] * 16^w * I."""
    out = []
    for gen in pedersen_generators():
        windows = []
        for _ in range(PEDERSEN_HASH_CHUNKS_PER_GENERATOR):
            row, g = [], gen
            for _ in range(4):
                row.append(to_montgomery(g))
                g = add(g, gen)
            windows.append(tuple(row))
            for _ in range(4):
                gen = double(gen)
        out.append(tuple(windows))
    return tuple(out)


def note_commitment_personalization() -> List[bool]:
    return [True] * 6


def merkle_personalization(depth: int) -> List[bool]:
    assert depth < 63
    return [bool((depth >> i) & 1) for i in range(6)]


def pedersen_hash_point(personalization: Sequence[bool], bits: Sequence[bool]) -> Point:
    """The Pedersen hash of personalization || bits as a point: 3-bit chunks
    (s0, s1, s2) -> (1 - 2 s2)(1 + s0 + 2 s1), chunk k of a segment weighted
    16^k, each 63-chunk segment times its generator."""
    data = list(personalization) + list(bits)
    data += [False] * (-len(data) % 3)
    chunks = [data[i : i + 3] for i in range(0, len(data), 3)]
    acc = IDENTITY
    for s, gen in zip(range(0, len(chunks), PEDERSEN_HASH_CHUNKS_PER_GENERATOR), pedersen_generators()):
        scalar = 0
        for k, (s0, s1, s2) in enumerate(chunks[s : s + PEDERSEN_HASH_CHUNKS_PER_GENERATOR]):
            enc = 1 + s0 + 2 * s1
            scalar += (-enc if s2 else enc) << (4 * k)
        acc = add(acc, mul(gen, scalar % R_J))
    assert len(chunks) <= PEDERSEN_HASH_CHUNKS_PER_GENERATOR * PEDERSEN_HASH_GENERATORS
    return acc
