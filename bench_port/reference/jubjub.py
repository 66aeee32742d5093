"""Plain Jubjub for judging Sapling proofs: Python integers only.

Jubjub is the twisted Edwards curve -u^2 + v^2 = 1 + d u^2 v^2 over the
BLS12-381 scalar field, d = -10240/10241, with a prime-order subgroup of
order R_J and cofactor 8 (the Zcash protocol specification, section
"Jubjub").  Written from the specification, independently of the program:

  * points in extended coordinates (X : Y : T : Z), u = X/Z, v = Y/Z,
    T = XY/Z, with the unified a = -1 addition of Hisil, Wong, Carter and
    Dawson (2008), which is complete on Jubjub;
  * abst/repr: the 32-byte encoding, v little-endian with the sign of u in
    the top bit; square roots by Tonelli-Shanks;
  * GroupHash^J(D, M): BLAKE2s-256 of URS || M personalized by D, decoded,
    times 8, refused at the identity; FindGroupHash^J appends a counter
    byte;
  * the generators of Sapling, the native Pedersen hash, and the window
    tables that the frozen gadget copies (circuits/ecc.py and
    circuits/pedersen_hash.py) read, in the layout they read them.
"""

from __future__ import annotations

import functools
import hashlib
from typing import List, Optional, Sequence, Tuple

from .bls12_381 import R as P
from .circuits.field import PrimeField

Affine = Tuple[int, int]

D = (-10240 * pow(10241, P - 2, P)) % P
R_J = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7
fs_host = PrimeField(R_J, name="Fs")
URS = b"096b36a5804bfacef1691e173c366a47ff5ba84a44f26ddd7e8d9f79d5b42df0"

MONTGOMERY_A = 40962  # 2 (a + d) / (a - d)
FIXED_BASE_CHUNKS_PER_GENERATOR = 84
PEDERSEN_HASH_CHUNKS_PER_GENERATOR = 63
PEDERSEN_HASH_GENERATORS = 6


def _sqrt(a: int) -> Optional[int]:
    """Tonelli-Shanks in Fr (r - 1 = 2^32 t), or None for a non-square."""
    a %= P
    if a == 0:
        return 0
    if pow(a, (P - 1) // 2, P) != 1:
        return None
    s, t = 32, (P - 1) >> 32
    z = 7  # a non-square: 7 generates Fr*
    m, c, x, b = s, pow(z, t, P), pow(a, (t + 1) // 2, P), pow(a, t, P)
    while b != 1:
        i, b2 = 0, b
        while b2 != 1:
            b2 = b2 * b2 % P
            i += 1
        g = pow(c, 1 << (m - i - 1), P)
        m, c = i, g * g % P
        x, b = x * g % P, b * c % P
    return x


# u = SCALE x / y; of the two roots the odd one, as librustzcash's Jubjub parameters take it
_scale = _sqrt(-40964)
MONTGOMERY_SCALE = _scale if _scale % 2 == 1 else P - _scale


# --------------------------------------------------------------- the group
IDENTITY = (0, 1, 0, 1)


def from_affine(p: Affine):
    u, v = p
    return (u, v, u * v % P, 1)


def to_affine(p) -> Affine:
    x, y, _, z = p
    zi = pow(z, P - 2, P)
    return (x * zi % P, y * zi % P)


def padd(p, q):
    """add-2008-hwcd with a = -1."""
    x1, y1, t1, z1 = p
    x2, y2, t2, z2 = q
    a = x1 * x2 % P
    b = y1 * y2 % P
    c = D * t1 % P * t2 % P
    dd = z1 * z2 % P
    e = ((x1 + y1) * (x2 + y2) - a - b) % P
    f = (dd - c) % P
    g = (dd + c) % P
    h = (b + a) % P  # b - a*A with A = -1
    return (e * f % P, g * h % P, e * h % P, f * g % P)


def pmul(p, k: int):
    acc = IDENTITY
    for bit in bin(k)[2:]:
        acc = padd(acc, acc)
        if bit == "1":
            acc = padd(acc, p)
    return acc


def add(p: Affine, q: Affine) -> Affine:
    return to_affine(padd(from_affine(p), from_affine(q)))


def mul(p: Affine, k: int) -> Affine:
    return to_affine(pmul(from_affine(p), k))


def on_curve(p: Affine) -> bool:
    u, v = p
    return (-u * u + v * v - 1 - D * u * u % P * v * v) % P == 0


def encode(p: Affine) -> bytes:
    u, v = p
    return (v + ((u & 1) << 255)).to_bytes(32, "little")


def decode(data: bytes) -> Optional[Affine]:
    y = int.from_bytes(data, "little")
    sign, v = y >> 255, y & ((1 << 255) - 1)
    if v >= P:
        return None
    vv = v * v % P
    u = _sqrt((vv - 1) * pow(D * vv + 1, P - 2, P))
    if u is None or (u == 0 and sign == 1):
        return None
    return ((P - u) % P if (u & 1) != sign else u, v)


def repr_bits(p: Affine) -> List[bool]:
    data = encode(p)
    return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(256)]


def group_hash(tag: bytes, personalization: bytes) -> Optional[Affine]:
    digest = hashlib.blake2s(URS + tag, digest_size=32, person=personalization).digest()
    p = decode(digest)
    if p is None:
        return None
    q = mul(p, 8)
    return None if q == (0, 1) else q


def find_group_hash(tag: bytes, personalization: bytes) -> Affine:
    for i in range(256):
        p = group_hash(tag + bytes([i]), personalization)
        if p is not None:
            return p
    raise ValueError("FindGroupHash found no point")


@functools.lru_cache(maxsize=None)
def generators() -> dict:
    return {
        "spending_key": find_group_hash(b"", b"Zcash_G_"),
        "proof_generation_key": find_group_hash(b"", b"Zcash_H_"),
        "note_commitment_randomness": find_group_hash(b"r", b"Zcash_PH"),
        "nullifier_position": find_group_hash(b"", b"Zcash_J_"),
        "value_commitment_value": find_group_hash(b"v", b"Zcash_cv"),
        "value_commitment_randomness": find_group_hash(b"r", b"Zcash_cv"),
    }


@functools.lru_cache(maxsize=None)
def pedersen_generators() -> Tuple[Affine, ...]:
    return tuple(find_group_hash(i.to_bytes(4, "little"), b"Zcash_PH") for i in range(PEDERSEN_HASH_GENERATORS))


# ------------------------------------------------------------- the hashes
def note_commitment_personalization() -> List[bool]:
    return [True] * 6


def merkle_personalization(depth: int) -> List[bool]:
    return [bool((depth >> i) & 1) for i in range(6)]


def pedersen_hash_point(personalization: Sequence[bool], bits: Sequence[bool]) -> Affine:
    """Sum over segments of [<M_i>] I_i, <M_i> = sum_k enc(m_k) 2^(4k),
    enc(s0, s1, s2) = (1 - 2 s2)(1 + s0 + 2 s1)."""
    m = list(personalization) + list(bits)
    m += [False] * (-len(m) % 3)
    seg_bits = 3 * PEDERSEN_HASH_CHUNKS_PER_GENERATOR
    total = IDENTITY
    for i in range(0, len(m), seg_bits):
        seg = m[i : i + seg_bits]
        s = 0
        for k in range(len(seg) // 3):
            s0, s1, s2 = seg[3 * k : 3 * k + 3]
            s += (1 - 2 * s2) * (1 + s0 + 2 * s1) * 16 ** k
        total = padd(total, pmul(from_affine(pedersen_generators()[i // seg_bits]), s % R_J))
    return to_affine(total)


# --------------------------------------- tables the frozen gadgets read
@functools.lru_cache(maxsize=None)
def fixed_base_table(name: str):
    """84 windows w of [j 8^w G for j in 0..7], affine."""
    g = generators()[name]
    out = []
    for w in range(FIXED_BASE_CHUNKS_PER_GENERATOR):
        base = mul(g, pow(8, w))
        out.append(tuple(mul(base, j) for j in range(8)))
    return tuple(out)


def _montgomery(p: Affine) -> Affine:
    u, v = p
    x = (1 + v) * pow(1 - v, P - 2, P) % P
    return (x, x * pow(u, P - 2, P) % P * MONTGOMERY_SCALE % P)


@functools.lru_cache(maxsize=None)
def pedersen_circuit_tables():
    """Per generator I, 63 windows w of Montgomery [j 16^w I for j in 1..4]."""
    return tuple(
        tuple(tuple(_montgomery(mul(gen, j * 16 ** w)) for j in range(1, 5))
              for w in range(PEDERSEN_HASH_CHUNKS_PER_GENERATOR))
        for gen in pedersen_generators())
