"""Wire formats: zkcrypto-compatible point encodings + key/proof IO.

Host-only copy of bellman_mpc_tpu/groth16/serialize.py on the port's host
fields and curves.  Byte-compatible with the reference's serialization surface:
  * `Proof::write/read` — compressed points, 192 bytes total
    (bellman/src/groth16/mod.rs:42-103; size pinned at :562).
  * `VerifyingKey::write/read` — uncompressed points + u32 BE ic length
    (mod.rs:146-221).
  * `Parameters::write/read` with `checked` mode — uncompressed points, u32 BE
    section lengths, identity/subgroup rejection (mod.rs:261-400; the
    1-constraint-circuit size is pinned at 2136 bytes, mod.rs:532).

Point encodings are the standard zkcrypto/BLS12-381 ones (the reference
inherits them from the `bls12_381`/`group` crates): 48-byte G1 / 96-byte G2
compressed with {compression, infinity, y-sort} flag bits in the top three
bits of the first byte; uncompressed doubles the size and keeps the flag
conventions.
"""

from __future__ import annotations

import io
import struct
from typing import List, Optional, Tuple

from ..curves import host as chost
from ..fields import bls12_381 as bc
from ..fields import tower as tw
from ..r1cs.core import IoError
from .types import Parameters, Proof, VerifyingKey

P = bc.P
FLAG_COMPRESSED = 0x80
FLAG_INFINITY = 0x40
FLAG_SORT = 0x20


def _fp2_sqrt(a: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    """Square root in Fp2 for p = 3 mod 4 (with final verification)."""
    if tw.fp2_is_zero(a):
        return (0, 0)
    a1 = tw.fp2_pow(a, (P - 3) // 4)
    x0 = tw.fp2_mul(a1, a)
    alpha = tw.fp2_mul(a1, x0)
    if alpha == ((P - 1) % P, 0):
        x = tw.fp2_mul((0, 1), x0)
    else:
        b = tw.fp2_pow(tw.fp2_add((1, 0), alpha), (P - 1) // 2)
        x = tw.fp2_mul(b, x0)
    if tw.fp2_mul(x, x) == (a[0] % P, a[1] % P):
        return x
    return None


def _y_is_sorted_g1(y: int) -> bool:
    """Lexicographically-largest flag for G1 (y > -y)."""
    return y > P - y


def _y_is_sorted_g2(y: Tuple[int, int]) -> bool:
    """G2 compares (c1, c0) lexicographically."""
    ny = tw.fp2_neg(y)
    return (y[1], y[0]) > (ny[1], ny[0])


# ------------------------------------------------------------------------- G1
def g1_to_compressed(p) -> bytes:
    if p is None:
        return bytes([FLAG_COMPRESSED | FLAG_INFINITY]) + b"\x00" * 47
    x, y = p
    buf = bytearray(x.to_bytes(48, "big"))
    buf[0] |= FLAG_COMPRESSED
    if _y_is_sorted_g1(y):
        buf[0] |= FLAG_SORT
    return bytes(buf)


def g1_to_uncompressed(p) -> bytes:
    if p is None:
        return bytes([FLAG_INFINITY]) + b"\x00" * 95
    x, y = p
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def g1_from_compressed(data: bytes, check_subgroup: bool = True):
    if len(data) != 48:
        raise IoError("bad G1 compressed length")
    flags = data[0]
    if not flags & FLAG_COMPRESSED:
        raise IoError("expected compressed G1")
    if flags & FLAG_INFINITY:
        if any(data[1:]) or (flags & ~(FLAG_COMPRESSED | FLAG_INFINITY)):
            raise IoError("malformed G1 infinity")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise IoError("G1 x not in field")
    y = bc.fp_host.sqrt((x * x % P * x + bc.B_G1) % P)
    if y is None:
        raise IoError("G1 x not on curve")
    if _y_is_sorted_g1(y) != bool(flags & FLAG_SORT):
        y = P - y
    pt = (x, y)
    if check_subgroup and not chost.G1.in_subgroup(pt):
        raise IoError("G1 point not in subgroup")
    return pt


def g1_from_uncompressed(data: bytes, check: bool = True):
    if len(data) != 96:
        raise IoError("bad G1 uncompressed length")
    flags = data[0]
    if flags & FLAG_COMPRESSED:
        raise IoError("expected uncompressed G1")
    if flags & FLAG_INFINITY:
        if any(data[1:]):
            raise IoError("malformed G1 infinity")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    y = int.from_bytes(data[48:], "big")
    if x >= P or y >= P:
        raise IoError("G1 coordinate not in field")
    pt = (x, y)
    if check:
        if not chost.G1.is_on_curve(pt):
            raise IoError("G1 point not on curve")
        if not chost.G1.in_subgroup(pt):
            raise IoError("G1 point not in subgroup")
    return pt


# ------------------------------------------------------------------------- G2
def g2_to_compressed(p) -> bytes:
    if p is None:
        return bytes([FLAG_COMPRESSED | FLAG_INFINITY]) + b"\x00" * 95
    (x, y) = p
    buf = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    buf[0] |= FLAG_COMPRESSED
    if _y_is_sorted_g2(y):
        buf[0] |= FLAG_SORT
    return bytes(buf)


def g2_to_uncompressed(p) -> bytes:
    if p is None:
        return bytes([FLAG_INFINITY]) + b"\x00" * 191
    (x, y) = p
    return (
        x[1].to_bytes(48, "big")
        + x[0].to_bytes(48, "big")
        + y[1].to_bytes(48, "big")
        + y[0].to_bytes(48, "big")
    )


def g2_from_compressed(data: bytes, check_subgroup: bool = True):
    if len(data) != 96:
        raise IoError("bad G2 compressed length")
    flags = data[0]
    if not flags & FLAG_COMPRESSED:
        raise IoError("expected compressed G2")
    if flags & FLAG_INFINITY:
        if any(data[1:]) or (flags & ~(FLAG_COMPRESSED | FLAG_INFINITY)):
            raise IoError("malformed G2 infinity")
        return None
    xc1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    xc0 = int.from_bytes(data[48:96], "big")
    if xc0 >= P or xc1 >= P:
        raise IoError("G2 x not in field")
    x = (xc0, xc1)
    rhs = tw.fp2_add(tw.fp2_mul(tw.fp2_mul(x, x), x), (4, 4))
    y = _fp2_sqrt(rhs)
    if y is None:
        raise IoError("G2 x not on curve")
    if _y_is_sorted_g2(y) != bool(flags & FLAG_SORT):
        y = tw.fp2_neg(y)
    pt = (x, y)
    if check_subgroup and not chost.G2.in_subgroup(pt):
        raise IoError("G2 point not in subgroup")
    return pt


def g2_from_uncompressed(data: bytes, check: bool = True):
    if len(data) != 192:
        raise IoError("bad G2 uncompressed length")
    flags = data[0]
    if flags & FLAG_COMPRESSED:
        raise IoError("expected uncompressed G2")
    if flags & FLAG_INFINITY:
        if any(data[1:]):
            raise IoError("malformed G2 infinity")
        return None
    xc1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    xc0 = int.from_bytes(data[48:96], "big")
    yc1 = int.from_bytes(data[96:144], "big")
    yc0 = int.from_bytes(data[144:192], "big")
    if max(xc0, xc1, yc0, yc1) >= P:
        raise IoError("G2 coordinate not in field")
    pt = ((xc0, xc1), (yc0, yc1))
    if check:
        if not chost.G2.is_on_curve(pt):
            raise IoError("G2 point not on curve")
        if not chost.G2.in_subgroup(pt):
            raise IoError("G2 point not in subgroup")
    return pt


# ------------------------------------------------------------------ proof IO
def proof_to_bytes(proof: Proof) -> bytes:
    """Compressed a | b | c — 192 bytes (mod.rs:42-48, size at :562)."""
    return (
        g1_to_compressed(proof.a)
        + g2_to_compressed(proof.b)
        + g1_to_compressed(proof.c)
    )


def proof_from_bytes(data: bytes) -> Proof:
    """Rejects invalid points and points at infinity (mod.rs:50-102)."""
    if len(data) != 192:
        raise IoError("bad proof length")
    a = g1_from_compressed(data[0:48])
    b = g2_from_compressed(data[48:144])
    c = g1_from_compressed(data[144:192])
    if a is None or b is None or c is None:
        raise IoError("point at infinity")
    return Proof(a=a, b=b, c=c)


# --------------------------------------------------------------------- vk IO
def vk_to_bytes(vk: VerifyingKey) -> bytes:
    out = io.BytesIO()
    out.write(g1_to_uncompressed(vk.alpha_g1))
    out.write(g1_to_uncompressed(vk.beta_g1))
    out.write(g2_to_uncompressed(vk.beta_g2))
    out.write(g2_to_uncompressed(vk.gamma_g2))
    out.write(g1_to_uncompressed(vk.delta_g1))
    out.write(g2_to_uncompressed(vk.delta_g2))
    out.write(struct.pack(">I", len(vk.ic)))
    for ic in vk.ic:
        out.write(g1_to_uncompressed(ic))
    return out.getvalue()


def vk_from_bytes(data: bytes) -> VerifyingKey:
    r = io.BytesIO(data)
    return _vk_from_stream(r)


def _vk_from_stream(r: io.BytesIO) -> VerifyingKey:
    def read(n):
        b = r.read(n)
        if len(b) != n:
            raise IoError("truncated vk")
        return b

    alpha_g1 = g1_from_uncompressed(read(96))
    beta_g1 = g1_from_uncompressed(read(96))
    beta_g2 = g2_from_uncompressed(read(192))
    gamma_g2 = g2_from_uncompressed(read(192))
    delta_g1 = g1_from_uncompressed(read(96))
    delta_g2 = g2_from_uncompressed(read(192))
    (ic_len,) = struct.unpack(">I", read(4))
    ic = []
    for _ in range(ic_len):
        pt = g1_from_uncompressed(read(96))
        if pt is None:
            raise IoError("point at infinity")
        ic.append(pt)
    return VerifyingKey(
        alpha_g1=alpha_g1,
        beta_g1=beta_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g1=delta_g1,
        delta_g2=delta_g2,
        ic=ic,
    )


# -------------------------------------------------------------- params IO
def params_to_bytes(params: Parameters) -> bytes:
    out = io.BytesIO()
    out.write(vk_to_bytes(params.vk))
    for section, writer in (
        (params.h, g1_to_uncompressed),
        (params.l, g1_to_uncompressed),
        (params.a, g1_to_uncompressed),
        (params.b_g1, g1_to_uncompressed),
        (params.b_g2, g2_to_uncompressed),
    ):
        out.write(struct.pack(">I", len(section)))
        for pt in section:
            out.write(writer(pt))
    return out.getvalue()


def params_from_bytes(data: bytes, checked: bool = True) -> Parameters:
    """`checked=False` skips curve/subgroup checks (mod.rs:292-330 fast path)
    but still rejects points at infinity."""
    r = io.BytesIO(data)
    vk = _vk_from_stream(r)

    def read(n):
        b = r.read(n)
        if len(b) != n:
            raise IoError("truncated parameters")
        return b

    def read_section(reader, size):
        (n,) = struct.unpack(">I", read(4))
        out = []
        for _ in range(n):
            pt = reader(read(size), checked)
            if pt is None:
                raise IoError("point at infinity")
            out.append(pt)
        return out

    h = read_section(g1_from_uncompressed, 96)
    l = read_section(g1_from_uncompressed, 96)
    a = read_section(g1_from_uncompressed, 96)
    b_g1 = read_section(g1_from_uncompressed, 96)
    b_g2 = read_section(g2_from_uncompressed, 192)
    return Parameters(vk=vk, h=h, l=l, a=a, b_g1=b_g1, b_g2=b_g2)
