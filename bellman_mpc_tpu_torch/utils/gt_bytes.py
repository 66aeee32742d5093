"""Gt (Fp12) on-chain byte formatting.

Copy of bellman_mpc_tpu/utils/gt_bytes.py, a port of bellman/src/gt_bytes.rs:
`gt_format` produces the 576-byte big-endian encoding an external VM
consumes, with the tower serialized in c1-before-c0 order at every level
(gt_bytes.rs:32-59):

    Gt  -> fp6(c1) || fp6(c0)              (576 = 2 x 288)
    fp6 -> fp2(c2) || fp2(c1) || fp2(c0)   (288 = 3 x 96)
    fp2 -> fp(c1)  || fp(c0)               (96  = 2 x 48)
    fp  -> 48-byte big-endian integer      (Montgomery-reduced;
                                            gt_bytes.rs:61-75 + the
                                            hand-written reduction :76-151)

The reference reaches into the Rust `Gt`'s private Montgomery limbs via
`unsafe transmute`; here Fp12 values are exact host tuples (fields/tower.py)
so the "Montgomery reduction" is already done — only the byte layout
remains.  The inverse (`gt_parse`) is provided for round-tripping.
"""

from __future__ import annotations

from typing import Tuple

from ..fields.tower import Fp12T


def _fp_bytes(v: int) -> bytes:
    return int(v).to_bytes(48, "big")


def _fp2_bytes(c: Tuple[int, int]) -> bytes:
    return _fp_bytes(c[1]) + _fp_bytes(c[0])


def _fp6_bytes(c) -> bytes:
    return _fp2_bytes(c[2]) + _fp2_bytes(c[1]) + _fp2_bytes(c[0])


def gt_format(gt: Fp12T) -> bytes:
    """576-byte on-chain encoding of a pairing result (gt_bytes.rs:32-39)."""
    c0, c1 = gt
    return _fp6_bytes(c1) + _fp6_bytes(c0)


def gt_parse(data: bytes) -> Fp12T:
    """Inverse of gt_format."""
    assert len(data) == 576

    def fp(at: int) -> int:
        return int.from_bytes(data[at : at + 48], "big")

    def fp2(at: int) -> Tuple[int, int]:
        return (fp(at + 48), fp(at))

    def fp6(at: int):
        return (fp2(at + 192), fp2(at + 96), fp2(at))

    c1 = fp6(0)
    c0 = fp6(288)
    return (c0, c1)
