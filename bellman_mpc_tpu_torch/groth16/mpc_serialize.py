"""Ceremony-state serialization: the resumable cross-player checkpoint.

Copy of bellman_mpc_tpu/groth16/mpc_serialize.py on the port's codecs.

The reference's ceremony state structs (`CommonParamterInStorage`
mpc.rs:397-414, `UnCommonParamterInStorage` mpc.rs:925-942) are "plain
point-vector structs designed to be serialized across the player/verifier
trust boundary" (SURVEY.md §3.4) — the fork relies on the Rust types' layout.
Here the wire format is explicit: uncompressed zkcrypto point encodings with
u32 big-endian vector lengths, matching the Parameters conventions
(groth16/serialize.py).
"""

from __future__ import annotations

import io
import struct
from typing import List

from .mpc import CommonParamterInStorage, UnCommonParamterInStorage
from .serialize import (
    g1_from_uncompressed,
    g1_to_uncompressed,
    g2_from_uncompressed,
    g2_to_uncompressed,
)


def _w_vec_g1(out, pts: List) -> None:
    out.write(struct.pack(">I", len(pts)))
    for p in pts:
        out.write(g1_to_uncompressed(p))


def _w_vec_g2(out, pts: List) -> None:
    out.write(struct.pack(">I", len(pts)))
    for p in pts:
        out.write(g2_to_uncompressed(p))


def _r_vec(r, reader, size) -> List:
    (n,) = struct.unpack(">I", r.read(4))
    return [reader(r.read(size)) for _ in range(n)]


def common_storage_to_bytes(s: CommonParamterInStorage) -> bytes:
    out = io.BytesIO()
    out.write(g1_to_uncompressed(s.alpha_g1))
    out.write(g2_to_uncompressed(s.alpha_g2))
    out.write(g1_to_uncompressed(s.beta_g1))
    out.write(g2_to_uncompressed(s.beta_g2))
    _w_vec_g1(out, s.tau_g1)
    _w_vec_g2(out, s.tau_g2)
    _w_vec_g1(out, s.alpha_mul_tau_g1)
    _w_vec_g2(out, s.alpha_mul_tau_g2)
    _w_vec_g1(out, s.beta_mul_tau_g1)
    _w_vec_g2(out, s.beta_mul_tau_g2)
    return out.getvalue()


def common_storage_from_bytes(data: bytes) -> CommonParamterInStorage:
    r = io.BytesIO(data)
    return CommonParamterInStorage(
        alpha_g1=g1_from_uncompressed(r.read(96)),
        alpha_g2=g2_from_uncompressed(r.read(192)),
        beta_g1=g1_from_uncompressed(r.read(96)),
        beta_g2=g2_from_uncompressed(r.read(192)),
        tau_g1=_r_vec(r, g1_from_uncompressed, 96),
        tau_g2=_r_vec(r, g2_from_uncompressed, 192),
        alpha_mul_tau_g1=_r_vec(r, g1_from_uncompressed, 96),
        alpha_mul_tau_g2=_r_vec(r, g2_from_uncompressed, 192),
        beta_mul_tau_g1=_r_vec(r, g1_from_uncompressed, 96),
        beta_mul_tau_g2=_r_vec(r, g2_from_uncompressed, 192),
    )


def uncommon_storage_to_bytes(s: UnCommonParamterInStorage) -> bytes:
    out = io.BytesIO()
    out.write(g1_to_uncompressed(s.gamma_g1))
    out.write(g2_to_uncompressed(s.gamma_g2))
    out.write(g1_to_uncompressed(s.delta_g1))
    out.write(g2_to_uncompressed(s.delta_g2))
    _w_vec_g1(out, s.kin_g1)
    _w_vec_g2(out, s.kin_g2)
    _w_vec_g1(out, s.kout_g1)
    _w_vec_g2(out, s.kout_g2)
    _w_vec_g1(out, s.h_g1)
    _w_vec_g2(out, s.h_g2)
    return out.getvalue()


def uncommon_storage_from_bytes(data: bytes) -> UnCommonParamterInStorage:
    r = io.BytesIO(data)
    return UnCommonParamterInStorage(
        gamma_g1=g1_from_uncompressed(r.read(96)),
        gamma_g2=g2_from_uncompressed(r.read(192)),
        delta_g1=g1_from_uncompressed(r.read(96)),
        delta_g2=g2_from_uncompressed(r.read(192)),
        kin_g1=_r_vec(r, g1_from_uncompressed, 96),
        kin_g2=_r_vec(r, g2_from_uncompressed, 192),
        kout_g1=_r_vec(r, g1_from_uncompressed, 96),
        kout_g2=_r_vec(r, g2_from_uncompressed, 192),
        h_g1=_r_vec(r, g1_from_uncompressed, 96),
        h_g2=_r_vec(r, g2_from_uncompressed, 192),
    )
