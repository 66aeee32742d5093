"""sapling-spend, the reference's side: the secrets of each spend from the
seed, the public inputs worked out natively (reference/jubjub.py,
hashlib's BLAKE2s) and the frozen Spend circuit."""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List

from reference import jubjub as jj
from reference.circuits.sapling import Spend

CAPACITY = 254  # bits per packed public input (Fr's capacity)


def _bits_le(x: int, n: int) -> List[bool]:
    return [bool((x >> i) & 1) for i in range(n)]


def draw_witnesses(cfg, rng: random.Random, n: int) -> List[Dict]:
    out = []
    for _ in range(n):
        w = {"value": rng.randrange(1, 1 << 64)}
        for k in ("rcv", "ask", "nsk", "ar", "rcm"):
            w[k] = rng.randrange(1, jj.R_J)
        while True:
            d = bytes(rng.randrange(256) for _ in range(11))
            if jj.group_hash(d, b"Zcash_gd") is not None:
                break
        w["diversifier"] = d
        w["siblings"] = [rng.randrange(jj.P) for _ in range(cfg["merkle_depth"])]
        w["positions"] = [bool(rng.getrandbits(1)) for _ in range(cfg["merkle_depth"])]
        out.append(w)
    return out


def public_inputs(cfg, w) -> List[int]:
    """[rk.u, rk.v, cv.u, cv.v, anchor, nf packed into two]."""
    gens = jj.generators()
    ak = jj.mul(gens["spending_key"], w["ask"])
    nk = jj.mul(gens["proof_generation_key"], w["nsk"])
    rk = jj.add(ak, jj.mul(gens["spending_key"], w["ar"]))
    cv = jj.add(jj.mul(gens["value_commitment_value"], w["value"]),
                jj.mul(gens["value_commitment_randomness"], w["rcv"]))
    ivk_digest = hashlib.blake2s(jj.encode(ak) + jj.encode(nk), digest_size=32, person=b"Zcashivk").digest()
    ivk = int.from_bytes(ivk_digest, "little") % (1 << 251)
    g_d = jj.group_hash(w["diversifier"], b"Zcash_gd")
    pk_d = jj.mul(g_d, ivk)
    note = _bits_le(w["value"], 64) + jj.repr_bits(g_d) + jj.repr_bits(pk_d)
    cm = jj.add(jj.pedersen_hash_point(jj.note_commitment_personalization(), note),
                jj.mul(gens["note_commitment_randomness"], w["rcm"]))
    node = cm[0]
    for depth, (sibling, right) in enumerate(zip(w["siblings"], w["positions"])):
        left, rght = (sibling, node) if right else (node, sibling)
        node = jj.pedersen_hash_point(jj.merkle_personalization(depth), _bits_le(left, 255) + _bits_le(rght, 255))[0]
    position = sum(1 << i for i, b in enumerate(w["positions"]) if b)
    rho = jj.add(cm, jj.mul(gens["nullifier_position"], position))
    nf = int.from_bytes(hashlib.blake2s(jj.encode(nk) + jj.encode(rho), digest_size=32, person=b"Zcash_nf").digest(),
                        "little")
    return [rk[0], rk[1], cv[0], cv[1], node, nf & ((1 << CAPACITY) - 1), nf >> CAPACITY]


def circuit(cfg):
    return Spend()
