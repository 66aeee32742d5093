"""The Zcash Sapling Spend statement (frozen copy of the program's
models/sapling.py circuit).

Port of zcash_proofs/src/circuit/sapling.rs (`Spend::synthesize` and
`expose_value_commitment`): 98,777 constraints and 7 public inputs, in
order rk (u, v), cv (u, v), the anchor and the nullifier packed into two.
The prover shows that it knows

  * a value commitment opening (value, rcv) with cv = [value] V + [rcv] R;
  * a proof generation key (ak, nsk) and a randomizer ar with
    rk = ak + [ar] G, ak not of small order;
  * a note (g_d, pk_d, value, rcm) with pk_d = [ivk] g_d, where
    ivk = BLAKE2s("Zcashivk", repr(ak) || repr(nk)) cut to 251 bits and
    nk = [nsk] H, whose commitment cm = PedersenHash(note) + [rcm] R_cm
    sits in the depth-32 tree under the anchor (unless the value is 0);
  * nf = BLAKE2s("Zcash_nf", repr(nk) || repr(cm + [position] J)).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .. import jubjub
from .blake2s import blake2s
from .boolean import (
    AllocatedBit,
    Boolean,
    _consume,
    field_into_boolean_vec_le,
    need,
    u64_into_boolean_vec_le,
)
from .ecc import EdwardsPoint, closed, fixed_base_multiplication
from .multipack import pack_into_inputs
from .num import AllocatedNum, Num
from .pedersen_hash import Personalization, pedersen_hash
from .core import Circuit

TREE_DEPTH = 32
CRH_IVK_PERSONALIZATION = b"Zcashivk"
PRF_NF_PERSONALIZATION = b"Zcash_nf"
DIVERSIFIER_PERSONALIZATION = b"Zcash_gd"

Point = Tuple[int, int]


def _fixed_base(cs, name: str, bits):
    return fixed_base_multiplication(cs, jubjub.fixed_base_table(name), bits)


@_consume
def _expose_value_commitment(cs, value: Optional[int], rcv: Optional[int]) -> List[Boolean]:
    """cv = [value] V + [rcv] R as a public input; returns value's 64 bits."""
    value_bits = u64_into_boolean_vec_le(cs.namespace("value"), value)
    v = _fixed_base(cs.namespace("compute the value in the exponent"), "value_commitment_value", value_bits)
    rcv_bits = field_into_boolean_vec_le(cs.namespace("rcv"), jubjub.fs_host, rcv)
    r = _fixed_base(cs.namespace("computation of rcv"), "value_commitment_randomness", rcv_bits)
    cv = v.add(cs.namespace("computation of cv"), r)
    cv.inputize(cs.namespace("commitment point"))
    return value_bits


class Spend(Circuit):
    """The Spend statement; every witness None gives the circuit's shape
    (the CRS's and the prover's template synthesis).  `auth_path` holds,
    leaf first, (sibling, the current node is the right child) per level."""

    def __init__(self, value: Optional[int] = None, rcv: Optional[int] = None,
                 ak: Optional[Point] = None, nsk: Optional[int] = None, ar: Optional[int] = None,
                 g_d: Optional[Point] = None, rcm: Optional[int] = None,
                 auth_path: Optional[Sequence[Optional[Tuple[int, bool]]]] = None,
                 anchor: Optional[int] = None):
        self.value, self.rcv, self.ak, self.nsk, self.ar = value, rcv, ak, nsk, ar
        self.g_d, self.rcm, self.anchor = g_d, rcm, anchor
        self.auth_path = list(auth_path) if auth_path is not None else [None] * TREE_DEPTH
        assert len(self.auth_path) == TREE_DEPTH

    def synthesize(self, cs) -> None:
        fr, fs = cs.field, jubjub.fs_host

        ak = EdwardsPoint.witness(cs.namespace("ak"), self.ak)
        ak.assert_not_small_order(cs.namespace("ak not small order"))

        # rk = ak + [ar] G, public
        ar = field_into_boolean_vec_le(cs.namespace("ar"), fs, self.ar)
        ar = _fixed_base(cs.namespace("computation of randomization for the signing key"), "spending_key", ar)
        rk = ak.add(cs.namespace("computation of rk"), ar)
        rk.inputize(cs.namespace("rk"))

        nsk = field_into_boolean_vec_le(cs.namespace("nsk"), fs, self.nsk)
        nk = _fixed_base(cs.namespace("computation of nk"), "proof_generation_key", nsk)

        ivk_preimage = ak.repr(cs.namespace("representation of ak"))
        repr_nk = nk.repr(cs.namespace("representation of nk"))
        ivk_preimage += repr_nk
        nf_preimage = list(repr_nk)
        assert len(ivk_preimage) == 512 and len(nf_preimage) == 256

        with closed(cs):
            ivk = blake2s(cs.namespace("computation of ivk"), ivk_preimage, CRH_IVK_PERSONALIZATION)
        ivk = ivk[: fs.capacity]  # 251 bits, so ivk lies in the scalar field

        g_d = EdwardsPoint.witness(cs.namespace("witness g_d"), self.g_d)
        g_d.assert_not_small_order(cs.namespace("g_d not small order"))
        pk_d = g_d.mul(cs.namespace("compute pk_d"), ivk)

        value_bits = _expose_value_commitment(cs.namespace("value commitment"), self.value, self.rcv)
        value_num = Num.zero(fr)
        for i, bit in enumerate(value_bits):
            value_num = value_num.add_bool_with_coeff(cs.one(), bit, 1 << i)
        note_contents = list(value_bits)
        note_contents += g_d.repr(cs.namespace("representation of g_d"))
        note_contents += pk_d.repr(cs.namespace("representation of pk_d"))
        assert len(note_contents) == 64 + 256 + 256

        cm = pedersen_hash(cs.namespace("note content hash"), Personalization.note_commitment(), note_contents)
        rcm = field_into_boolean_vec_le(cs.namespace("rcm"), fs, self.rcm)
        rcm = _fixed_base(cs.namespace("computation of commitment randomness"), "note_commitment_randomness", rcm)
        cm = cm.add(cs.namespace("randomization of note commitment"), rcm)

        position_bits = []
        cur = cm.get_u()
        for i, e in enumerate(self.auth_path):
            with cs.namespace(f"merkle tree hash {i}") as ns:
                cur_is_right = Boolean.from_bit(
                    AllocatedBit.alloc(ns.namespace("position bit"), None if e is None else e[1]))
                position_bits.append(cur_is_right)
                path_element = AllocatedNum.alloc(ns.namespace("path element"), lambda e=e: need(e)[0])
                ul, ur = AllocatedNum.conditionally_reverse(
                    ns.namespace("conditional reversal of preimage"), cur, path_element, cur_is_right)
                preimage = []
                for name, num in (("ul", ul), ("ur", ur)):
                    with ns.namespace(name) as half:  # to_bits_le leaves its unpacking here
                        preimage += num.to_bits_le(half.namespace(f"{name} into bits"))
                cur = pedersen_hash(ns.namespace("computation of pedersen hash"),
                                    Personalization.merkle_tree(i), preimage).get_u()

        rt = AllocatedNum.alloc(cs.namespace("conditional anchor"), lambda: need(self.anchor))
        # (cur - rt) * value = 0: with a nonzero value the root is the anchor
        cs.enforce(
            "conditionally enforce correct root",
            lambda lc: lc + cur.get_variable() - rt.get_variable(),
            lambda lc: lc + value_num.lc(1),
            lambda lc: lc,
        )
        with closed(cs):
            rt.inputize(cs.namespace("anchor"))

        position = _fixed_base(cs.namespace("g^position"), "nullifier_position", position_bits)
        rho = cm.add(cs.namespace("faerie gold prevention"), position)
        nf_preimage += rho.repr(cs.namespace("representation of rho"))
        assert len(nf_preimage) == 512
        with closed(cs):
            nf = blake2s(cs.namespace("nf computation"), nf_preimage, PRF_NF_PERSONALIZATION)
        pack_into_inputs(cs.namespace("pack nullifier"), nf)
