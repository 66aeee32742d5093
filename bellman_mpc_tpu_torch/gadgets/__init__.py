"""Gadget library: in-circuit building blocks (bellman/src/gadgets/)."""

from .boolean import (
    AllocatedBit,
    Boolean,
    field_into_allocated_bits_le,
    field_into_boolean_vec_le,
    u64_into_boolean_vec_le,
)
from .blake2s import blake2s
from .ecc import EdwardsPoint, MontgomeryPoint, fixed_base_multiplication
from .lookup import lookup3_xy, lookup3_xy_with_conditional_negation
from .multieq import MultiEq
from .multipack import (
    bytes_to_bits,
    bytes_to_bits_le,
    compute_multipacking,
    pack_into_inputs,
)
from .num import AllocatedNum, Num
from .pedersen_hash import Personalization, pedersen_hash
from .sha256 import sha256, sha256_block_no_padding
from .uint32 import UInt32

__all__ = [
    "AllocatedBit", "Boolean", "field_into_allocated_bits_le",
    "field_into_boolean_vec_le", "u64_into_boolean_vec_le", "blake2s",
    "EdwardsPoint", "MontgomeryPoint", "fixed_base_multiplication",
    "lookup3_xy", "lookup3_xy_with_conditional_negation", "MultiEq",
    "bytes_to_bits", "bytes_to_bits_le", "compute_multipacking",
    "pack_into_inputs", "AllocatedNum", "Num", "Personalization", "pedersen_hash", "sha256",
    "sha256_block_no_padding", "UInt32",
]
