"""sha256-block, the program's side: one SHA-256 compression of a private
512-bit block through the port's gadgets, its digest packed into public
inputs."""

from __future__ import annotations


def circuits(cfg, blocks):
    """The port's circuits for the given 64-byte blocks; a block of None
    gives the circuit without values (the CRS's keypair synthesis)."""
    from bellman_mpc_tpu_torch.gadgets import AllocatedBit, Boolean, pack_into_inputs, sha256_block_no_padding
    from bellman_mpc_tpu_torch.r1cs.core import Circuit

    class Sha256Block(Circuit):
        def __init__(self, block):
            self.bits = ([None] * 512 if block is None
                         else [bool((byte >> i) & 1) for byte in block for i in range(7, -1, -1)])

        def synthesize(self, cs) -> None:
            bits = [Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"input bit {i}"), b))
                    for i, b in enumerate(self.bits)]
            digest = sha256_block_no_padding(cs.namespace("sha256"), bits)
            pack_into_inputs(cs.namespace("pack digest"), digest)

    return [Sha256Block(b) for b in blocks]
