"""mimc322, the program's side: the port's MiMCDemo circuit."""

from __future__ import annotations


def circuits(cfg, witnesses):
    """The port's circuits for the given (xl, xr) witnesses; a witness of
    None gives the circuit without values (the CRS's keypair synthesis)."""
    from bellman_mpc_tpu_torch.fields.bls12_381 import fr_host
    from bellman_mpc_tpu_torch.models import MiMCDemo, mimc_constants

    consts = mimc_constants(fr_host, seed=cfg["constants_seed"], rounds=cfg["rounds"])
    return [MiMCDemo(consts) if w is None else MiMCDemo(consts, w[0], w[1]) for w in witnesses]
