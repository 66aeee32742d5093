"""sapling-spend, the program's side: the port's Sapling Spend circuit,
built from the secrets the reference draws (the port works out ak, g_d and
the anchor itself)."""

from __future__ import annotations


def circuits(cfg, witnesses):
    """The port's Spend circuits for the given secrets; a witness of None
    gives the circuit without values (the CRS's keypair synthesis)."""
    from bellman_mpc_tpu_torch.models.sapling import Spend, diversified_base, spend_from_secrets

    return [Spend() if w is None else spend_from_secrets(
        w["value"], w["rcv"], w["ask"], w["nsk"], w["ar"], w["rcm"], diversified_base(w["diversifier"]),
        list(zip(w["siblings"], w["positions"]))) for w in witnesses]
