"""The plain reference against the textbook and against the port, on the
CPU: the pairing, the point encoding, the Lagrange basis, the circuits'
input columns and public inputs.  (The proofs the port makes through
BatchProver are judged in test_bench_port_run.py.)"""

import hashlib
import importlib.util
import json
import random

import pytest

from reference import bls12_381 as bls
from reference import groth16 as rg

BENCH = __import__("conftest").BENCH


def _config(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    mods = []
    for suffix in ("", "_ref"):
        spec = importlib.util.spec_from_file_location(f"t_cfg_{name}{suffix}", BENCH / "configs" / f"{name}{suffix}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    return cfg, mods[0], mods[1]


def test_pairing_is_bilinear_and_not_degenerate():
    a, b = 0x1234567890ABCDEF1234, 0xFEDCBA0987654321
    pa, qb = bls.G1.mul(bls.G1_GEN, a), bls.G2.mul(bls.G2_GEN, b)
    assert bls.pairing_product_is_one([(pa, qb), (bls.G1.neg(bls.G1.mul(bls.G1_GEN, a * b % bls.R)), bls.G2_GEN)])
    assert not bls.pairing_product_is_one([(pa, qb), (bls.G1.neg(bls.G1.mul(bls.G1_GEN, a * b + 1)), bls.G2_GEN)])
    assert not bls.pairing_product_is_one([(bls.G1_GEN, bls.G2_GEN)])


def test_pairing_is_the_ports_cubed():
    """The final exponentiation raises to 3 (p^12 - 1) / r; the port's
    textbook pairing (one power (p^12 - 1) / r) cubed is the same value."""
    from bellman_mpc_tpu_torch.curves import pairing_host
    from bellman_mpc_tpu_torch.fields import tower

    p, q = bls.G1.mul(bls.G1_GEN, 5), bls.G2.mul(bls.G2_GEN, 7)
    e = pairing_host.pairing(p, q)
    assert bls.final_exponentiation(bls.miller_loop([(p, q)])) == tower.fp12_mul(tower.fp12_mul(e, e), e)
    assert bls.f12_frob(e) == bls.f12_pow(e, bls.P)


def test_point_encoding_matches_ports():
    from bellman_mpc_tpu_torch.groth16 import serialize

    rng = random.Random(3)
    for _ in range(4):
        p, q = bls.G1.mul(bls.G1_GEN, rng.randrange(bls.R)), bls.G2.mul(bls.G2_GEN, rng.randrange(bls.R))
        for pt in (p, bls.G1.neg(p)):
            raw = serialize.g1_to_compressed(pt)
            assert bls.g1_compress(pt) == raw and bls.g1_decompress(raw) == pt
        for pt in (q, bls.G2.neg(q)):
            raw = serialize.g2_to_compressed(pt)
            assert bls.g2_compress(pt) == raw and bls.g2_decompress(raw) == pt
    not_below_p = bytearray(bls.P.to_bytes(48, "big"))
    not_below_p[0] |= 0x80
    with pytest.raises(bls.EncodingError):
        bls.g1_decompress(bytes(not_below_p))
    with pytest.raises(bls.EncodingError):
        bls.g1_decompress(bytes(48))  # the compression flag unset


def test_root_of_unity_and_lagrange_basis_match_ports():
    from bellman_mpc_tpu_torch.fields.bls12_381 import fr_host
    from bellman_mpc_tpu_torch.groth16 import Bls12Engine
    from bellman_mpc_tpu_torch.groth16.generator import lagrange_coeffs_at_tau

    assert rg.FR_ROOT_OF_UNITY == fr_host.root_of_unity
    tau = 0x0123456789ABCDEF
    want = lagrange_coeffs_at_tau(Bls12Engine("cpu"), 16, tau)
    assert [rg.lagrange_at(tau, 4, range(16))[j] for j in range(16)] == want


def _port_columns(circuit):
    from bellman_mpc_tpu_torch.groth16 import Bls12Engine
    from bellman_mpc_tpu_torch.groth16.generator import synthesize_keypair

    asm = synthesize_keypair(Bls12Engine("cpu"), circuit)
    cols = []
    for t in (asm.at_inputs, asm.bt_inputs, asm.ct_inputs):
        col = {}
        for i, entries in enumerate(t):
            for c, j in entries:
                col.setdefault(i, {})[j] = (col.get(i, {}).get(j, 0) + c) % bls.R
        cols.append(col)
    return asm.num_constraints, tuple(cols)


def _merged(col):
    out = {}
    for i, row in col.items():
        row = {j: c for j, c in row.items() if c}
        if row:
            out[i] = row
    return out


@pytest.mark.parametrize("name", ["mimc322", "sha256-block"])
def test_frozen_circuit_has_the_ports_input_columns(name):
    """The reference's copy of each circuit gives the constraint count and
    the public inputs' columns of A, B, C that the port's keypair
    synthesis gives: the verifying key is the program's."""
    cfg, prog, ref = _config(name)
    n, cols = _port_columns(prog.circuits(cfg, [None])[0])
    cs = rg.InputColumns()
    ref.circuit(cfg).synthesize(cs)
    cs.finish()
    assert cs.num_constraints == n == cfg["constraints"] + cfg["public_inputs"] + 1
    assert 1 << rg.domain_exp(n) == cfg["domain"]
    assert tuple(_merged(c) for c in cs.cols) == tuple(_merged(c) for c in cols)


def test_sha256_public_inputs_are_the_ports():
    """The port's circuit, synthesized with a witness, exposes as public
    inputs the packed digest that hashlib gives the reference."""
    from bellman_mpc_tpu_torch.fields.bls12_381 import fr_host
    from bellman_mpc_tpu_torch.r1cs import TestConstraintSystem

    cfg, prog, ref = _config("sha256-block")
    (block,) = ref.draw_witnesses(cfg, random.Random(11), 1)
    msg = block[: cfg["message_bytes"]]
    assert hashlib.sha256(msg).digest() != hashlib.sha256(block).digest()
    cs = TestConstraintSystem(fr_host)
    prog.circuits(cfg, [block])[0].synthesize(cs)
    assert cs.is_satisfied()
    assert cs.num_constraints() == cfg["constraints"]
    assert cs.verify(ref.public_inputs(cfg, block))
    assert not cs.verify([x + 1 for x in ref.public_inputs(cfg, block)])


def test_mimc_public_input_is_the_ports():
    from bellman_mpc_tpu_torch.fields.bls12_381 import fr_host
    from bellman_mpc_tpu_torch.models import mimc, mimc_constants

    cfg, _, ref = _config("mimc322")
    w = ref.draw_witnesses(cfg, random.Random(2), 1)[0]
    assert ref.public_inputs(cfg, w) == [mimc(fr_host, w[0], w[1], mimc_constants(fr_host, 42))]
