"""The port's ceremony and mock engine against the reference, on the CPU.

* The ceremony flows of tests/test_mpc.py and tests/test_mpc_extra.py on
  the port's `DummyEngine("cpu")` and on the reference's `DUMMY`: every
  ceremony state and every `Parameters` equal element by element (closed
  forms, full ceremony, canned trapdoor, generator cross-check, bad and
  tampered contributions rejected, `generate_parameters_mpc` in both bases,
  the tau-list protocol).
* The mock Groth16 flows of tests/test_groth16_mock.py: CRS and proofs
  equal the reference's.
* BLS12-381 pieces on `Bls12Engine("cpu")`: `_check_eqs` (one bucket-8
  device batch, run on the CPU) gives the host oracle's answers, the
  ceremony checkpoints' bytes equal the reference's and read back, and
  `gt_format` equals the reference's.
The full BLS ceremony runs on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 10): its six batched pairing checks take minutes here.
"""

import dataclasses

import pytest
import torch

from bellman_mpc_tpu.groth16 import DUMMY as REF_DUMMY
from bellman_mpc_tpu.groth16 import create_proof as ref_create_proof
from bellman_mpc_tpu.groth16 import generate_parameters as ref_generate_parameters
from bellman_mpc_tpu.groth16 import mpc as rmpc
from bellman_mpc_tpu.groth16 import mpc_serialize as rser
from bellman_mpc_tpu.utils import gt_bytes as rgt
from bellman_mpc_tpu_torch.curves import pairing_host as ph
from bellman_mpc_tpu_torch.curves.host import G1, G2
from bellman_mpc_tpu_torch.groth16 import (
    DUMMY,
    Bls12Engine,
    DummyEngine,
    create_proof,
    create_random_proof,
    generate_parameters,
    generate_random_parameters,
    prepare_verifying_key,
    verify_proof,
)
from bellman_mpc_tpu_torch.groth16 import mpc
from bellman_mpc_tpu_torch.groth16 import mpc_serialize as tser
from bellman_mpc_tpu_torch.groth16.generator import DETERMINISTIC_TRAPDOOR, synthesize_keypair
from bellman_mpc_tpu_torch.r1cs import AssignmentMissing, Circuit, InvalidProof
from bellman_mpc_tpu_torch.utils import gt_format, gt_parse
from tests import test_groth16_mock as ref_mock

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

ENG = DummyEngine("cpu")
P = ENG.fr_host.p  # 64513
# the trapdoor and blinding of tests/test_groth16_mock.py (tests/mod.rs:302-307)
ALPHA, BETA, GAMMA, DELTA, TAU = 48577, 22580, 53332, 5481, 3673
R_BLIND, S_BLIND = 27134, 17146


# ---------------------------------------- the mock circuits on the port's r1cs
def _bool_val(v):
    if v is None:
        raise AssignmentMissing()
    return 1 if v else 0


class XorDemo(Circuit):
    """tests/test_groth16_mock.py XorDemo (tests/mod.rs:86-163)."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def synthesize(self, cs):
        a = cs.alloc("a", lambda: _bool_val(self.a))
        cs.enforce("a_boolean_constraint", lambda lc: lc + cs.one() - a, lambda lc: lc + a,
                   lambda lc: lc)
        b = cs.alloc("b", lambda: _bool_val(self.b))
        cs.enforce("b_boolean_constraint", lambda lc: lc + cs.one() - b, lambda lc: lc + b,
                   lambda lc: lc)
        c = cs.alloc_input("c", lambda: _bool_val(None if self.a is None else self.a ^ self.b))
        cs.enforce("c_xor_constraint", lambda lc: lc + a + a, lambda lc: lc + b,
                   lambda lc: lc + a + b - c)


class AndDemo(Circuit):
    """tests/test_groth16_mock.py AndDemo (tests/mod.rs:15-84)."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def synthesize(self, cs):
        a = cs.alloc("a", lambda: _bool_val(self.a))
        cs.enforce("a_boolean_constraint", lambda lc: lc + cs.one() - a, lambda lc: lc + a,
                   lambda lc: lc)
        b = cs.alloc("b", lambda: _bool_val(self.b))
        c = cs.alloc_input("c", lambda: _bool_val(None if self.a is None else (self.a and self.b)))
        cs.enforce("c_add_constraint", lambda lc: lc + a, lambda lc: lc + b, lambda lc: lc + c)


class AddDemo(Circuit):
    """tests/test_groth16_mock.py AddDemo (tests/mod.rs:196-220)."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def synthesize(self, cs):
        def need(v):
            if v is None:
                raise AssignmentMissing()
            return v

        a = cs.alloc("a", lambda: need(self.a))
        b = cs.alloc("b", lambda: need(self.b))
        c = cs.alloc_input("c", lambda: (need(self.a) + need(self.b)) % P)
        cs.enforce("c_add", lambda lc: lc + a + b, lambda lc: lc + cs.one(), lambda lc: lc + c)


def _fields(x):
    """A ceremony state, contribution or Parameters as nested plain values."""
    return dataclasses.asdict(x)


def _same(port, ref):
    assert _fields(port) == _fields(ref)


# ------------------------------------------------------------- mock Groth16
MOCK_CASES = [
    ("xor", XorDemo, ref_mock.XorDemo, [(False, False, 0), (True, False, 1), (False, True, 1),
                                        (True, True, 0)]),
    ("and", AndDemo, ref_mock.AndDemo, [(True, False, 0), (True, True, 1)]),
    ("add", AddDemo, ref_mock.AddDemo, [(1, 3, 4), (5, P - 2, 3)]),
]


@pytest.mark.parametrize("name,circ,ref_circ,witnesses", MOCK_CASES, ids=[c[0] for c in MOCK_CASES])
def test_mock_groth16_matches_reference(name, circ, ref_circ, witnesses):
    """generate_parameters, create_proof and verify_proof on the mock engine:
    the CRS and every proof equal the reference's; a wrong input fails."""
    params = generate_parameters(ENG, circ(None, None), 1, 1, ALPHA, BETA, GAMMA, DELTA, TAU)
    ref_params = ref_generate_parameters(REF_DUMMY, ref_circ(None, None), 1, 1, ALPHA, BETA,
                                         GAMMA, DELTA, TAU)
    _same(params, ref_params)
    pvk = prepare_verifying_key(ENG, params.vk)
    for a, b, out in witnesses:
        proof = create_proof(ENG, circ(a, b), params, R_BLIND, S_BLIND)
        _same(proof, ref_create_proof(REF_DUMMY, ref_circ(a, b), ref_params, R_BLIND, S_BLIND))
        verify_proof(ENG, pvk, proof, [out])
        with pytest.raises(InvalidProof):
            verify_proof(ENG, pvk, proof, [(out + 1) % P])


def test_mock_random_parameters_deterministic():
    """generate_random_parameters / create_random_proof on the mock engine
    (the fork's fixed trapdoor and blinding) equal the reference's."""
    from bellman_mpc_tpu.groth16 import create_random_proof as ref_proof
    from bellman_mpc_tpu.groth16 import generate_random_parameters as ref_params

    params = generate_random_parameters(ENG, XorDemo(None, None))
    rp = ref_params(REF_DUMMY, ref_mock.XorDemo(None, None))
    _same(params, rp)
    _same(create_random_proof(ENG, XorDemo(True, False), params),
          ref_proof(REF_DUMMY, ref_mock.XorDemo(True, False), rp))


def test_dummy_engine_defaults_to_the_card():
    """DUMMY is DummyEngine() on the first CUDA card; making it touches no card."""
    assert DUMMY.device == torch.device("cuda", 0)
    assert ENG.device == torch.device("cpu")
    assert (ENG.name, ENG.fr_host.p, ENG.fr.L) == ("dummy", 64513, 2)


# ------------------------------------------------------- dummy ceremony flows
def _common_run(engine, m, players, length=8):
    st = m.initial_common_paramters(engine, length)
    states = [st]
    for secrets in players:
        st = m.verify_common_paramter(engine, st, m.mpc_common_paramters_generator(engine, st, secrets))
        states.append(st)
    return states


def test_common_and_uncommon_closed_form():
    """common_works and uncommonn_works (mpc_test.rs:72-269): every phase-1
    state, the matrix and every phase-2 state equal the reference's; the
    closed forms hold."""
    players = [(1, 2, 3), (2, 3, 4), (3, 4, 5)]
    ours, refs = _common_run(ENG, mpc, players), _common_run(REF_DUMMY, rmpc, players)
    for a, b in zip(ours, refs):
        _same(a, b)
    st = ours[-1]
    assert (st.alpha_g1, st.beta_g1, st.tau_g1[1], st.tau_g1[2]) == (6, 24, 60, 3600 % P)
    tables = ([[(1, 0), (1, 1)], []], [[(1, 0)], [(1, 1)]], [[], []], [], [], [], 4)
    mat = mpc.matrix_storage(st, ENG, *tables)
    _same(mat, rmpc.matrix_storage(refs[-1], REF_DUMMY, *tables))
    assert mat.matrixed_g1_front == [(24 * 61 + 6) % P, 6 * 60 % P]

    pts = dict(matrixed_g1_front=[6, 12], matrixed_g2_front=[6, 12], matrixed_g1_back=[24, 48],
               matrixed_g2_back=[24, 48], matrixed_h_g1=[2, 4, 6, 8], matrixed_h_g2=[2, 4, 6, 8])
    m_ours, m_ref = mpc.CommonParamterMatrix(**pts), rmpc.CommonParamterMatrix(**pts)
    u_ours = mpc.initial_uncommon_paramters(ENG, m_ours)
    u_ref = rmpc.initial_uncommon_paramters(REF_DUMMY, m_ref)
    for secrets in [(1, 2), (2, 3), (3, 4)]:
        c_ours = mpc.mpc_uncommon_paramters_generator(ENG, u_ours, secrets)
        c_ref = rmpc.mpc_uncommon_paramters_generator(REF_DUMMY, u_ref, secrets)
        _same(c_ours, c_ref)
        u_ours = mpc.verify_uncommon_paramter(ENG, m_ours, u_ours, c_ours)
        u_ref = rmpc.verify_uncommon_paramter(REF_DUMMY, m_ref, u_ref, c_ref)
        _same(u_ours, u_ref)
    assert (u_ours.gamma_g2, u_ours.delta_g2) == (6, 24)
    assert u_ours.kin_g1 == [6 * pow(6, -1, P) % P, 12 * pow(6, -1, P) % P]


def test_full_ceremony_and_canned_trapdoor():
    """all_test (mpc_test.rs:9-61) and the canned 3-player ceremonies: the
    final states equal the reference's; the canned secrets total the
    deterministic trapdoor."""
    states = _common_run(ENG, mpc, [(1, 2, 3), (2, 3, 4), (3, 4, 5)])
    tables = ([], [], [], [[(1, 0), (2, 1)], []], [[(1, 0), (2, 1)], [(3, 0), (4, 1)]], [[], []], 4)
    m_ours = mpc.matrix_storage(states[-1], ENG, *tables)
    m_ref = rmpc.matrix_storage(_common_run(REF_DUMMY, rmpc, [(1, 2, 3), (2, 3, 4), (3, 4, 5)])[-1],
                                REF_DUMMY, *tables)
    _same(m_ours, m_ref)
    _same(mpc.mpc_uncommon_paramters_custom_all(ENG, m_ours),
          rmpc.mpc_uncommon_paramters_custom_all(REF_DUMMY, m_ref))

    canned = mpc.mpc_common_paramters_custom_all(ENG, 8)
    _same(canned, rmpc.mpc_common_paramters_custom_all(REF_DUMMY, 8))
    assert (canned.alpha_g1, canned.beta_g1, canned.tau_g1[1], canned.tau_g1[2]) == (6, 24, 2, 4)
    assert canned.alpha_mul_tau_g1[:2] == [6, 12] and canned.beta_mul_tau_g1[:2] == [24, 48]


def test_generator_ceremony_cross_check():
    """generator.rs:573-611's cross-check on AndDemo (4 constraints): the
    ceremony's vk and H query equal generate_parameters', as the
    reference's; every intermediate equals the reference's."""
    params = generate_parameters(ENG, AndDemo(None, None), 1, 1, 6, 24, 6, 24, 2)
    asm = synthesize_keypair(ENG, AndDemo(None, None))
    assert asm.num_constraints == 4
    tables = (asm.at_inputs, asm.bt_inputs, asm.ct_inputs, asm.at_aux, asm.bt_aux, asm.ct_aux, 4)
    cp = mpc.mpc_common_paramters_custom_all(ENG, 8)
    ucp = mpc.mpc_uncommon_paramters_custom_all(ENG, mpc.matrix_storage(cp, ENG, *tables))
    ref_asm = synthesize_keypair(REF_DUMMY, ref_mock.AndDemo(None, None))
    assert (asm.at_inputs, asm.at_aux, asm.bt_aux, asm.ct_aux) == (
        ref_asm.at_inputs, ref_asm.at_aux, ref_asm.bt_aux, ref_asm.ct_aux)
    ref_cp = rmpc.mpc_common_paramters_custom_all(REF_DUMMY, 8)
    _same(ucp, rmpc.mpc_uncommon_paramters_custom_all(
        REF_DUMMY, rmpc.matrix_storage(ref_cp, REF_DUMMY, *tables)))
    vk = params.vk
    assert (vk.alpha_g1, vk.beta_g1, vk.beta_g2) == (cp.alpha_g1, cp.beta_g1, cp.beta_g2)
    assert (vk.gamma_g2, vk.delta_g1, vk.delta_g2) == (ucp.gamma_g2, ucp.delta_g1, ucp.delta_g2)
    assert params.h[:2] == ucp.h_g1[:2]


def test_bad_and_tampered_contributions_rejected():
    """mpc_bad_paramters_custom (mpc.rs:130-154) and a tampered phase-1
    contribution raise CeremonyError, as in the reference; the honest
    follow-up is accepted."""
    lst, ref_lst = mpc.init_parameter_list(ENG), rmpc.init_parameter_list(REF_DUMMY)
    good = mpc.mpc_common_paramters_custom_generator(ENG, lst[-1], 5)
    _same(good, rmpc.mpc_common_paramters_custom_generator(REF_DUMMY, ref_lst[-1], 5))
    lst = mpc.paramter_list_excute(ENG, lst, good)
    ref_lst = rmpc.paramter_list_excute(REF_DUMMY, ref_lst, good)
    bad = mpc.mpc_bad_paramters_custom(ENG, lst[-1], 7)
    _same(bad, rmpc.mpc_bad_paramters_custom(REF_DUMMY, ref_lst[-1], 7))
    assert mpc.verify_mpc_g1(ENG, bad, lst) is rmpc.verify_mpc_g1(REF_DUMMY, bad, ref_lst) is False
    with pytest.raises(mpc.CeremonyError):
        mpc.paramter_list_excute(ENG, lst, bad)
    good2 = mpc.mpc_common_paramters_custom_generator(ENG, lst[-1], 7)
    assert mpc.verify_mpc_g1(ENG, good2, lst)

    st = mpc.initial_common_paramters(ENG, 4)
    for field in ("alpha", "tau"):
        c = mpc.mpc_common_paramters_generator(ENG, st, (3, 4, 5))
        target = c.alpha if field == "alpha" else c.tau.list[2]
        target.g1_result = (target.g1_result + 1) % P
        with pytest.raises(mpc.CeremonyError):
            mpc.verify_common_paramter(ENG, st, c)
        with pytest.raises(rmpc.CeremonyError):
            rmpc.verify_common_paramter(REF_DUMMY, st, c)


@pytest.mark.parametrize("basis", ["power", "lagrange"])
def test_generate_parameters_mpc(basis):
    """Ceremony-only setup (generator.rs:163-237) in both bases equals the
    reference's; the Lagrange CRS equals generate_parameters' under the
    deterministic trapdoor and its proof verifies under the direct key."""
    params = mpc.generate_parameters_mpc(ENG, AndDemo(None, None), basis=basis)
    _same(params, rmpc.generate_parameters_mpc(REF_DUMMY, ref_mock.AndDemo(None, None), basis=basis))
    assert (params.vk.gamma_g2, params.vk.delta_g2, len(params.vk.ic), len(params.l)) == (6, 24, 2, 2)
    if basis == "power":
        assert len(params.h) == 4 and params.a and len(params.b_g1) == len(params.b_g2) > 0
        return
    t = DETERMINISTIC_TRAPDOOR
    direct = generate_parameters(ENG, AndDemo(None, None), 1, 1, t["alpha"], t["beta"], t["gamma"],
                                 t["delta"], t["tau"])
    _same(params, direct)
    proof = create_random_proof(ENG, AndDemo(True, True), params)
    verify_proof(ENG, prepare_verifying_key(ENG, direct.vk), proof, [1])


def test_tau_list_protocol():
    """The x^1-based standalone tau vectors (mpc.rs:230-355): every list
    equals the reference's, inconsistent powers are rejected."""
    n = 4
    lst, ref_lst = mpc.init_tau_parameter_list(ENG, n), rmpc.init_tau_parameter_list(REF_DUMMY, n)
    for x in (3, 5):
        my_x = [pow(x, i + 1, P) for i in range(n)]
        c = mpc.mpc_common_tauparamters_custom_generator(ENG, lst[-1], my_x)
        _same(c, rmpc.mpc_common_tauparamters_custom_generator(REF_DUMMY, ref_lst[-1], my_x))
        assert mpc.verify_x_pow(ENG, c)
        lst = mpc.tau_paramter_list_excute(ENG, lst, c)
        ref_lst = rmpc.tau_paramter_list_excute(REF_DUMMY, ref_lst, c)
    assert [p.g1_result for p in lst[-1].list] == [pow(15, i + 1, P) for i in range(n)]
    bad = mpc.mpc_common_tauparamters_custom_generator(ENG, lst[-1], [2, 4, 8, 17])
    assert not mpc.verify_x_pow(ENG, bad) and not rmpc.verify_x_pow(REF_DUMMY, bad)
    assert mpc.verify_mpc_x(ENG, bad, lst) is False
    with pytest.raises(mpc.CeremonyError):
        mpc.tau_paramter_list_excute(ENG, lst, bad)


# ------------------------------------------------------------ BLS12-381 pieces
BLS = Bls12Engine("cpu")


def test_check_eqs_matches_host_oracle():
    """_check_eqs on a CPU BLS engine runs one bucket-8 pairing_eq_batch on
    the CPU; its answers equal the host oracle's (two equations false, one
    with identities)."""
    g1 = [G1.mul(G1.generator, k) for k in (2, 3, 6, 7, 5)]
    g2 = [G2.mul(G2.generator, k) for k in (3, 2, 5, 4)]
    eqs = [
        (g1[0], g2[0], g1[2], G2.generator),  # e(2G, 3H) == e(6G, H)
        (g1[1], g2[1], g1[2], G2.generator),  # e(3G, 2H) == e(6G, H)
        (g1[3], g2[0], g1[2], G2.generator),  # e(7G, 3H) != e(6G, H)
        (g1[4], g2[3], G1.mul(G1.generator, 20), G2.generator),  # e(5G, 4H) == e(20G, H)
        (g1[4], g2[2], g1[4], g2[3]),  # e(5G, 5H) != e(5G, 4H)
        (None, g2[0], g1[0], None),  # identities: 1 == 1
    ]
    got = mpc._check_eqs(BLS, eqs)
    want = [BLS.pairing_product_is_one([(a1, b1), (G1.neg(a2), b2)]) for a1, b1, a2, b2 in eqs]
    assert want == [True, True, False, True, False, True]
    assert [bool(x) for x in got] == want


def test_checkpoint_bytes_match_reference():
    """The ceremony checkpoints of one (unverified) BLS contribution: the
    port's bytes equal the reference's serializer's on the same storage, and
    read back to the same storage (tests/test_mpc_extra.py's round trip)."""
    st = mpc.initial_common_paramters(BLS, 4)
    st = mpc.mpc_common_paramters_generator(BLS, st, (2, 3, 5)).to_storage_format()
    raw = tser.common_storage_to_bytes(st)
    assert raw == rser.common_storage_to_bytes(st)
    assert tser.common_storage_from_bytes(raw) == st
    mat = mpc.matrix_storage(st, BLS, [[(1, 0)]], [[(1, 1)]], [[]], [], [], [], 2)
    ust = mpc.initial_uncommon_paramters(BLS, mat)
    raw2 = tser.uncommon_storage_to_bytes(ust)
    assert raw2 == rser.uncommon_storage_to_bytes(ust)
    assert tser.uncommon_storage_from_bytes(raw2) == ust
    assert len(raw) == 2 * 96 + 2 * 192 + 3 * (4 + 4 * 96) + 3 * (4 + 4 * 192)


def test_gt_bytes_match_reference():
    """gt_format of one pairing value equals the reference's 576 bytes, and
    gt_parse reads it back."""
    gt = ph.pairing(G1.mul(G1.generator, 3), G2.mul(G2.generator, 5))
    raw = gt_format(gt)
    assert len(raw) == 576 and raw == rgt.gt_format(gt)
    assert gt_parse(raw) == gt == rgt.gt_parse(raw)
