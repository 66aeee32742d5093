"""The port's Sapling pieces on the CPU, held against the benchmark's plain
reference (bench_port/reference/jubjub.py, written independently from the
protocol specification):

* the generators and the Jubjub and Pedersen-hash gadgets (add, double,
  variable- and fixed-base multiplication, Montgomery <-> Edwards, the hash
  under both personalizations) on seeded inputs;
* the Spend circuit on TestConstraintSystem: satisfied, 98,777 constraints,
  8 inputs, the structural hash that librustzcash's Spend test pins, its
  inputs the reference's public inputs; a tampered path
  sibling and a small-order g_d each leave it unsatisfied;
* a Groth16 round trip through BatchProver (rns) at B = 2 on a small
  Jubjub circuit, with tables held in passes and built in slices, each
  proof checked by the reference's verifier (the CRS's points are made by
  the reference's plain scalar multiplication, the port's host ladder
  being slow on the CPU);
* the profiling registry.
"""

import importlib
import importlib.util
import random
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "bench_port"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import bls12_381 as rb  # noqa: E402
from reference import groth16 as rg  # noqa: E402
from reference import jubjub as rj  # noqa: E402
from reference.circuits import boolean as r_boolean  # noqa: E402
from reference.circuits import core as r_core  # noqa: E402
from reference.circuits import pedersen_hash as r_ph  # noqa: E402

from bellman_mpc_tpu_torch.curves import jubjub  # noqa: E402
from bellman_mpc_tpu_torch.fields.bls12_381 import fr_host  # noqa: E402
from bellman_mpc_tpu_torch.gadgets import AllocatedBit, Boolean  # noqa: E402
from bellman_mpc_tpu_torch.models import sapling  # noqa: E402
from bellman_mpc_tpu_torch.r1cs import TestConstraintSystem  # noqa: E402
from bellman_mpc_tpu_torch.r1cs.core import Circuit, DivisionByZero  # noqa: E402
from bellman_mpc_tpu_torch.utils import profiling  # noqa: E402

ecc = importlib.import_module("bellman_mpc_tpu_torch.gadgets.ecc")
ph = importlib.import_module("bellman_mpc_tpu_torch.gadgets.pedersen_hash")

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

P = fr_host.p


def _bits(cs, name, values):
    return [Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"{name} {i}"), b)) for i, b in enumerate(values)]


def _point(cs, name, p):
    return ecc.EdwardsPoint.witness(cs.namespace(name), p)


def _value(pt):
    return pt.get_u().get_value(), pt.get_v().get_value()


def test_generators_and_gadgets_against_reference():
    rng = random.Random(17)
    gens = jubjub.generators()
    assert gens == rj.generators() and jubjub.pedersen_generators() == rj.pedersen_generators()
    for g in list(gens.values()) + list(jubjub.pedersen_generators()):
        assert rj.on_curve(g) and rj.mul(g, rj.R_J) == (0, 1) and g != (0, 1)
    assert jubjub.to_bytes(gens["spending_key"]) == rj.encode(rj.generators()["spending_key"])

    cs = TestConstraintSystem(fr_host)
    a = rj.mul(rj.generators()["spending_key"], rng.randrange(rj.R_J))
    b = rj.mul(rj.generators()["nullifier_position"], rng.randrange(rj.R_J))
    pa, pb = _point(cs, "a", a), _point(cs, "b", b)
    assert _value(pa.add(cs.namespace("a + b"), pb)) == rj.add(a, b)
    assert _value(pa.double(cs.namespace("2a"))) == rj.add(a, a)
    k = rng.getrandbits(24)
    k_bits = _bits(cs, "k", [bool((k >> i) & 1) for i in range(24)])
    assert _value(pa.mul(cs.namespace("k a"), k_bits)) == rj.mul(a, k)
    s = rng.randrange(rj.R_J)
    s_bits = _bits(cs, "s", [bool((s >> i) & 1) for i in range(252)])
    fixed = ecc.fixed_base_multiplication(cs.namespace("s G"), jubjub.fixed_base_table("spending_key"), s_bits)
    assert _value(fixed) == rj.mul(rj.generators()["spending_key"], s)
    assert jubjub.to_montgomery(a) == rj._montgomery(a)
    x, y = rj._montgomery(b)
    mont = ecc.MontgomeryPoint.interpret_unchecked(
        *(ecc.Num.from_allocated(ecc.AllocatedNum.alloc(cs.namespace(n), lambda v=v: v), fr_host)
          for n, v in (("x", x), ("y", y))))
    assert _value(mont.into_edwards(cs.namespace("into edwards"))) == b
    for name, pers, n_bits in (("note", ph.Personalization.note_commitment(), 582),
                               ("merkle 5", ph.Personalization.merkle_tree(5), 510)):
        msg = [bool(rng.getrandbits(1)) for _ in range(n_bits)]
        h = ph.pedersen_hash(cs.namespace(name), pers, _bits(cs, f"{name} bit", msg))
        assert _value(h) == rj.pedersen_hash_point(pers.bits, msg) == jubjub.pedersen_hash_point(pers.bits, msg)
    assert cs.is_satisfied()


def _spend_secrets(seed):
    cfg = {"merkle_depth": sapling.TREE_DEPTH}
    spec = importlib.util.spec_from_file_location("sapling_spend_ref", BENCH / "configs" / "sapling-spend_ref.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    w = mod.draw_witnesses(cfg, random.Random(seed), 1)[0]
    return w, mod.public_inputs(cfg, w)


def _spend(w, g_d=None):
    return sapling.spend_from_secrets(w["value"], w["rcv"], w["ask"], w["nsk"], w["ar"], w["rcm"],
                                      g_d or sapling.diversified_base(w["diversifier"]),
                                      list(zip(w["siblings"], w["positions"])))


# The structural hash that librustzcash's Spend test pins
# (zcash_proofs/src/circuit/sapling.rs, test_input_circuit_with_bls12_381):
# the constraints in order with every coefficient, so the generators, the
# Montgomery scale and the window tables too.
UPSTREAM_SPEND_HASH = "d37c738e83df5d9b0bb6495ac96abf21bcb2697477e2c15c2c7916ff7a3b6a89"


def test_spend_circuit_counts_and_public_inputs():
    w, public = _spend_secrets(2024)
    cs = TestConstraintSystem(fr_host)
    _spend(w).synthesize(cs)
    assert cs.num_constraints() == 98777 and cs.num_inputs() == 8
    assert cs.hash() == UPSTREAM_SPEND_HASH
    assert [v for v, _ in cs.inputs] == [1] + public
    assert cs.is_satisfied()


class ProverWritingAnyValue(TestConstraintSystem):
    """A prover that writes 1 where the honest witness has no value (an
    inverse of zero), to show the constraints themselves refuse it."""

    __test__ = False

    def alloc(self, annotation, f):
        def value():
            try:
                return f()
            except DivisionByZero:
                return 1

        return super().alloc(annotation, value)


def test_spend_rejects_tampered_witnesses():
    """A g_d of small order and, with the anchor of that note's honest path,
    one path sibling changed: exactly the order check and the root check
    fail, even for a prover that writes any value where the honest witness
    has none."""
    w, _ = _spend_secrets(31)
    small = (0, P - 1)  # of order 2: on the curve, so only the order check refuses it
    assert rj.on_curve(small) and rj.mul(small, 2) == (0, 1)
    with pytest.raises(DivisionByZero):
        _spend(w, g_d=small).synthesize(TestConstraintSystem(fr_host))
    spend = _spend(w, g_d=small)
    spend.auth_path[7] = ((spend.auth_path[7][0] + 1) % P, spend.auth_path[7][1])
    cs = ProverWritingAnyValue(fr_host)
    spend.synthesize(cs)
    failing = [path for a, b, c, path in cs.constraints
               if cs._eval_lc(a) * cs._eval_lc(b) % P != cs._eval_lc(c)]
    assert w["value"] != 0 and failing == ["g_d not small order/check u != 0/nonzero assertion constraint",
                                           "conditionally enforce correct root"]


MSG_BITS, K_BITS = 6, 3


def small_jubjub(g, cs, msg, k):
    """One Pedersen hash of 6 message bits under MerkleTree(3), times a
    3-bit k, made public: built with the gadget modules `g` (the port's, or
    the reference's frozen copies); msg and k None give the shape."""
    Bool, Bit = g["boolean"].Boolean, g["boolean"].AllocatedBit
    msg_bits = [Bool.from_bit(Bit.alloc(cs.namespace(f"m {i}"), None if msg is None else msg[i]))
                for i in range(MSG_BITS)]
    k_bits = [Bool.from_bit(Bit.alloc(cs.namespace(f"k {i}"), None if k is None else bool((k >> i) & 1)))
              for i in range(K_BITS)]
    h = g["pedersen_hash"].pedersen_hash(cs.namespace("hash"), g["pedersen_hash"].Personalization.merkle_tree(3),
                                         msg_bits)
    h.mul(cs.namespace("k h"), k_bits).inputize(cs.namespace("k h input"))


class SmallJubjub(Circuit):
    def __init__(self, msg=None, k=None):
        self.msg, self.k = msg, k

    def synthesize(self, cs):
        boolean = importlib.import_module("bellman_mpc_tpu_torch.gadgets.boolean")
        small_jubjub({"boolean": boolean, "pedersen_hash": ph}, cs, self.msg, self.k)


class FrozenSmallJubjub(r_core.Circuit):
    def synthesize(self, cs):
        small_jubjub({"boolean": r_boolean, "pedersen_hash": r_ph}, cs, None, None)


def test_batch_prover_round_trip_in_passes(monkeypatch):
    from bellman_mpc_tpu_torch.groth16 import Bls12Engine, generate_parameters, proof_to_bytes
    from bellman_mpc_tpu_torch.parallel import BatchProver, batch_prover

    rng = random.Random(5)
    toxic = rg.draw_toxic_waste(rng)
    eng = Bls12Engine("cpu")
    for group, ref_group in ((eng.g1, rb.G1), (eng.g2, rb.G2)):  # the CRS's points by plain multiplication
        monkeypatch.setattr(group, "batch_mul", lambda base, exps, g=ref_group: [g.mul(base, e % rb.R) for e in exps])
    params = generate_parameters(eng, SmallJubjub(), eng.g1.generator(), eng.g2.generator(), toxic["alpha"],
                                 toxic["beta"], toxic["gamma"], toxic["delta"], toxic["tau"])
    witnesses = [([bool(rng.getrandbits(1)) for _ in range(MSG_BITS)], rng.getrandbits(K_BITS)) for _ in range(2)]
    circuits = [SmallJubjub(m, k) for m, k in witnesses]
    monkeypatch.setattr(batch_prover, "table_budget", lambda device: 25 << 20)  # 22 of 65 windows, 3 passes
    monkeypatch.setattr(batch_prover, "TABLE_CHUNK_BYTES", 4 << 20)  # the G2 table built in two slices
    bp = BatchProver(eng, params, circuits[0], msm_strategy="rns")
    assert bp.table_passes == 3 and bp.m == 64
    profiling.reset()
    raws = [proof_to_bytes(p) for p in bp.prove_batch(circuits)]
    joins = profiling.read()  # each MSM's join: 2 passes of 22 windows of 4 bits doubled in
    assert joins["counters"]["msm.join_doublings"] == 176 * len(joins["spans"]["msm.join"]) > 0
    inputs = [list(rj.mul(rj.pedersen_hash_point(rj.merkle_personalization(3), m), k)) for m, k in witnesses]
    k_vk = rg.input_scalars(FrozenSmallJubjub(), toxic)
    assert rg.verify(list(zip(raws, inputs)), toxic, k_vk, random.Random(6)) == [True, True]
    assert rg.verify([(raws[0], inputs[1])], toxic, k_vk, random.Random(7)) == [False]


def test_profiling_registry(monkeypatch):
    profiling.reset()
    with profiling.span("host"):
        pass
    with profiling.span("host", units=4):
        pass
    profiling.count("calls")
    profiling.count("calls", 2)
    read = profiling.read()
    assert [n for _, n in read["spans"]["host"]] == [1, 4] and read["counters"] == {"calls": 3}

    resolved = []

    class Event:  # stands in for torch.cuda.Event: records nothing, resolves only when read
        def __init__(self, enable_timing):
            self.t = None

        def record(self):
            self.t = len(resolved)

        def synchronize(self):
            resolved.append("sync")

        def elapsed_time(self, end):
            resolved.append("read")
            return 2.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    for _ in range(3):
        with profiling.device_span("dev", torch.device("cuda"), units=2):
            pass
    assert resolved == []  # recording a device span neither waits nor reads
    assert profiling.read()["spans"]["dev"] == [(0.0025, 2)] * 3 and resolved.count("read") == 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.device_span("dev", torch.device("cuda"), units=5):
            pass
    assert profiling.read(traced=True)["spans"] == {"host": [], "dev": [(0.0025, 5)]}
    profiling.reset()
    assert profiling.read() == {"spans": {}, "counters": {}}
