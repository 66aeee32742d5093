"""The port's device pairing (ops/pairing.py), its BatchVerifier and the
engine's pairing routes, against the JAX reference and the host oracle.

* The Miller steps (`_dbl_step`, `_add_step`) and a short-schedule Miller
  loop (`_RUNS` = [(1, True), (1, False)] in both modules, one masked lane)
  have raw limbs equal to the reference's, run eagerly (tolerance 0).
* The full-length pairing is held against the exact host oracle
  (curves/pairing_host.py), since the reference's full pairing program takes
  minutes to compile on the CPU: `pairing_batch` values equal
  `pairing_host.pairing`, `final_exp_eq_batch` equals the exact value cubed,
  `pairing_product_is_one` and `pairing_eq_batch` give the answers of the
  reference's tests.
* `BatchVerifier` accepts three proofs and rejects a wrong input on a CPU
  engine (the host loop, as the reference's CPU backend), and its terms also
  pass the device program on the CPU.

A full device pairing costs several seconds on this CPU: the file runs six
(one with the exact final exponentiation) and one batched Miller loop.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.ops import pairing as rp
from bellman_mpc_tpu_torch import groth16 as tg
from bellman_mpc_tpu_torch import interop
from bellman_mpc_tpu_torch.curves import pairing_host as ph
from bellman_mpc_tpu_torch.curves.host import G1, G2
from bellman_mpc_tpu_torch.fields.bls12_381 import R
from bellman_mpc_tpu_torch.fields.tower import FP12_ONE, fp12_mul, fp12_pow
from bellman_mpc_tpu_torch.ops import pairing as tp
from bellman_mpc_tpu_torch.ops import tower as tt
from bellman_mpc_tpu_torch.r1cs import AssignmentMissing, Circuit, InvalidProof

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers


def _same(r, t):
    rl = jax.tree_util.tree_leaves(r)
    tl = jax.tree_util.tree_leaves(interop.tree_to(t))
    return len(rl) == len(tl) and all(np.array_equal(np.asarray(a), b) for a, b in zip(rl, tl))


def _pairs(n, seed):
    """n (G1, G2) pairs of seeded multiples of the generators."""
    rng = np.random.default_rng(seed)
    s = [int(x) for x in rng.integers(1, 1 << 62, size=2 * n)]
    return [G1.mul(G1.generator, a) for a in s[:n]], [G2.mul(G2.generator, b) for b in s[n:]]


@pytest.fixture(scope="module")
def enc():
    """Four pairs, lane 2's G1 point the identity (a masked lane), encoded
    by the reference and carried into the port."""
    g1s, g2s = _pairs(4, 3)
    g1s[2] = None
    px, py, v1 = rp._encode_g1(g1s)
    qx, qy, v2 = rp._encode_g2(g2s)
    ref = (px, py, qx, qy, jnp.asarray(v1 & v2))
    port = interop.tree_from(ref[:4]) + (torch.as_tensor(v1 & v2),)
    return g1s, g2s, ref, port


def test_encode_matches_reference(enc):
    g1s, g2s, ref, port = enc
    assert _same(ref, tp.encode_pairs(g1s, g2s, 4, "cpu"))


@pytest.mark.parametrize("step", ["dbl", "add"])
def test_miller_step_matches_reference(enc, step):
    _, _, (px, py, qx, qy, _), (tpx, tpy, tqx, tqy, _) = enc

    def run(mod, fp, px, py, qx, qy):
        T = (mod._stacked(qx), mod._stacked(qy), mod._stacked((fp.add(qx[0], qx[1]), qy[1])))
        if step == "dbl":
            return mod._dbl_step(T, fp.neg(px), fp.add(py, py))
        return mod._add_step(T, T, qx, qy, fp.neg(px), py)

    from bellman_mpc_tpu.fields.bls12_381 import fp as rfp
    from bellman_mpc_tpu_torch.fields.bls12_381 import fp as tfp

    want = run(rp, rfp, px, py, qx, qy)
    got = run(tp, tfp, tpx, tpy, tqx, tqy)
    assert _same(want, got)


def test_short_miller_loop_matches_reference(enc, monkeypatch):
    """The loop's control flow on a two-bit schedule: a doubling, an add, a
    doubling, the conjugation and the masked lane."""
    _, _, ref, port = enc
    runs = [(1, True), (1, False)]
    monkeypatch.setattr(rp, "_RUNS", runs)
    monkeypatch.setattr(tp, "_RUNS", runs)
    want = rp.miller_loop_batch(*ref)
    got = tp.miller_loop_batch(*port)
    assert _same(want, got)
    assert tt.fp12_is_one(got).tolist() == [False, False, True, False]


def test_pairing_batch_matches_host_oracle():
    g1s, g2s = _pairs(3, 5)
    g1s[1] = None  # e(O, Q) = 1
    got = tp.pairing_batch(g1s, g2s, device="cpu")
    assert got == [ph.pairing(p, q) for p, q in zip(g1s, g2s)]


def test_final_exp_eq_is_the_exact_value_cubed():
    """The x-chain equals the host's exact final exponentiation of the
    port's own Miller output, cubed."""
    g1s, g2s = _pairs(2, 6)
    ml = tp.miller_loop_batch(*tp.encode_pairs(g1s, g2s, 8, "cpu"))
    chain = tt.fp12_decode(tp.final_exp_eq_batch(ml))
    for m, c in zip(tt.fp12_decode(ml)[:2], chain):
        assert c == fp12_pow(ph.final_exponentiation(m), 3)


@pytest.mark.parametrize("k, want", [(117, True), (116, False)])
def test_pairing_product_is_one(k, want):
    """e(9 G1, 13 G2) e(-k G1, G2) == 1 exactly when k = 117."""
    a = G1.mul(G1.generator, 9)
    b = G2.mul(G2.generator, 13)
    got = tp.pairing_product_is_one([a, G1.neg(G1.mul(G1.generator, k))], [b, G2.generator],
                                    device="cpu")
    assert got is want


def test_pairing_eq_batch():
    a = G1.mul(G1.generator, 7)
    b = G2.mul(G2.generator, 11)
    # e(7G1, 11G2) == e(77G1, G2); e(7G1, 11G2) != e(5G1, G2); identities
    eqs = tp.pairing_eq_batch(
        [a, a, None],
        [b, b, b],
        [G1.mul(G1.generator, 77), G1.mul(G1.generator, 5), None],
        [G2.generator, G2.generator, b],
        device="cpu",
    )
    assert eqs.tolist() == [True, False, True]


class MySillyCircuit(Circuit):
    """c = a * b with c public (bellman's groth16 test circuit)."""

    def __init__(self, a=None, b=None):
        self.a, self.b = a, b

    def synthesize(self, cs):
        def need(v):
            if v is None:
                raise AssignmentMissing()
            return v

        a = cs.alloc("a", lambda: need(self.a))
        b = cs.alloc("b", lambda: need(self.b))
        c = cs.alloc_input("c", lambda: need(self.a) * need(self.b) % R)
        cs.enforce("a*b=c", lambda lc: lc + a, lambda lc: lc + b, lambda lc: lc + c)


class _RecordingEngine(tg.Bls12Engine):
    """A CPU engine that keeps the terms of every pairing-product check."""

    def __init__(self):
        super().__init__("cpu")
        self.terms = []

    def pairing_product_is_one(self, terms) -> bool:
        self.terms.append(list(terms))
        return super().pairing_product_is_one(terms)


def test_batch_verifier(monkeypatch):
    eng = _RecordingEngine()
    params = tg.generate_random_parameters(eng, MySillyCircuit())
    rng = random.Random(31)
    items = []
    for _ in range(3):
        a, b = rng.randrange(R), rng.randrange(R)
        items.append((tg.create_random_proof(eng, MySillyCircuit(a, b), params), [a * b % R]))

    def no_device(*args, **kwargs):
        raise AssertionError("a CPU engine must take the host loop")

    with monkeypatch.context() as m:  # the CPU engine's route is the host loop
        m.setattr(tp, "pairing_product_is_one", no_device)
        bv = tg.BatchVerifier()
        for it in items:
            bv.queue(it)
        bv.verify(eng, params.vk, random.Random(32))
        bad = tg.BatchVerifier()
        for proof, inputs in items[:2]:
            bad.queue(tg.Item(proof, inputs))
        bad.queue((items[2][0], [123456]))
        with pytest.raises(InvalidProof):
            bad.verify(eng, params.vk, random.Random(33))
    good = eng.terms[0]
    assert len(good) == 3 + 3
    assert tp.pairing_product_is_one([t[0] for t in good], [t[1] for t in good], device="cpu")


def test_engine_routes():
    """A multi-Miller loop of 4 terms is one device batch whose values the
    host multiplies: after the final exponentiation, equal to the host
    loop's product (the device's line scaling differs from the host's by
    factors the exponentiation kills).  A CUDA engine on a machine without
    a card raises instead of pairing on the host."""
    g1s, g2s = _pairs(4, 9)
    terms = list(zip(g1s, g2s)) + [(None, G2.generator)]
    want = FP12_ONE
    for p, q in terms[:4]:
        want = fp12_mul(want, ph.miller_loop(p, q))
    eng = tg.Bls12Engine("cpu")
    got = eng.multi_miller_loop(terms)
    assert eng.final_exponentiation(got) == ph.final_exponentiation(want)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CUDA engine would pair on it")
    with pytest.raises((RuntimeError, AssertionError)):
        tg.Bls12Engine("cuda:0").pairing_product_is_one(terms)
