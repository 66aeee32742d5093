"""Groth16 trusted setup (CRS generation).

Copy of bellman_mpc_tpu/groth16/generator.py on the port's engine: the
fixed-base batches run as device ladders and the Lagrange coefficients come
from the port's NTT.  That module ports bellman/src/groth16/generator.rs:
  * `generate_random_parameters` (:21-40) — NOTE the fork deliberately
    ignores the RNG and uses the fixed trapdoor alpha=6, beta=24, gamma=6,
    delta=24, tau=2; we preserve that deterministic behavior (callers can opt
    into real randomness via `generate_parameters` with sampled values).
  * `generate_parameters` (:241-634): synthesize into KeypairAssembly,
    per-input dummy constraints x*0=0 for IC density (:279-281), powers of
    tau (:352-366, here a device NTT-domain array), H query
    g1^{tau^i t(tau)/delta} (:372-397, here one batched fixed-base kernel),
    iFFT -> Lagrange coefficients (:400-402, device NTT), per-variable QAP
    evaluation into A/B/IC/L queries (:418-572), unconstrained-variable check
    (:586-590), identity filtering of A/B queries (:616-632).

Deviation (documented): the reference hard-wires a 3-player MPC ceremony
cross-check inside generate_parameters (:298-308, :573-611) whose tau-power
table is only long enough for circuits with <= 4 constraints — for anything
larger it panics (its own test_xordemo trips this).  Here the ceremony
cross-check is a standalone, size-safe path: see mpc.py and
tests/test_mpc.py, which assert CRS equality against the ceremony output
exactly as generator.rs:573-611 intends.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..ops.domain import EvaluationDomain, domain_size_for
from ..r1cs.core import Circuit, UnconstrainedVariable, UnexpectedIdentity
from .assembly import KeypairAssembly
from .types import Parameters, VerifyingKey

# Fork-pinned deterministic trapdoor (generator.rs:34-38).
DETERMINISTIC_TRAPDOOR = dict(alpha=6, beta=24, gamma=6, delta=24, tau=2)


def synthesize_keypair(engine, circuit: Circuit) -> KeypairAssembly:
    """Synthesize with the implicit ONE input and per-input dummy constraints."""
    assembly = KeypairAssembly(engine.fr_host)
    assembly.alloc_input("", lambda: 1)  # generator.rs:269
    circuit.synthesize(assembly)
    for i in range(assembly.num_inputs):  # generator.rs:279-281
        from ..r1cs.core import INPUT, Variable

        v = Variable(INPUT, i)
        assembly.enforce("", lambda lc, v=v: lc + v, lambda lc: lc, lambda lc: lc)
    return assembly


def lagrange_coeffs_at_tau(engine, m: int, tau: int) -> List[int]:
    """L_i(tau) for the size-m radix-2 domain, via an iFFT of [tau^i] on
    the engine's device.

    Mirrors generator.rs:352-366 (powers of tau) + :400-402 (ifft).
    """
    p = engine.fr_host.p
    powers = [1] * m
    for i in range(1, m):
        powers[i] = powers[i - 1] * tau % p
    d = EvaluationDomain.from_coeffs(engine.fr, engine.fr_host, powers, engine.device)
    d.ifft()
    return d.into_coeffs()


def _eval_at_tau(col: List[Tuple[int, int]], lag: List[int], p: int) -> int:
    """Evaluate one sparse QAP column at tau (generator.rs:485-499)."""
    acc = 0
    for coeff, idx in col:
        acc += coeff * lag[idx]
    return acc % p


def generate_parameters(
    engine,
    circuit: Circuit,
    g1,
    g2,
    alpha: int,
    beta: int,
    gamma: int,
    delta: int,
    tau: int,
) -> Parameters:
    fr = engine.fr_host
    p = fr.p
    G1, G2 = engine.g1, engine.g2

    assembly = synthesize_keypair(engine, circuit)

    m, _exp = domain_size_for(assembly.num_constraints, fr)

    if gamma % p == 0 or delta % p == 0:
        raise UnexpectedIdentity("gamma/delta must be invertible")
    gamma_inverse = fr.inv(gamma)
    delta_inverse = fr.inv(delta)

    # Powers of tau and t(tau)/delta for the H query (generator.rs:349-398).
    powers = [1] * m
    for i in range(1, m):
        powers[i] = powers[i - 1] * tau % p
    t_at_tau = (pow(tau, m, p) - 1) % p
    coeff = t_at_tau * delta_inverse % p
    h = G1.batch_mul(g1, [powers[i] * coeff % p for i in range(m - 1)])

    # Lagrange coefficients via device iFFT (generator.rs:400-402).
    lag = lagrange_coeffs_at_tau(engine, m, tau)

    def eval_queries(at, bt, ct, inv: int):
        """Per-variable QAP evaluation (generator.rs:418-536)."""
        n = len(at)
        at_v = [_eval_at_tau(at[i], lag, p) for i in range(n)]
        bt_v = [_eval_at_tau(bt[i], lag, p) for i in range(n)]
        ct_v = [_eval_at_tau(ct[i], lag, p) for i in range(n)]
        a_pts = G1.batch_mul(g1, at_v)
        b_g1_pts = G1.batch_mul(g1, bt_v)
        b_g2_pts = G2.batch_mul(g2, bt_v)
        ext_exps = [
            (beta * at_v[i] + alpha * bt_v[i] + ct_v[i]) * inv % p for i in range(n)
        ]
        ext_pts = G1.batch_mul(g1, ext_exps)
        # zero-evaluation => identity (reference leaves those as identity and
        # filters below, generator.rs:507-515)
        a_pts = [pt if at_v[i] != 0 else G1.identity() for i, pt in enumerate(a_pts)]
        b_g1_pts = [pt if bt_v[i] != 0 else G1.identity() for i, pt in enumerate(b_g1_pts)]
        b_g2_pts = [pt if bt_v[i] != 0 else G2.identity() for i, pt in enumerate(b_g2_pts)]
        return a_pts, b_g1_pts, b_g2_pts, ext_pts

    a_in, b1_in, b2_in, ic = eval_queries(
        assembly.at_inputs, assembly.bt_inputs, assembly.ct_inputs, gamma_inverse
    )
    a_aux, b1_aux, b2_aux, l = eval_queries(
        assembly.at_aux, assembly.bt_aux, assembly.ct_aux, delta_inverse
    )

    # Unconstrained aux variables make L contain identities (generator.rs:586-590).
    for e in l:
        if G1.is_identity(e):
            raise UnconstrainedVariable()

    vk = VerifyingKey(
        alpha_g1=G1.mul(g1, alpha),
        beta_g1=G1.mul(g1, beta),
        beta_g2=G2.mul(g2, beta),
        gamma_g2=G2.mul(g2, gamma),
        delta_g1=G1.mul(g1, delta),
        delta_g2=G2.mul(g2, delta),
        ic=ic,
    )

    a = a_in + a_aux
    b_g1 = b1_in + b1_aux
    b_g2 = b2_in + b2_aux
    return Parameters(
        vk=vk,
        h=h,
        l=l,
        a=[e for e in a if not G1.is_identity(e)],
        b_g1=[e for e in b_g1 if not G1.is_identity(e)],
        b_g2=[e for e in b_g2 if not G2.is_identity(e)],
    )


def generate_random_parameters(engine, circuit: Circuit, rng=None) -> Parameters:
    """Deterministic-trapdoor setup (generator.rs:21-40 ignores the RNG)."""
    t = DETERMINISTIC_TRAPDOOR
    return generate_parameters(
        engine,
        circuit,
        engine.g1.generator(),
        engine.g2.generator(),
        t["alpha"],
        t["beta"],
        t["gamma"],
        t["delta"],
        t["tau"],
    )
