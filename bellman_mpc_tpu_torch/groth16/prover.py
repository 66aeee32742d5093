"""Groth16 prover.

Port of bellman_mpc_tpu/groth16/prover.py (bellman/src/groth16/prover.rs):
  * the fork-pinned deterministic blinding (prover.rs:169-170);
  * witness synthesis with the per-input dummy constraints (prover.rs:198-204);
  * the h(x) pipeline (prover.rs:210-231: 3x (iFFT, coset-FFT), pointwise
    a*b - c, divide by Z on the coset, icoset-FFT) over (L, *batch, m) limb
    tensors, shared with the batched prover, and its form with every NTT
    sharded over a mesh (`_h_pipeline_sharded`);
  * the sequential prover `create_proof` / `create_random_proof`
    (prover.rs:158-350): the h pipeline on one witness, six MSMs on the
    engine's groups, the delta != identity guard, proof assembly.

Every limb multiply of the pipeline (NTT stages, scalings, the coset
pointwise product) goes through LimbField.mul, which on the card is the
limb Montgomery kernel (ops/mont_kernels.mont_mul, the reference's Pallas
K4, which the reference takes for the coset product under BMT_PALLAS=1);
its output limbs equal the plain version's, so there is no switch.
"""

from __future__ import annotations

import functools
from typing import List

from ..fields.host import PrimeField
from ..fields.limb import LimbField
from ..ops.domain import distribute_powers, domain_size_for, ntt, warm_twiddles
from ..r1cs.core import INPUT, Circuit, UnexpectedIdentity, Variable
from .assembly import ProvingAssignment
from .types import Parameters, Proof

DETERMINISTIC_R = 27134
DETERMINISTIC_S = 17146


@functools.lru_cache(maxsize=None)
def _h_pipeline(field: LimbField, host: PrimeField, exp: int):
    """The h(x) pipeline for a 2^exp domain; the returned function maps
    (L, *batch, m) Montgomery tensors a, b, c to h's coefficients."""
    gen = host.generator
    geninv = host.inv(gen)
    m = 1 << exp
    zinv = host.inv((pow(gen, m, host.p) - 1) % host.p)
    warm_twiddles(field, host, exp)

    def coset_values(x):
        x = ntt(field, host, x, inverse=True)  # ifft
        x = distribute_powers(field, host, x, gen)
        return ntt(field, host, x, inverse=False)  # coset_fft

    def pipeline(a, b, c):
        a = coset_values(a)
        b = coset_values(b)
        c = coset_values(c)
        h = field.sub(field.mul(a, b), c)
        h = field.mul_const(h, zinv)  # divide_by_z_on_coset
        h = ntt(field, host, h, inverse=True)  # icoset_fft part 1
        return distribute_powers(field, host, h, geninv)

    return pipeline


def _h_pipeline_sharded(field: LimbField, host: PrimeField, exp: int, mesh):
    """`_h_pipeline` with every NTT distributed over the mesh's "model"
    shards by the 4-step decomposition (parallel/sharded.sharded_ntt);
    BatchProver takes it on a mesh when exp >= BMT_SHARD_NTT_EXP.  The
    pointwise scalings and products between the transforms run on the lead
    device.  The same limbs as `_h_pipeline`."""
    from ..parallel.sharded import sharded_ntt

    gen = host.generator
    geninv = host.inv(gen)
    m = 1 << exp
    zinv = host.inv((pow(gen, m, host.p) - 1) % host.p)
    warm_twiddles(field, host, exp)

    def coset_values(x):
        x = sharded_ntt(mesh, field, host, x, inverse=True)
        x = distribute_powers(field, host, x, gen)
        return sharded_ntt(mesh, field, host, x, inverse=False)

    def pipeline(a, b, c):
        a = coset_values(a)
        b = coset_values(b)
        c = coset_values(c)
        h = field.sub(field.mul(a, b), c)
        h = field.mul_const(h, zinv)
        h = sharded_ntt(mesh, field, host, h, inverse=True)
        return distribute_powers(field, host, h, geninv)

    return pipeline


def synthesize_witness(engine, circuit: Circuit) -> ProvingAssignment:
    prover = ProvingAssignment(engine.fr_host)
    prover.alloc_input("", lambda: 1)  # prover.rs:198
    circuit.synthesize(prover)
    for i in range(len(prover.input_assignment)):  # prover.rs:202-204
        v = Variable(INPUT, i)
        prover.enforce("", lambda lc, v=v: lc + v, lambda lc: lc, lambda lc: lc)
    return prover


def h_coefficients(engine, prover: ProvingAssignment) -> List[int]:
    """Quotient-polynomial coefficients (device pipeline + truncation)."""
    fr_host = engine.fr_host
    m, exp = domain_size_for(len(prover.a), fr_host)
    pad = [0] * (m - len(prover.a))
    a, b, c = (engine.fr.encode(x + pad, device=engine.device) for x in (prover.a, prover.b, prover.c))
    h = _h_pipeline(engine.fr, fr_host, exp)(a, b, c)
    return engine.fr.decode(h)[: m - 1]  # truncate (prover.rs:228-230)


def create_proof(engine, circuit: Circuit, params: Parameters, r: int, s: int) -> Proof:
    fr = engine.fr_host
    G1, G2 = engine.g1, engine.g2

    prover = synthesize_witness(engine, circuit)
    vk = params.get_vk(len(prover.input_assignment))

    h_scalars = h_coefficients(engine, prover)
    h = G1.msm(params.get_h(len(h_scalars)), h_scalars)

    input_assignment = prover.input_assignment
    aux_assignment = prover.aux_assignment

    l = G1.msm(params.get_l(len(aux_assignment)), aux_assignment)

    a_inputs_src, a_aux_src = params.get_a(
        len(input_assignment), prover.a_aux_density.get_total_density()
    )
    a_inputs = G1.msm(a_inputs_src, input_assignment)
    a_aux = G1.msm(a_aux_src, aux_assignment, density=prover.a_aux_density.bv)

    b_input_density = prover.b_input_density.bv
    b_aux_density = prover.b_aux_density.bv
    b_in_total = prover.b_input_density.get_total_density()
    b_aux_total = prover.b_aux_density.get_total_density()

    b_g1_in_src, b_g1_aux_src = params.get_b_g1(b_in_total, b_aux_total)
    b_g1_inputs = G1.msm(b_g1_in_src, input_assignment, density=b_input_density)
    b_g1_aux = G1.msm(b_g1_aux_src, aux_assignment, density=b_aux_density)

    b_g2_in_src, b_g2_aux_src = params.get_b_g2(b_in_total, b_aux_total)
    b_g2_inputs = G2.msm(b_g2_in_src, input_assignment, density=b_input_density)
    b_g2_aux = G2.msm(b_g2_aux_src, aux_assignment, density=b_aux_density)

    # CRS subversion guard (prover.rs:309-313).
    if G1.is_identity(vk.delta_g1) or G2.is_identity(vk.delta_g2):
        raise UnexpectedIdentity("subversion-CRS attack: delta is the identity")

    r = r % fr.p
    s = s % fr.p

    g_a = G1.add(G1.mul(vk.delta_g1, r), vk.alpha_g1)
    g_b = G2.add(G2.mul(vk.delta_g2, s), vk.beta_g2)
    g_c = G1.add(
        G1.mul(vk.delta_g1, r * s % fr.p),
        G1.add(G1.mul(vk.alpha_g1, s), G1.mul(vk.beta_g1, r)),
    )

    a_answer = G1.add(a_inputs, a_aux)
    g_a = G1.add(g_a, a_answer)
    g_c = G1.add(g_c, G1.mul(a_answer, s))

    b1_answer = G1.add(b_g1_inputs, b_g1_aux)
    b2_answer = G2.add(b_g2_inputs, b_g2_aux)
    g_b = G2.add(g_b, b2_answer)
    g_c = G1.add(g_c, G1.mul(b1_answer, r))
    g_c = G1.add(g_c, h)
    g_c = G1.add(g_c, l)

    return Proof(a=g_a, b=g_b, c=g_c)


def create_random_proof(engine, circuit: Circuit, params: Parameters, rng=None) -> Proof:
    """Deterministic-blinding proof (prover.rs:158-173 ignores the RNG)."""
    return create_proof(engine, circuit, params, DETERMINISTIC_R, DETERMINISTIC_S)
