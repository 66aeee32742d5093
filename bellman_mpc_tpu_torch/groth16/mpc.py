"""MPC trusted-setup ceremony for Groth16 (the fork's reason to exist).

Copy of bellman_mpc_tpu/groth16/mpc.py on the port's engines.  That module
ports bellman/src/groth16/mpc.rs (1,131 LoC), engine-generic and with every
pairing product of a contribution check routed through one batched
pairing-equation check (`_check_eqs`: ops/pairing.pairing_eq_batch on the
BLS12-381 engine's device) - bellman performs O(CRS-size) sequential host
pairings per contribution (mpc.rs:806-862, 1065-1131).  The running points
are scaled with the host `mul`, the players' `*_mine` companions with the
engine's `batch_mul` (device ladders at 4 or more points), and the Lagrange
transform is the engine's group `intt`, as in the reference.

Protocol structure (mirroring the reference):

  Phase 1 ("common" parameters, mpc.rs:362-888): players sequentially
  multiply alpha/beta/tau-power vectors by their secrets; each contribution
  carries `*_mine = secret * generator` companions, and verification checks
      e(g1_result, G2) == e(g1_base, g2_mine)      (correct chaining)
      e(g1_result, G2) == e(G1, g2_result)         (G1/G2 consistency)
  (mpc.rs:787-804) plus tau-power geometric consistency
      e(tau^{i-1} g1, tau g2) == e(tau^i g1, g2)   (mpc.rs:316-335).

  QAP projection ("matrix", mpc.rs:416-645): sparse QAP tables project the
  tau-power vectors into per-variable points beta*u_i + alpha*v_i + w_i and
  H-basis points tau^{n+i} - tau^i.  NOTE the ceremony evaluates QAP columns
  in the POWER basis (column entry (coeff, constraint) -> coeff * tau^constraint),
  not the Lagrange basis used by the direct generator — faithful to
  mpc.rs:442-445.  The reference ships two index-divergent variants
  (`matrix` mpc.rs:557-645 and `matrix_test` mpc.rs:466-554); this module
  implements the mathematically coherent form: kin (IC analog) from the
  INPUT tables, kout (L analog) from the AUX tables — which is what
  `initial_uncommon_paramters`/`generate_parameters_mpc` consume.

  Phase 2 ("uncommon", mpc.rs:891-1131): players apply gamma/delta forward
  to the trapdoor points and gamma^{-1}/delta^{-1} to kin / kout+h,
  verified cumulatively against the original matrix:
      e(kin_i, gamma_g2_result) == e(matrix_front_i, G2)   etc.

  Canned ceremonies: 3 players with secrets (1,2,1),(2,3,1),(3,4,2) for the
  common phase (mpc.rs:864-888 — totals alpha=6, beta=24, tau=2, matching
  the deterministic trapdoor) and (1,2),(2,3),(3,4) for the uncommon phase
  (mpc.rs:959-991 — totals gamma=6, delta=24).

  Adversarial contribution `mpc_bad_paramters_custom` (mpc.rs:130-154): a
  malicious player that discards the previous result; verification must
  reject it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..ops.domain import domain_size_for
from ..ops.pairing import pairing_eq_batch
from ..r1cs.core import Circuit
from .engine import Engine
from .generator import synthesize_keypair
from .types import Parameters, VerifyingKey


# ------------------------------------------------------------ data structures
@dataclass
class ParameterPair:
    """One contribution for a single trapdoor element (mpc.rs:18-43)."""

    g1_result: Optional[object] = None
    g2_result: Optional[object] = None
    g1_mine: Optional[object] = None
    g2_mine: Optional[object] = None


@dataclass
class TauParameterPair:
    """Per-power contribution vector (mpc.rs:182-228)."""

    list: List[ParameterPair] = field(default_factory=list)

    def get_g1(self):
        return [p.g1_result for p in self.list]

    def get_g2(self):
        return [p.g2_result for p in self.list]


@dataclass
class CommonParamter:
    """A full phase-1 contribution (mpc.rs:362-395)."""

    alpha: ParameterPair
    beta: ParameterPair
    tau: TauParameterPair
    alpha_mul_tau: TauParameterPair
    beta_mul_tau: TauParameterPair

    def to_storage_format(self) -> "CommonParamterInStorage":
        return CommonParamterInStorage(
            alpha_g1=self.alpha.g1_result,
            alpha_g2=self.alpha.g2_result,
            beta_g1=self.beta.g1_result,
            beta_g2=self.beta.g2_result,
            tau_g1=self.tau.get_g1(),
            tau_g2=self.tau.get_g2(),
            alpha_mul_tau_g1=self.alpha_mul_tau.get_g1(),
            alpha_mul_tau_g2=self.alpha_mul_tau.get_g2(),
            beta_mul_tau_g1=self.beta_mul_tau.get_g1(),
            beta_mul_tau_g2=self.beta_mul_tau.get_g2(),
        )


@dataclass
class CommonParamterInStorage:
    """Resumable on-chain phase-1 state (mpc.rs:397-414)."""

    alpha_g1: object
    alpha_g2: object
    beta_g1: object
    beta_g2: object
    tau_g1: List[object]
    tau_g2: List[object]
    alpha_mul_tau_g1: List[object]
    alpha_mul_tau_g2: List[object]
    beta_mul_tau_g1: List[object]
    beta_mul_tau_g2: List[object]


@dataclass
class CommonParamterMatrix:
    """QAP-projected phase-1 output (mpc.rs:943-956)."""

    matrixed_g1_front: List[object]  # per-INPUT  beta*u + alpha*v + w
    matrixed_g2_front: List[object]
    matrixed_g1_back: List[object]  # per-AUX
    matrixed_g2_back: List[object]
    matrixed_h_g1: List[object]  # tau^{n+i} - tau^i
    matrixed_h_g2: List[object]


@dataclass
class UnCommonParamter:
    """A full phase-2 contribution (mpc.rs:891-924)."""

    delta: ParameterPair
    gamma: ParameterPair
    ic: TauParameterPair
    l: TauParameterPair
    h: TauParameterPair

    def to_storage_format(self) -> "UnCommonParamterInStorage":
        return UnCommonParamterInStorage(
            gamma_g1=self.gamma.g1_result,
            gamma_g2=self.gamma.g2_result,
            delta_g1=self.delta.g1_result,
            delta_g2=self.delta.g2_result,
            kin_g1=self.ic.get_g1(),
            kin_g2=self.ic.get_g2(),
            kout_g1=self.l.get_g1(),
            kout_g2=self.l.get_g2(),
            h_g1=self.h.get_g1(),
            h_g2=self.h.get_g2(),
        )


@dataclass
class UnCommonParamterInStorage:
    """Resumable on-chain phase-2 state (mpc.rs:925-942)."""

    gamma_g1: object
    gamma_g2: object
    delta_g1: object
    delta_g2: object
    kin_g1: List[object]
    kin_g2: List[object]
    kout_g1: List[object]
    kout_g2: List[object]
    h_g1: List[object]
    h_g2: List[object]


class CeremonyError(Exception):
    """A contribution failed its pairing verification."""


# ------------------------------------------------- batched pairing equations
def _check_eqs(engine: Engine, eqs: List[Tuple[object, object, object, object]]) -> List[bool]:
    """Verify e(a1, b1) == e(a2, b2) for a list of equations: one batched
    device check on the BLS12-381 engine's device (a CPU engine runs the
    same batch on the CPU), the host loop on any other engine."""
    if not eqs:
        return []
    if engine.name == "bls12_381":
        return list(
            pairing_eq_batch(
                [e[0] for e in eqs],
                [e[1] for e in eqs],
                [e[2] for e in eqs],
                [e[3] for e in eqs],
                device=engine.device,
            )
        )
    return [
        engine.gt_eq(engine.pairing(a1, b1), engine.pairing(a2, b2))
        for (a1, b1, a2, b2) in eqs
    ]


# ------------------------------------------------------- single-pair helpers
def make_new_paramter(
    engine: Engine, x: int, pointg1, pointg2, baseg1, baseg2, inverse: bool
) -> ParameterPair:
    """Scale a running pair and record the player's share (mpc.rs:647-675)."""
    s = pow(x, -1, engine.fr_host.p) if inverse else x
    return ParameterPair(
        g1_result=engine.g1.mul(pointg1, s),
        g2_result=engine.g2.mul(pointg2, s),
        g1_mine=engine.g1.mul(baseg1, s),
        g2_mine=engine.g2.mul(baseg2, s),
    )


def make_new_tau_paramter(
    engine: Engine, a: int, x: int, g1_list, g2_list, invert: bool
) -> TauParameterPair:
    """Scale element i by (a * x^i) [or its inverse] (mpc.rs:677-706).

    The running points are scaled with the host `mul`, element by element;
    the player's shares {s_i G} are one `batch_mul` per group.
    """
    p = engine.fr_host.p
    scalars = []
    cur = a % p
    for _ in range(len(g1_list)):
        s = pow(cur, -1, p) if invert else cur
        scalars.append(s)
        cur = cur * x % p
    g1_res = [engine.g1.mul(pt, s) for pt, s in zip(g1_list, scalars)]
    g2_res = [engine.g2.mul(pt, s) for pt, s in zip(g2_list, scalars)]
    g1_mine = engine.g1.batch_mul(engine.g1.generator(), scalars)
    g2_mine = engine.g2.batch_mul(engine.g2.generator(), scalars)
    return TauParameterPair(
        list=[
            ParameterPair(g1_result=r1, g2_result=r2, g1_mine=m1, g2_mine=m2)
            for r1, r2, m1, m2 in zip(g1_res, g2_res, g1_mine, g2_mine)
        ]
    )


# -------------------------------------------------- alpha-style list protocol
def init_parameter_list(engine: Engine) -> List[ParameterPair]:
    """Seed with generators (mpc.rs:45-58)."""
    return [
        ParameterPair(
            g1_result=engine.g1.generator(), g2_result=engine.g2.generator()
        )
    ]


def mpc_common_paramters_custom(
    engine: Engine, g1, g2, paramter_last: ParameterPair, my_alpha: int
) -> ParameterPair:
    """Multiply previous result by my secret; record my share (mpc.rs:102-128)."""
    return ParameterPair(
        g1_result=engine.g1.mul(paramter_last.g1_result, my_alpha),
        g2_result=engine.g2.mul(paramter_last.g2_result, my_alpha),
        g1_mine=engine.g1.mul(g1, my_alpha),
        g2_mine=engine.g2.mul(g2, my_alpha),
    )


def mpc_common_paramters_custom_generator(
    engine: Engine, paramter_last: ParameterPair, my_alpha: int
) -> ParameterPair:
    return mpc_common_paramters_custom(
        engine, engine.g1.generator(), engine.g2.generator(), paramter_last, my_alpha
    )


def mpc_bad_paramters_custom(
    engine: Engine, paramter_last: ParameterPair, my_alpha: int
) -> ParameterPair:
    """Malicious contribution ignoring the previous result (mpc.rs:130-154)."""
    g1 = engine.g1.generator()
    g2 = engine.g2.generator()
    return ParameterPair(
        g1_result=engine.g1.mul(g1, my_alpha),
        g2_result=engine.g2.mul(g2, my_alpha),
        g1_mine=engine.g1.mul(g1, my_alpha),
        g2_mine=engine.g2.mul(g2, my_alpha),
    )


def verify_mpc_g1(
    engine: Engine, new_paramter: ParameterPair, paramters: List[ParameterPair]
) -> bool:
    """Knowledge + chaining pairing checks (mpc.rs:156-180)."""
    g1 = engine.g1.generator()
    g2 = engine.g2.generator()
    eqs = [(new_paramter.g1_mine, g2, g1, new_paramter.g2_mine)]
    if paramters:
        eqs.append(
            (
                new_paramter.g1_result,
                g2,
                paramters[-1].g1_result,
                new_paramter.g2_mine,
            )
        )
    return all(_check_eqs(engine, eqs))


def paramter_list_excute(
    engine: Engine, vec: List[ParameterPair], p: ParameterPair
) -> List[ParameterPair]:
    """Verify then append (mpc.rs:60-84)."""
    if vec and not verify_mpc_g1(engine, p, vec):
        raise CeremonyError("contribution failed verification")
    vec.append(p)
    return vec


# ------------------------------------------------------ tau-vector protocol
def init_tau_parameter_list(engine: Engine, n: int) -> List[TauParameterPair]:
    """Seed every power with generators (mpc.rs:230-247)."""
    return [
        TauParameterPair(
            list=[
                ParameterPair(
                    g1_result=engine.g1.generator(),
                    g2_result=engine.g2.generator(),
                )
                for _ in range(n)
            ]
        )
    ]


def mpc_common_tauparamters_custom(
    engine: Engine, g1, g2, tauparamter_last: TauParameterPair, my_x: List[int]
) -> TauParameterPair:
    """Per-power contribution (mpc.rs:265-299)."""
    assert len(my_x) == len(tauparamter_last.list)
    out = []
    for pair, x in zip(tauparamter_last.list, my_x):
        out.append(
            ParameterPair(
                g1_result=engine.g1.mul(pair.g1_result, x),
                g2_result=engine.g2.mul(pair.g2_result, x),
                g1_mine=engine.g1.mul(g1, x),
                g2_mine=engine.g2.mul(g2, x),
            )
        )
    return TauParameterPair(list=out)


def mpc_common_tauparamters_custom_generator(
    engine: Engine, tauparamter_last: TauParameterPair, my_x: List[int]
) -> TauParameterPair:
    return mpc_common_tauparamters_custom(
        engine, engine.g1.generator(), engine.g2.generator(), tauparamter_last, my_x
    )


def verify_x_pow(engine: Engine, new_xparamter: TauParameterPair) -> bool:
    """Geometric consistency e(x^{i-1} g1, x g2) == e(x^i g1, g2) (mpc.rs:316-335)."""
    lst = new_xparamter.list
    g2 = engine.g2.generator()
    eqs = [
        (lst[i - 1].g1_result, lst[0].g2_result, lst[i].g1_result, g2)
        for i in range(1, len(lst))
    ]
    return all(_check_eqs(engine, eqs))


def verify_mpc_x(
    engine: Engine,
    new_xparamter: TauParameterPair,
    paramters: List[TauParameterPair],
) -> bool:
    """Power consistency + first-element chaining (mpc.rs:337-355)."""
    result = verify_x_pow(engine, new_xparamter)
    heads = [t.list[0] for t in paramters]
    return result and verify_mpc_g1(engine, new_xparamter.list[0], heads)


def tau_paramter_list_excute(
    engine: Engine, vec: List[TauParameterPair], p: TauParameterPair
) -> List[TauParameterPair]:
    """Verify then append (mpc.rs:301-314)."""
    if not verify_mpc_x(engine, p, vec):
        raise CeremonyError("tau contribution failed verification")
    vec.append(p)
    return vec


# ------------------------------------------------------------------- phase 1
def initial_common_paramters(engine: Engine, length: int) -> CommonParamterInStorage:
    """All-generators initial state (mpc.rs:708-728)."""
    g1 = engine.g1.generator()
    g2 = engine.g2.generator()
    return CommonParamterInStorage(
        alpha_g1=g1,
        alpha_g2=g2,
        beta_g1=g1,
        beta_g2=g2,
        tau_g1=[g1] * length,
        tau_g2=[g2] * length,
        alpha_mul_tau_g1=[g1] * length,
        alpha_mul_tau_g2=[g2] * length,
        beta_mul_tau_g1=[g1] * length,
        beta_mul_tau_g2=[g2] * length,
    )


def mpc_common_paramters_generator(
    engine: Engine,
    storage: CommonParamterInStorage,
    secrets: Tuple[int, int, int],
) -> CommonParamter:
    """One player's phase-1 contribution from secrets (alpha, beta, tau)
    (mpc.rs:730-785)."""
    alpha, beta, tau = secrets
    g1 = engine.g1.generator()
    g2 = engine.g2.generator()
    return CommonParamter(
        alpha=make_new_paramter(
            engine, alpha, storage.alpha_g1, storage.alpha_g2, g1, g2, False
        ),
        beta=make_new_paramter(
            engine, beta, storage.beta_g1, storage.beta_g2, g1, g2, False
        ),
        tau=make_new_tau_paramter(
            engine, 1, tau, storage.tau_g1, storage.tau_g2, False
        ),
        alpha_mul_tau=make_new_tau_paramter(
            engine, alpha, tau, storage.alpha_mul_tau_g1, storage.alpha_mul_tau_g2, False
        ),
        beta_mul_tau=make_new_tau_paramter(
            engine, beta, tau, storage.beta_mul_tau_g1, storage.beta_mul_tau_g2, False
        ),
    )


def verify_new_paramter(
    engine: Engine, paramter: ParameterPair, baseg1, baseg2
) -> bool:
    """Two pairing equations per element (mpc.rs:787-804)."""
    g1 = engine.g1.generator()
    g2 = engine.g2.generator()
    return all(
        _check_eqs(
            engine,
            [
                (paramter.g1_result, g2, baseg1, paramter.g2_mine),
                (paramter.g1_result, g2, g1, paramter.g2_result),
            ],
        )
    )


def _new_paramter_eqs(engine: Engine, paramter: ParameterPair, baseg1):
    g1 = engine.g1.generator()
    g2 = engine.g2.generator()
    return [
        (paramter.g1_result, g2, baseg1, paramter.g2_mine),
        (paramter.g1_result, g2, g1, paramter.g2_result),
    ]


def verify_common_paramter(
    engine: Engine,
    storage: CommonParamterInStorage,
    new_paramter: CommonParamter,
    strict_tau: bool = True,
) -> CommonParamterInStorage:
    """Full phase-1 verification; returns the new storage (mpc.rs:806-862).

    All pairing equations for the whole contribution are collected and
    dispatched as ONE device batch.  `strict_tau` additionally enforces the
    tau-power geometric checks (the reference stubbed these out,
    mpc.rs:830-840; they hold for honest contributions).
    """
    length = len(new_paramter.tau.list)
    if (
        length != len(new_paramter.alpha_mul_tau.list)
        or length != len(new_paramter.beta_mul_tau.list)
    ):
        raise CeremonyError("length mismatch")
    eqs = []
    eqs += _new_paramter_eqs(engine, new_paramter.alpha, storage.alpha_g1)
    eqs += _new_paramter_eqs(engine, new_paramter.beta, storage.beta_g1)
    for i in range(length):
        eqs += _new_paramter_eqs(
            engine, new_paramter.alpha_mul_tau.list[i], storage.alpha_mul_tau_g1[i]
        )
        eqs += _new_paramter_eqs(
            engine, new_paramter.beta_mul_tau.list[i], storage.beta_mul_tau_g1[i]
        )
    if strict_tau and length > 1:
        # Phase-1 tau lists are x^0-based (tau_g1[0] = G), so the geometric
        # check pairs against lst[1] (the x element) — unlike verify_x_pow,
        # whose standalone lists are x^1-based (mpc.rs:230-247, 316-335).
        lst = new_paramter.tau.list
        g2 = engine.g2.generator()
        for i in range(1, length):
            eqs.append(
                (lst[i - 1].g1_result, lst[1].g2_result, lst[i].g1_result, g2)
            )
    if not all(_check_eqs(engine, eqs)):
        raise CeremonyError("phase-1 contribution failed verification")
    return new_paramter.to_storage_format()


# Canned 3-player common ceremony: secrets pinned so the cumulative trapdoor
# equals the deterministic one (alpha=6, beta=24, tau=2) — mpc.rs:864-888.
COMMON_CEREMONY_PLAYERS = [(1, 2, 1), (2, 3, 1), (3, 4, 2)]


def mpc_common_paramters_custom_all(
    engine: Engine, length: int = 8
) -> CommonParamterInStorage:
    storage = initial_common_paramters(engine, length)
    for secrets in COMMON_CEREMONY_PLAYERS:
        contribution = mpc_common_paramters_generator(engine, storage, secrets)
        storage = verify_common_paramter(engine, storage, contribution)
    return storage


# ------------------------------------------------------------ QAP projection
def list_mul_matrix(engine: Engine, list_g1, list_g2, matrix):
    """result_i = sum_j coeff_ij * list[constraint_ij]  (mpc.rs:416-457).

    NOTE: power-basis projection — the column entry (coeff, constraint_index)
    selects the tau^constraint point, faithful to mpc.rs:442-445.
    """
    n = len(matrix)
    res_g1 = [engine.g1.identity()] * n
    res_g2 = [engine.g2.identity()] * n
    for i, row in enumerate(matrix):
        for coeff, idx in row:
            res_g1[i] = engine.g1.add(res_g1[i], engine.g1.mul(list_g1[idx], coeff))
            res_g2[i] = engine.g2.add(res_g2[i], engine.g2.mul(list_g2[idx], coeff))
    return res_g1, res_g2


def matrix_storage(
    storage: CommonParamterInStorage,
    engine: Engine,
    at_inputs,
    bt_inputs,
    ct_inputs,
    at_aux,
    bt_aux,
    ct_aux,
    num_constraints: int,
) -> CommonParamterMatrix:
    """QAP projection of phase-1 output (mpc.rs:466-645).

    front = per-INPUT points beta*u_i + alpha*v_i + w_i (IC analog),
    back  = per-AUX points (L analog),
    h_i   = tau^{n+i} - tau^i.
    The reference's `matrix`/`matrix_test` variants disagree on slicing
    (mpc.rs:466-554 vs :557-645); this is the coherent form both intend.
    Requires len(tau) >= 2*num_constraints.
    """
    if len(storage.tau_g1) < 2 * num_constraints:
        raise CeremonyError(
            "tau-power list too short for H basis: need >= 2*num_constraints"
        )

    def project(at, bt, ct):
        a_g1, a_g2 = list_mul_matrix(
            engine, storage.alpha_mul_tau_g1, storage.alpha_mul_tau_g2, bt
        )
        b_g1, b_g2 = list_mul_matrix(
            engine, storage.beta_mul_tau_g1, storage.beta_mul_tau_g2, at
        )
        t_g1, t_g2 = list_mul_matrix(engine, storage.tau_g1, storage.tau_g2, ct)
        g1s = [
            engine.g1.add(engine.g1.add(a, b), t)
            for a, b, t in zip(a_g1, b_g1, t_g1)
        ]
        g2s = [
            engine.g2.add(engine.g2.add(a, b), t)
            for a, b, t in zip(a_g2, b_g2, t_g2)
        ]
        return g1s, g2s

    front_g1, front_g2 = project(at_inputs, bt_inputs, ct_inputs)
    back_g1, back_g2 = project(at_aux, bt_aux, ct_aux)
    h_g1 = [
        engine.g1.add(
            storage.tau_g1[num_constraints + i], engine.g1.neg(storage.tau_g1[i])
        )
        for i in range(num_constraints)
    ]
    h_g2 = [
        engine.g2.add(
            storage.tau_g2[num_constraints + i], engine.g2.neg(storage.tau_g2[i])
        )
        for i in range(num_constraints)
    ]
    return CommonParamterMatrix(
        matrixed_g1_front=front_g1,
        matrixed_g2_front=front_g2,
        matrixed_g1_back=back_g1,
        matrixed_g2_back=back_g2,
        matrixed_h_g1=h_g1,
        matrixed_h_g2=h_g2,
    )


def matrix_storage_lagrange(
    storage: CommonParamterInStorage,
    engine: Engine,
    at_inputs,
    bt_inputs,
    ct_inputs,
    at_aux,
    bt_aux,
    ct_aux,
    num_constraints: int,
) -> CommonParamterMatrix:
    """SOUND QAP projection of phase-1 output: Lagrange basis.

    The reference ceremony projects QAP columns in the POWER basis
    (mpc.rs:442-445) — structurally faithful but not the basis the actual
    Groth16 generator evaluates in (generator.rs:400-402 iFFTs the tau
    powers into Lagrange coefficients first).  This variant applies the
    group iNTT (engine.g1.intt / ops/group_ntt.py) to the tau-power point
    vectors so the projected per-variable points equal the direct
    generator's CRS elements exactly:

        u_i(tau)*G = sum_j at[i]=(coeff, j) -> coeff * (L_j(tau)*G)

    with L_j(tau)*G = iNTT([tau^k G])_j over the 2^exp >= num_constraints
    evaluation domain, and the H basis tau^j*t(tau) = tau^(m+j) - tau^j
    (t(X) = X^m - 1) straight from the power list.  Requires
    len(storage.tau_*) >= 2m - 1.
    """
    m, _exp = domain_size_for(num_constraints, engine.fr_host)
    if len(storage.tau_g1) < 2 * m - 1:
        raise CeremonyError(
            "tau-power list too short: Lagrange matrix needs >= 2m-1 powers"
        )
    host = engine.fr_host
    lag = {
        "tau_g1": engine.g1.intt(storage.tau_g1[:m], host),
        "tau_g2": engine.g2.intt(storage.tau_g2[:m], host),
        "a_g1": engine.g1.intt(storage.alpha_mul_tau_g1[:m], host),
        "a_g2": engine.g2.intt(storage.alpha_mul_tau_g2[:m], host),
        "b_g1": engine.g1.intt(storage.beta_mul_tau_g1[:m], host),
        "b_g2": engine.g2.intt(storage.beta_mul_tau_g2[:m], host),
    }

    def project(at, bt, ct):
        a_g1, a_g2 = list_mul_matrix(engine, lag["a_g1"], lag["a_g2"], bt)
        b_g1, b_g2 = list_mul_matrix(engine, lag["b_g1"], lag["b_g2"], at)
        t_g1, t_g2 = list_mul_matrix(engine, lag["tau_g1"], lag["tau_g2"], ct)
        g1s = [
            engine.g1.add(engine.g1.add(a, b), t)
            for a, b, t in zip(a_g1, b_g1, t_g1)
        ]
        g2s = [
            engine.g2.add(engine.g2.add(a, b), t)
            for a, b, t in zip(a_g2, b_g2, t_g2)
        ]
        return g1s, g2s

    front_g1, front_g2 = project(at_inputs, bt_inputs, ct_inputs)
    back_g1, back_g2 = project(at_aux, bt_aux, ct_aux)
    h_g1 = [
        engine.g1.add(storage.tau_g1[m + i], engine.g1.neg(storage.tau_g1[i]))
        for i in range(m - 1)
    ]
    h_g2 = [
        engine.g2.add(storage.tau_g2[m + i], engine.g2.neg(storage.tau_g2[i]))
        for i in range(m - 1)
    ]
    return CommonParamterMatrix(
        matrixed_g1_front=front_g1,
        matrixed_g2_front=front_g2,
        matrixed_g1_back=back_g1,
        matrixed_g2_back=back_g2,
        matrixed_h_g1=h_g1,
        matrixed_h_g2=h_g2,
    )


# ------------------------------------------------------------------- phase 2
def initial_uncommon_paramters(
    engine: Engine, m: CommonParamterMatrix
) -> UnCommonParamterInStorage:
    """Initial phase-2 state from the matrix (mpc.rs:993-1015)."""
    g1 = engine.g1.generator()
    g2 = engine.g2.generator()
    return UnCommonParamterInStorage(
        gamma_g1=g1,
        gamma_g2=g2,
        delta_g1=g1,
        delta_g2=g2,
        kin_g1=list(m.matrixed_g1_front),
        kin_g2=list(m.matrixed_g2_front),
        kout_g1=list(m.matrixed_g1_back),
        kout_g2=list(m.matrixed_g2_back),
        h_g1=list(m.matrixed_h_g1),
        h_g2=list(m.matrixed_h_g2),
    )


def mpc_uncommon_paramters_generator(
    engine: Engine,
    storage: UnCommonParamterInStorage,
    secrets: Tuple[int, int],
) -> UnCommonParamter:
    """One player's phase-2 contribution from secrets (gamma, delta)
    (mpc.rs:1017-1063): gamma/delta forward; kin by gamma^{-1}; kout and h
    by delta^{-1}."""
    gamma, delta = secrets
    g1 = engine.g1.generator()
    g2 = engine.g2.generator()
    return UnCommonParamter(
        delta=make_new_paramter(
            engine, delta, storage.delta_g1, storage.delta_g2, g1, g2, False
        ),
        gamma=make_new_paramter(
            engine, gamma, storage.gamma_g1, storage.gamma_g2, g1, g2, False
        ),
        ic=make_new_tau_paramter(
            engine, gamma, 1, storage.kin_g1, storage.kin_g2, True
        ),
        l=make_new_tau_paramter(
            engine, delta, 1, storage.kout_g1, storage.kout_g2, True
        ),
        h=make_new_tau_paramter(
            engine, delta, 1, storage.h_g1, storage.h_g2, True
        ),
    )


def verify_uncommon_paramter(
    engine: Engine,
    common_paramter_matrix: CommonParamterMatrix,
    storage: UnCommonParamterInStorage,
    new_paramter: UnCommonParamter,
) -> UnCommonParamterInStorage:
    """Phase-2 verification against the ORIGINAL matrix (mpc.rs:1065-1131):
        e(kin_i, gamma_result_g2) == e(front_i, G2)
        e(kout_i, delta_result_g2) == e(back_i, G2)
        e(h_i,   delta_result_g2) == e(h_matrix_i, G2)
    plus delta/gamma chaining.  One device batch for everything."""
    g2 = engine.g2.generator()
    eqs = []
    eqs += _new_paramter_eqs(engine, new_paramter.delta, storage.delta_g1)
    eqs += _new_paramter_eqs(engine, new_paramter.gamma, storage.gamma_g1)
    gamma_g2 = new_paramter.gamma.g2_result
    delta_g2 = new_paramter.delta.g2_result
    for i in range(len(storage.kin_g1)):
        eqs.append(
            (
                new_paramter.ic.list[i].g1_result,
                gamma_g2,
                common_paramter_matrix.matrixed_g1_front[i],
                g2,
            )
        )
    for i in range(len(storage.kout_g1)):
        eqs.append(
            (
                new_paramter.l.list[i].g1_result,
                delta_g2,
                common_paramter_matrix.matrixed_g1_back[i],
                g2,
            )
        )
    for i in range(len(storage.h_g1)):
        eqs.append(
            (
                new_paramter.h.list[i].g1_result,
                delta_g2,
                common_paramter_matrix.matrixed_h_g1[i],
                g2,
            )
        )
    if not all(_check_eqs(engine, eqs)):
        raise CeremonyError("phase-2 contribution failed verification")
    return new_paramter.to_storage_format()


# Canned 3-player uncommon ceremony (gamma=6, delta=24) — mpc.rs:959-991.
UNCOMMON_CEREMONY_PLAYERS = [(1, 2), (2, 3), (3, 4)]


def mpc_uncommon_paramters_custom_all(
    engine: Engine, common_paramter_matrix: CommonParamterMatrix
) -> UnCommonParamterInStorage:
    storage = initial_uncommon_paramters(engine, common_paramter_matrix)
    for secrets in UNCOMMON_CEREMONY_PLAYERS:
        contribution = mpc_uncommon_paramters_generator(engine, storage, secrets)
        storage = verify_uncommon_paramter(
            engine, common_paramter_matrix, storage, contribution
        )
    return storage


# ------------------------------------------------------- ceremony-only setup
def generate_parameters_mpc(
    engine: Engine, circuit: Circuit, g1=None, g2=None, basis: str = "power"
) -> Parameters:
    """Build Parameters purely from ceremony output (generator.rs:163-237).

    The reference leaves the A/B queries as empty (filtered-identity) vectors
    — incomplete; here they are completed from the phase-1 tau powers.

    basis="power" (default): the reference's convention — QAP columns
    projected onto raw tau powers (mpc.rs:442-445).  Structurally complete
    but NOT interchangeable with the Lagrange-basis CRS of
    generate_parameters.

    basis="lagrange": the SOUND convention — phase-1 tau-power points are
    group-iNTT'd into Lagrange-coefficient points first
    (matrix_storage_lagrange), so under the canned ceremony secrets
    (totals alpha=6, beta=24, tau=2, gamma=6, delta=24 — exactly the
    deterministic trapdoor, generator.rs:32-39) the output equals
    generate_parameters' CRS element for element, and proofs built from it
    verify under either key.
    """
    assert basis in ("power", "lagrange")
    assembly = synthesize_keypair(engine, circuit)
    n = assembly.num_constraints
    if basis == "lagrange":
        m, _exp = domain_size_for(n, engine.fr_host)
        cp = mpc_common_paramters_custom_all(engine, length=2 * m)
        cp_m = matrix_storage_lagrange(
            cp,
            engine,
            assembly.at_inputs,
            assembly.bt_inputs,
            assembly.ct_inputs,
            assembly.at_aux,
            assembly.bt_aux,
            assembly.ct_aux,
            n,
        )
    else:
        cp = mpc_common_paramters_custom_all(engine, length=2 * n)
        cp_m = matrix_storage(
            cp,
            engine,
            assembly.at_inputs,
            assembly.bt_inputs,
            assembly.ct_inputs,
            assembly.at_aux,
            assembly.bt_aux,
            assembly.ct_aux,
            n,
        )
    ucp = mpc_uncommon_paramters_custom_all(engine, cp_m)

    def eval_query(tables, glist, group):
        out = []
        for col in tables:
            acc = group.identity()
            for coeff, idx in col:
                acc = group.add(acc, group.mul(glist[idx], coeff))
            out.append(acc)
        return out

    if basis == "lagrange":
        host = engine.fr_host
        m, _exp = domain_size_for(n, host)
        basis_g1 = engine.g1.intt(cp.tau_g1[:m], host)
        basis_g2 = engine.g2.intt(cp.tau_g2[:m], host)
    else:
        basis_g1 = cp.tau_g1
        basis_g2 = cp.tau_g2
    at_all = assembly.at_inputs + assembly.at_aux
    bt_all = assembly.bt_inputs + assembly.bt_aux
    a = eval_query(at_all, basis_g1, engine.g1)
    b_g1 = eval_query(bt_all, basis_g1, engine.g1)
    b_g2 = eval_query(bt_all, basis_g2, engine.g2)

    vk = VerifyingKey(
        alpha_g1=cp.alpha_g1,
        beta_g1=cp.beta_g1,
        beta_g2=cp.beta_g2,
        gamma_g2=ucp.gamma_g2,
        delta_g1=ucp.delta_g1,
        delta_g2=ucp.delta_g2,
        ic=ucp.kin_g1,
    )
    return Parameters(
        vk=vk,
        h=list(ucp.h_g1),
        l=list(ucp.kout_g1),
        a=[e for e in a if not engine.g1.is_identity(e)],
        b_g1=[e for e in b_g1 if not engine.g1.is_identity(e)],
        b_g2=[e for e in b_g2 if not engine.g2.is_identity(e)],
    )
