"""The reference's BatchProver opt-ins on the port, on the CPU, at tolerance 0:

* at MiMC rounds = 8, B = 2, on the reference's CRS: BMT_GLV=1 (GLV-2 on
  G1, GLS-4 on G2), BMT_MERGE_G1=1 (the four G1 MSMs as one segmented
  fold), both together, and BMT_STACK_MSMS=1 with ladder and with pippenger
  each give the reference's `create_random_proof` bytes; their tables, fold
  windows (the fold kernels' calls) and limb multiplies are as derived;
* on the same CRS and witnesses, `mesh=` (a mesh of logical CPU shards,
  the table strategy) at (2, 2), and at (1, 4) with every NTT sharded
  (BMT_SHARD_NTT_EXP=0), gives the reference's bytes too, and a batch
  that does not divide over "data" raises ValueError;
* the provers of this module build their affine limb tables once: a
  build serves every later prover that asks for the same base points,
  width and scalar bits (GLV's for GLV and both, the plain ones for merged
  and the meshes);
* under BMT_CARRIES=scan the limb field's add, sub, neg, canon, redc_cols,
  propagate and plain multiply give the flat strategy's raw limbs and the
  reference's scan limbs, and the h(x) pipeline and a decode give the flat
  run's limbs and points;
* the `rns_point` helpers the fold does not use (`point_double`,
  `point_select`, `is_stored_zero`, the bound fixpoints) give the
  reference's residues and bounds.
"""

import random
from fractions import Fraction
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.curves import rns_point as rrp
from bellman_mpc_tpu.fields import bls12_381 as rbc
from bellman_mpc_tpu.fields import limb as ref_limb
from bellman_mpc_tpu.groth16 import create_random_proof, generate_random_parameters
from bellman_mpc_tpu.groth16.bls12 import BLS12_381
from bellman_mpc_tpu.models import MiMCDemo as RefMiMC
from bellman_mpc_tpu.models import mimc_constants
from bellman_mpc_tpu_torch import groth16 as tg
from bellman_mpc_tpu_torch import interop
from bellman_mpc_tpu_torch.curves import rns_point as trp
from bellman_mpc_tpu_torch.curves.host import G1, G2
from bellman_mpc_tpu_torch.fields.bls12_381 import fp, fr
from bellman_mpc_tpu_torch.fields.limb import LimbField
from bellman_mpc_tpu_torch.groth16.prover import _h_pipeline, synthesize_witness
from bellman_mpc_tpu_torch.models import MiMCDemo
from bellman_mpc_tpu_torch.ops import fold_kernels
from bellman_mpc_tpu_torch.parallel import BatchProver, batch_prover, make_mesh

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

ROUNDS = 8


@pytest.fixture(scope="module")
def crs():
    """The reference's CRS carried over to the port, two witnesses and the
    reference's sequential proofs of them."""
    host = BLS12_381.fr_host
    constants = mimc_constants(host, seed=9, rounds=ROUNDS)
    ref_params = generate_random_parameters(BLS12_381, RefMiMC(constants))
    rng = random.Random(13)
    wit = [(rng.randrange(host.p), rng.randrange(host.p)) for _ in range(2)]
    want = [interop.proof_from(create_random_proof(BLS12_381, RefMiMC(constants, xl, xr), ref_params))
            for xl, xr in wit]
    return SimpleNamespace(constants=constants, params=interop.params_from(ref_params),
                           engine=tg.Bls12Engine("cpu"), wit=wit, want=want)


def _counting(counter, key, fn):
    def counted(*a, **kw):
        counter[key] += 1
        return fn(*a, **kw)

    return counted


# (env, strategy, table_info (name, bases, c), K1 and K2 calls per step); on
# the CPU every table takes c = 4: W = ceil(nbits / 4) + 1 windows, 65 at
# 255 bits, 34 at GLV's 130, 18 at GLS's 66
OPT_INS = {
    "glv": ({"BMT_GLV": "1"}, "rns",
            [("h", 64, 4), ("l", 64, 4), ("a", 64, 4), ("b1", 32, 4), ("b2", 64, 4)], 4 * 34, 18),
    "merged": ({"BMT_MERGE_G1": "1"}, "rns", [("g1_merged", 112, 4), ("b2", 16, 4)], 65, 65),
    "glv-merged": ({"BMT_GLV": "1", "BMT_MERGE_G1": "1"}, "rns",
                   [("g1_merged", 224, 4), ("b2", 64, 4)], 34, 18),
    "stacked-ladder": ({"BMT_STACK_MSMS": "1"}, "ladder", [], 0, 0),
    "stacked-pippenger": ({"BMT_STACK_MSMS": "1"}, "pippenger", [], 0, 0),
}


@pytest.fixture(scope="module")
def limb_tables():
    """The affine limb tables built in this module, by base points, width
    and scalar bits."""
    return {}


def _share_tables(monkeypatch, cache):
    """BatchProver's window_tables_affine returns the module's earlier build
    for the same base points, width and bits (nothing writes to a table)."""
    build = batch_prover.window_tables_affine

    def cached(ops, points, c, nbits=255):
        key = (id(ops), c, nbits) + tuple(x.numpy().tobytes() for x in points)
        if key not in cache:
            cache[key] = build(ops, points, c, nbits)
        return cache[key]

    monkeypatch.setattr(batch_prover, "window_tables_affine", cached)


@pytest.fixture(scope="module")
def ladder_steps():
    """The stacked-ladder case's prover and step output, which the scan
    carries test decodes again (a ladder step takes half a minute here)."""
    return {}


@pytest.mark.parametrize("name", list(OPT_INS))
def test_opt_in_matches_reference(crs, ladder_steps, limb_tables, name, monkeypatch):
    env, strategy, tables, k1, k2 = OPT_INS[name]
    _share_tables(monkeypatch, limb_tables)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    bp = BatchProver(crs.engine, crs.params, MiMCDemo(crs.constants, 0, 0), msm_strategy=strategy,
                     pippenger_c=4)
    assert (bp.glv, bp.merge_g1, bp.stack_msms) == (
        "BMT_GLV" in env, "BMT_MERGE_G1" in env, "BMT_STACK_MSMS" in env)
    assert [(n, k, c) for n, k, c, _ in bp.table_info()] == tables
    args = bp.encode_circuits([MiMCDemo(crs.constants, xl, xr) for xl, xr in crs.wit])
    calls = {"k1": 0, "k2": 0, "mul": 0}
    monkeypatch.setattr(fold_kernels, "rns_fold_window",
                        _counting(calls, "k1", fold_kernels.rns_fold_window))
    monkeypatch.setattr(fold_kernels, "rns_fold_window_g2",
                        _counting(calls, "k2", fold_kernels.rns_fold_window_g2))
    monkeypatch.setattr(LimbField, "mul", _counting(calls, "mul", LimbField.mul))
    out = bp.step(*args)
    assert (calls["k1"], calls["k2"]) == (k1, k2)
    # a step's limb multiplies are rns's: to_mont, the h(x) pipeline, std_from_mont
    assert calls["mul"] == 15 * bp.exp + 12
    assert bp.decode(*out) == crs.want
    if name == "stacked-ladder":
        ladder_steps["stacked"] = (bp, out)


@pytest.mark.parametrize("shape,shard_exp", [((2, 2), None), ((1, 4), "0")], ids=["2x2", "1x4-sharded-ntt"])
def test_mesh_matches_reference(crs, limb_tables, shape, shard_exp, monkeypatch):
    _share_tables(monkeypatch, limb_tables)
    if shard_exp is not None:
        monkeypatch.setenv("BMT_SHARD_NTT_EXP", shard_exp)
    mesh = make_mesh(4, shape=shape, devices=["cpu"] * 4)
    bp = BatchProver(crs.engine, crs.params, MiMCDemo(crs.constants, 0, 0), mesh=mesh)
    assert bp.msm_strategy == "table" and bp.mesh is mesh
    assert [(n, k, c) for n, k, c, _ in bp.table_info()] == [
        ("h", 32, 4), ("l", 32, 4), ("a", 32, 4), ("b1", 16, 4), ("b2", 16, 4)]
    args = bp.encode_circuits([MiMCDemo(crs.constants, xl, xr) for xl, xr in crs.wit])
    assert bp.decode(*bp.step(*args)) == crs.want
    if shape[0] == 2:
        with pytest.raises(ValueError, match="divide"):
            bp.step(*(a[:1] for a in args))


def _raw_limbs(f, vals):
    return torch.tensor([[(v >> (11 * i)) & 2047 for v in vals] for i in range(f.L)], dtype=torch.int32)


@pytest.fixture
def scan(monkeypatch):
    """BMT_CARRIES=scan for the port and the reference (whose choice is
    cached per process: cleared before and after)."""
    monkeypatch.setenv("BMT_CARRIES", "scan")
    ref_limb._flat_carries.cache_clear()
    assert not ref_limb._flat_carries()
    yield
    monkeypatch.undo()
    ref_limb._flat_carries.cache_clear()


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_scan_carries_match_flat_and_reference(name, scan, monkeypatch):
    f, rf = (fr, rbc.fr) if name == "fr" else (fp, rbc.fp)
    a, b = _raw_limbs(f, _vals(f, 16, 41)), _raw_limbs(f, _vals(f, 16, 42))
    cols = f.mul_cols(a, b)
    signed = cols.clone()  # the same value on limbs of both signs: 5 moved down from every odd limb
    signed[1::2] -= 5
    signed[0:-1:2] += 5 << 11
    ops = {
        "add": lambda F, x, y, c: F.add(x, y),
        "sub": lambda F, x, y, c: F.sub(x, y),
        "neg": lambda F, x, y, c: F.neg(x),
        "canon": lambda F, x, y, c: F.canon(x),
        "redc_cols": lambda F, x, y, c: F.redc_cols(c),
        "mul_plain": lambda F, x, y, c: F.mul_plain(x, y) if isinstance(x, torch.Tensor) else F.mul(x, y),
    }
    for op, fn in ops.items():
        got = fn(f, a, b, cols)
        want_ref = np.asarray(fn(rf, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), jnp.asarray(cols.numpy())))
        monkeypatch.setenv("BMT_CARRIES", "flat")
        flat = fn(f, a, b, cols)
        monkeypatch.setenv("BMT_CARRIES", "scan")
        assert torch.equal(got, flat), op
        assert np.array_equal(got.numpy(), want_ref), op
    got = f.propagate(signed)
    assert np.array_equal(got.numpy(), np.asarray(rf.propagate(jnp.asarray(signed.numpy()))))
    value = lambda t: [sum(int(t[i, j]) << (11 * i) for i in range(t.shape[0])) for j in range(t.shape[1])]
    assert value(got) == value(signed) and int(got.max()) < 2048 and int(got.min()) >= 0


def _vals(f, n, seed):
    rng = random.Random(seed)
    return [0, 1, f.p - 1, f.p, 2 * f.p - 1] + [rng.randrange(2 * f.p) for _ in range(n - 5)]


def test_scan_carries_h_pipeline_and_decode(crs, ladder_steps, monkeypatch):
    """h(x) of witness 0 and the decode of a (stacked) ladder step's points
    under BMT_CARRIES=scan equal the flat run's limbs and points; the step
    is the stacked-ladder case's where it ran."""
    eng = crs.engine
    prover = synthesize_witness(eng, MiMCDemo(crs.constants, *crs.wit[0]))
    m = 1 << (len(prover.a) - 1).bit_length()
    exp = m.bit_length() - 1
    abc = [fr.encode(list(v) + [0] * (m - len(v))) for v in (prover.a, prover.b, prover.c)]
    if "stacked" in ladder_steps:
        bp, out = ladder_steps["stacked"]
    else:
        monkeypatch.setenv("BMT_STACK_MSMS", "1")
        bp = BatchProver(eng, crs.params, MiMCDemo(crs.constants, 0, 0), msm_strategy="ladder")
        monkeypatch.delenv("BMT_STACK_MSMS")
        out = bp.step(*bp.encode_circuits([MiMCDemo(crs.constants, xl, xr) for xl, xr in crs.wit]))
    flat_h = _h_pipeline(fr, eng.fr_host, exp)(*abc)
    flat_proofs = bp.decode(*out)
    monkeypatch.setenv("BMT_CARRIES", "scan")
    assert torch.equal(_h_pipeline(fr, eng.fr_host, exp)(*abc), flat_h)
    assert bp.decode(*out) == flat_proofs == crs.want


# ------------------------------------------------------------ rns_point helpers
RF, TF = rrp.default_rns_field(), trp.default_rns_field()


def _pts(group, n, seed):
    rng = random.Random(seed)
    return [group.mul(group.generator, rng.randrange(1, 1 << 64)) for _ in range(n)]


def _enc(group, pts, z):
    """Host points -> port RnsVal projective coords (G2: (C, 2, n))."""
    if group is G1:
        return tuple(TF.encode(v) for v in ([p[0] for p in pts], [p[1] for p in pts], z))

    def enc2(vals):
        c0, c1 = TF.encode([v[0] for v in vals]), TF.encode([v[1] for v in vals])
        return trp.RnsVal(TF, torch.stack([c0.res, c1.res], dim=1), Fraction(1))

    return enc2([p[0] for p in pts]), enc2([p[1] for p in pts]), enc2(z)


def _ref(v):
    return rrp.RnsVal(RF, jnp.asarray(v.res.numpy()), v.a)


def _same(r, t):
    return np.array_equal(np.asarray(r.res), t.res.numpy()) and r.a == t.a


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_rns_point_helpers_match_reference(g2):
    group = G2 if g2 else G1
    tops, rops = (trp.rns_g2_ops(), rrp.rns_g2_ops()) if g2 else (trp.rns_g1_ops(), rrp.rns_g1_ops())
    n = 4
    pts = _pts(group, n, 51 + g2)
    one = [(1, 0)] * n if g2 else [1] * n
    p = _enc(group, pts, one)
    dbl = trp.point_double(tops, p)
    ref_dbl = rrp.point_double(rops, tuple(_ref(v) for v in p))
    assert all(_same(r, t) for r, t in zip(ref_dbl, dbl))
    # decoded: 2P (affine from the projective residues on the host)
    dec = []
    for coord in dbl:
        if g2:
            c0 = TF.decode(trp.RnsVal(TF, coord.res[:, 0], coord.a))
            c1 = TF.decode(trp.RnsVal(TF, coord.res[:, 1], coord.a))
            dec.append(list(zip(c0, c1)))
        else:
            dec.append(TF.decode(coord))
    ops = group.ops
    assert [(ops.mul(x, ops.inv(z)), ops.mul(y, ops.inv(z))) for x, y, z in zip(*dec)] == \
        [group.double(q) for q in pts]
    # point_select and is_stored_zero, with exact zeros, zero-mod-p values
    # (p itself) and values zero in one Fp2 component only
    ident = trp.point_identity(tops, (n,), "cpu")
    cond = torch.tensor([True, False, True, False])
    sel = trp.point_select(tops, cond, p, ident)
    ref_sel = rrp.point_select(rops, jnp.asarray(cond.numpy()), tuple(_ref(v) for v in p),
                               tuple(_ref(v) for v in ident))
    assert all(_same(r, t) for r, t in zip(ref_sel, sel))
    x = p[0].res.clone()
    x[..., 0] = 0
    raw_p = TF.encode_raw(TF.p)
    if g2:
        x[:, 0, 1], x[:, 1, 1] = raw_p, 0
        x[:, 1, 2] = 0
    else:
        x[:, 1] = raw_p
    v = trp.RnsVal(TF, x, Fraction(2))
    got = tops.is_stored_zero(v)
    assert got.tolist() == np.asarray(rops.is_stored_zero(_ref(v))).tolist()
    assert got.tolist()[0] is True and not any(got.tolist()[1:])


def test_rns_fixpoints_match_reference():
    a_tab = Fraction(2) * TF.p / TF.M + (TF.k + 1)  # the limb -> RNS converted table bound
    for t_ops, r_ops, acc in ((trp.rns_g1_ops(), rrp.rns_g1_ops(), 128), (trp.rns_g2_ops(), rrp.rns_g2_ops(), 256)):
        assert trp.mixed_add_fixpoint(t_ops, Fraction(acc), a_tab) == \
            rrp.mixed_add_fixpoint(r_ops, Fraction(acc), a_tab)
        assert trp.add_fixpoint(t_ops, Fraction(512)) == rrp.add_fixpoint(r_ops, Fraction(512))
        with pytest.raises(AssertionError, match="fixpoint"):
            trp.mixed_add_fixpoint(t_ops, Fraction(2), a_tab)
        with pytest.raises(AssertionError, match="fixpoint"):
            trp.add_fixpoint(t_ops, Fraction(2))
