"""The port's host surface against the JAX reference: `config`, the
`Worker`/`Waiter` facade and `log2_floor`, `ffi`, the MiMC helpers
`neo_create_parameters` and `timed_prove_verify`, `utils.profiling`, the
parity helpers (`RnsField.select`, `is_zero_exact`, `mul_const`,
`RnsVal.double`, `DevFp.eq`, `DevFp2.eq`, `lagrange_coeffs_at_tau`) and
`benches` (tolerance 0 throughout: integers, residues, booleans).
`BatchProver.run_step` is held to `step` in test_torch_batch_prover.py, on
that file's prover.

The mock field's two-adicity holds no MiMC-322 domain (646 constraints need
2^10, and the domain stops at 2^9), in the reference as in the port, so the
MiMC helpers are held to each other on the mock engine with their round
constants cut to 100 rounds, the reference's own small-field size
(tests/test_models.py), beside the error both raise at 322.
"""

import dataclasses
import importlib
import json
import logging
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellman_mpc_tpu import config as rconfig
from bellman_mpc_tpu.curves import device as rdev
from bellman_mpc_tpu.curves import rns_point as rrp
from bellman_mpc_tpu.groth16 import DUMMY
from bellman_mpc_tpu.groth16.bls12 import BLS12_381
from bellman_mpc_tpu.groth16.generator import lagrange_coeffs_at_tau as ref_lagrange
from bellman_mpc_tpu.parallel import worker as rworker
from bellman_mpc_tpu.r1cs import PolynomialDegreeTooLarge as RefTooLarge
from bellman_mpc_tpu_torch import benches, ffi
from bellman_mpc_tpu_torch import config as tconfig
from bellman_mpc_tpu_torch.curves import device as tdev
from bellman_mpc_tpu_torch.curves import rns_point as trp
from bellman_mpc_tpu_torch.groth16 import Bls12Engine, DummyEngine
from bellman_mpc_tpu_torch.groth16.generator import lagrange_coeffs_at_tau
from bellman_mpc_tpu_torch.parallel import Waiter, Worker, log2_floor
from bellman_mpc_tpu_torch.r1cs import PolynomialDegreeTooLarge
from bellman_mpc_tpu_torch.utils import logger, timed, trace

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

REF_MIMC = importlib.import_module("bellman_mpc_tpu.models.mimc")
PORT_MIMC = importlib.import_module("bellman_mpc_tpu_torch.models.mimc")
RF, TF = rrp.default_rns_field(), trp.default_rns_field()
P = RF.p


# -------------------------------------------------------------------- config
@pytest.mark.parametrize("env", [
    {},
    {"BMT_MSM_STRATEGY": "pippenger", "BMT_PIPPENGER_C": "12", "BMT_MESH_SHAPE": "4,2"},
    {"BMT_NUM_THREADS": "3", "BMT_DETERMINISTIC": "0", "BMT_MSM_STRATEGY": "rns"},
])
def test_config_from_env(monkeypatch, env):
    for k in ("BMT_NUM_THREADS", "BMT_MSM_STRATEGY", "BMT_PIPPENGER_C", "BMT_MESH_SHAPE",
              "BMT_DETERMINISTIC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = tconfig.Config.from_env()
    assert dataclasses.asdict(got) == dataclasses.asdict(rconfig.Config.from_env())
    assert [f.name for f in dataclasses.fields(tconfig.Config)] == [
        f.name for f in dataclasses.fields(rconfig.Config)]
    if env.get("BMT_MESH_SHAPE"):
        assert got.mesh_shape == (4, 2) and got.pippenger_c == 12 and got.deterministic
    monkeypatch.setattr(tconfig, "_config", None)
    assert tconfig.get_config() == got and tconfig.get_config() is tconfig.get_config()


# -------------------------------------------------------------------- worker
def test_log2_floor():
    # multicore.rs:133-143 test values, then the reference's function on 1..4096
    assert [log2_floor(n) for n in (1, 2, 3, 4, 15)] == [0, 1, 1, 2, 3]
    assert [log2_floor(n) for n in range(1, 4097)] == [rworker.log2_floor(n) for n in range(1, 4097)]
    assert Worker(num_threads=6).log_num_threads() == 2


def test_worker_scope_and_compute():
    w = Worker(num_threads=4)
    results = [0] * 100
    with w.scope(100) as (scope, chunk):
        assert chunk == 25
        for start in range(0, 100, chunk):
            def job(s=start):
                for i in range(s, min(s + chunk, 100)):
                    results[i] = i * i
            scope.spawn(job)
    assert results == [i * i for i in range(100)]

    waiter = w.compute(lambda: sum(range(1000)))
    assert waiter.wait() == 499500
    assert waiter.done()
    assert w.map_chunked(list(range(10)), lambda x: x + 1) == list(range(1, 11))


def test_waiter_wait_inside_pool_guard():
    """multicore.rs:100-108: joining a pending Waiter from a pool worker
    thread is a deadlock hazard and must raise."""
    w = Worker(num_threads=2)
    release = threading.Event()
    slow = w.compute(lambda: release.wait(5))

    def misuse():
        try:
            slow.wait()  # pending + called from pool thread -> guard fires
            return None
        except RuntimeError as e:
            return e

    err_waiter = w.compute(misuse)
    err = err_waiter.wait()
    release.set()
    assert isinstance(err, RuntimeError) and "worker thread" in str(err)
    assert slow.wait() is True  # main-thread wait stays legal
    # waiting on an already-done future from a pool thread is fine too
    done = w.compute(lambda: 7)
    done.wait()
    assert w.compute(lambda: done.wait()).wait() == 7
    assert isinstance(done, Waiter)


def test_worker_backpressure():
    """At most 4x the thread count of jobs in flight (multicore.rs:18): the
    ninth compute on a 2-thread worker blocks until one job ends."""
    w = Worker(num_threads=2)
    release = threading.Event()
    jobs = [w.compute(lambda: release.wait(10)) for _ in range(8)]
    ninth = threading.Thread(target=lambda: jobs.append(w.compute(lambda: 9)))
    ninth.start()
    ninth.join(0.3)
    assert ninth.is_alive() and len(jobs) == 8
    release.set()
    ninth.join(10)
    assert not ninth.is_alive() and jobs[-1].wait() == 9


# ----------------------------------------------------------------------- ffi
def test_ffi_surface():
    assert ffi.test_bellman() is None  # no-op
    # process() is slow by design (50M increments); just check it's callable
    assert callable(ffi.process)


# ------------------------------------------------------------------ MiMC helpers
@pytest.fixture
def mimc_100(monkeypatch):
    """Both packages' helpers draw their round constants from mimc_constants
    (field, seed); cut them to 100 rounds in both."""
    for mod in (REF_MIMC, PORT_MIMC):
        orig = mod.mimc_constants
        monkeypatch.setattr(mod, "mimc_constants",
                            lambda field, seed=42, orig=orig: orig(field, seed, rounds=100))


def test_neo_create_parameters_mock_too_large():
    with pytest.raises(RefTooLarge):
        REF_MIMC.neo_create_parameters(DUMMY)
    with pytest.raises(PolynomialDegreeTooLarge):
        PORT_MIMC.neo_create_parameters(DummyEngine("cpu"))
    with pytest.raises(PolynomialDegreeTooLarge):
        ffi.test_create_parameters(DummyEngine("cpu"))


def test_neo_create_parameters_matches_reference(mimc_100):
    ref_params, ref_constants = REF_MIMC.neo_create_parameters(DUMMY, seed=7)
    params, constants = PORT_MIMC.neo_create_parameters(DummyEngine("cpu"), seed=7)
    assert constants == ref_constants and len(constants) == 100
    assert dataclasses.asdict(params.vk) == dataclasses.asdict(ref_params.vk)
    for name in ("h", "l", "a", "b_g1", "b_g2"):
        assert getattr(params, name) == getattr(ref_params, name), name
    assert ffi.test_create_parameters(DummyEngine("cpu")) == PORT_MIMC.neo_create_parameters(
        DummyEngine("cpu"))[0]


def test_timed_prove_verify_mock(mimc_100):
    out = PORT_MIMC.timed_prove_verify(DummyEngine("cpu"), samples=2)
    assert len(out) == 2 and all(isinstance(t, float) and t > 0 for t in out)


# ----------------------------------------------------------------- profiling
def test_trace_writes_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).add_(1)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())
    assert any(e.key == "aten::add_" for e in prof.key_averages())


def test_timed_logs_name(caplog):
    caplog.set_level(logging.INFO, logger=logger.name)
    with timed("block under test"):
        torch.ones(4).sum()
    assert logger.name == "bellman_mpc_tpu_torch"
    assert any(r.getMessage().startswith("block under test: ") for r in caplog.records)


# ------------------------------------------------------------ parity helpers
def _vals(n, seed):
    rng = random.Random(seed)
    return [0, 1, P - 1] + [rng.randrange(P) for _ in range(n - 3)]


def _same(r, t):
    return np.array_equal(np.asarray(r), t.numpy())


def test_rns_double_and_mul_const():
    xs = _vals(8, 1)
    r, t = RF.encode(xs), TF.encode(xs)
    rd, td = r.double(), t.double()
    assert _same(rd.res, td.res) and rd.a == td.a == 2
    assert TF.decode(td) == [2 * x % P for x in xs]
    c = random.Random(2).randrange(P) * TF.M % P  # c*M preserves the M-residue form
    rm, tm = RF.mul_const(r, c), TF.mul_const(t, c)
    assert _same(rm.res, tm.res) and rm.a == tm.a
    assert TF.decode(tm) == [x * c * pow(TF.M, -1, P) % P for x in xs]


def test_rns_select_and_is_zero_exact():
    xs, ys = _vals(6, 3), _vals(6, 4)
    cond = [True, False, True, False, False, True]
    rs = RF.select(jnp.asarray(cond)[None], RF.encode(xs), RF.encode(ys).double())
    ts = TF.select(torch.tensor(cond)[None], TF.encode(xs), TF.encode(ys).double())
    assert _same(rs.res, ts.res) and rs.a == ts.a == 2
    assert TF.decode(ts) == [x if c else 2 * y % P for x, y, c in zip(xs, ys, cond)]
    zs = [0, 5, 0, P - 1, P]
    rz, tz = RF.encode(zs, mont=False), TF.encode(zs, mont=False)
    assert list(np.asarray(RF.is_zero_exact(rz))) == tz_list(TF.is_zero_exact(tz))
    assert tz_list(TF.is_zero_exact(tz)) == [True, False, True, False, True]


def tz_list(t):
    return [bool(v) for v in t.tolist()]


def _limbs(f, vals):
    return np.asarray([[(v >> (11 * i)) & 0x7FF for v in vals] for i in range(f.L)], np.int32)


def test_dev_fp_eq():
    """Lazy limbs in [0, 2p): x and x + p are equal, x and y are not."""
    rng = random.Random(5)
    x, y = rng.randrange(P), rng.randrange(P)
    a = [x, x, x, 0, P - 1, y]
    b = [x, x + P, y, P, 2 * P - 1, y + P]
    want = [True, True, False, True, True, True]
    la, lb = _limbs(rdev.fp_ops.f, a), _limbs(rdev.fp_ops.f, b)
    got = tdev.fp_ops.eq(torch.from_numpy(la), torch.from_numpy(lb))
    assert tz_list(got) == [bool(v) for v in np.asarray(rdev.fp_ops.eq(jnp.asarray(la), jnp.asarray(lb)))]
    assert tz_list(got) == want
    # Fp2: (L, 2, n), equal only where both components are
    a2 = np.stack([la, la], axis=1)
    b2 = np.stack([lb, _limbs(rdev.fp_ops.f, [x, y, x, 0, P - 1, y])], axis=1)
    got2 = tdev.fp2_ops.eq(torch.from_numpy(a2), torch.from_numpy(b2))
    ref2 = rdev.fp2_ops.eq(jnp.asarray(a2), jnp.asarray(b2))
    assert tz_list(got2) == [bool(v) for v in np.asarray(ref2)]
    assert tz_list(got2) == [True, False, False, True, True, True]


@pytest.mark.parametrize("m", [8, 16])
def test_lagrange_coeffs_at_tau(m):
    tau = 2 if m == 8 else 12345
    got = lagrange_coeffs_at_tau(Bls12Engine("cpu"), m, tau)
    assert got == ref_lagrange(BLS12_381, m, tau)
    # sum_i L_i(tau) x_i^k = tau^k on the domain
    host = BLS12_381.fr_host
    w = host.nth_root_of_unity(m.bit_length() - 1)
    assert sum(L * pow(w, 3 * i, host.p) for i, L in enumerate(got)) % host.p == pow(tau, 3, host.p)


# -------------------------------------------------------------------- benches
def test_benches_main_selects(monkeypatch):
    calls = []
    for name in ("batch_verify", "multiexp", "ntt", "pairing", "scaling"):
        monkeypatch.setattr(benches, f"bench_{name}", lambda quick, name=name: calls.append((name, quick)))
    benches.main([])
    assert calls == [(n, False) for n in ("batch_verify", "multiexp", "ntt", "pairing")]
    calls.clear()
    benches.main(["--quick", "pairing", "ntt"])
    assert calls == [("ntt", True), ("pairing", True)]
    calls.clear()
    benches.main(["scaling"])
    assert calls == [("scaling", False)]


def test_bench_scaling_raises(capsys, monkeypatch):
    """bench_scaling at quick over two logical CPU shards prints the d = 1
    and d = 2 lines with the reference's keys; each timed call gets a
    (1, d) mesh over the given devices, the first 64 d table columns and
    digits of two proofs.  The sharded MSM itself is held against the host
    oracle in tests/test_torch_sharded.py, so here it is a recorder (and
    the table build a placeholder of the right shape): the harness alone."""
    from bellman_mpc_tpu_torch.ops import msm
    from bellman_mpc_tpu_torch.parallel import sharded

    calls = []
    monkeypatch.setattr(msm, "window_tables_affine", lambda ops, pts, c: tuple(
        torch.zeros(pts[0].shape[:-1] + (64, 9, pts[0].shape[-1]), dtype=torch.int32) for _ in range(2)))
    monkeypatch.setattr(sharded, "sharded_msm_table_affine", lambda mesh, ops, tables, sd: calls.append(
        (mesh.shape, [str(d) for row in mesh.grid for d in row], tables[0].shape[-1], tuple(sd.shape))))
    benches.bench_scaling(True, devices=["cpu"] * 2)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["devices"] for x in lines] == [1, 2]
    for x in lines:
        assert set(x) == {"bench", "value", "unit", "devices", "n_total", "n_per_device", "time_s",
                          "efficiency_time", "efficiency_rate", "compile_s", "device"}
        assert x["bench"] == "sharded_table_msm_weak_scaling" and x["unit"] == "points/s"
        assert x["n_total"] == 64 * x["devices"] and x["n_per_device"] == 64 and x["device"] == "cpu"
    assert lines[0]["efficiency_time"] == lines[0]["efficiency_rate"] == 1.0
    assert calls == [({"data": 1, "model": 1}, ["cpu"], 64, (65, 2, 64))] * 4 + [
        ({"data": 1, "model": 2}, ["cpu", "cpu"], 128, (65, 2, 128))] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benches.bench_scaling(True)


def test_bench_ntt_quick_cpu(capsys):
    benches.bench_ntt(True, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert {"bench", "value", "unit", "n", "total_s"} <= set(line)
    assert line["bench"] == "ntt_fr" and line["unit"] == "butterflies/s"
    assert line["n"] == 1024 and line["value"] > 0 and line["device"] == "cpu"
