"""A whole run on the CPU at a tiny size: the port's BatchProver proves a
MiMC cell's batches through run.run, the reference accepts them, and with
the timed path broken underneath (faults.py: the control and each fault
the cells can have) `correct` comes out false."""

import io
import json
import random
import shutil

import pytest
import torch

import faults
import run
from reference import groth16 as rg

BENCH = __import__("conftest").BENCH
ROOT = BENCH.parent


class RnsProver(run.Prover):
    msm_strategy = "rns"  # the fastest strategy on the CPU


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A MiMC cell of 4 rounds, B = 2, pool 2, and one set-up for every run
    (each run gets the BatchProver back with no fault planted)."""
    tmp = tmp_path_factory.mktemp("bench")
    shutil.copytree(BENCH, tmp / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp / "bench_port"
    cfg = json.loads((b / "configs" / "mimc322.json").read_text())
    cfg.update(name="mimc-tiny", rounds=4)
    (b / "configs" / "mimc-tiny.json").write_text(json.dumps(cfg))
    for suffix in (".py", "_ref.py"):
        shutil.copy(b / "configs" / f"mimc322{suffix}", b / "configs" / f"mimc-tiny{suffix}")
    (b / "traffic" / "closed-b2-pool2.json").write_text(json.dumps({"loop": "closed", "in_flight": 1,
                                                                    "batch": 2, "pool": 2}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": "mimc-tiny.b2", "config": "mimc-tiny", "traffic": "closed-b2-pool2",
                          "chips": 1, "why": "a tiny cell for the CPU"}]
    spec_path = tmp / "BENCHMARK.json"
    spec_path.write_text(json.dumps(spec))
    cell = run.Cell("mimc-tiny.b2", bench_dir=b, spec_path=spec_path)
    built = {}

    def make(cell_, seed, device, spans, sync):
        if seed not in built:
            built[seed] = (RnsProver(cell_, seed, device, spans, sync), dict(spans))
        prover, first_spans = built[seed]
        for attr in ("step", "_msm"):
            prover.bp.__dict__.pop(attr, None)
        spans.update(first_spans)
        return prover

    return cell, make


SEED = 2 ** 31 + 12345


def _result(cell, make, fault=None):
    out = io.StringIO()
    maker = make if fault is None else faults.faulty_prover(fault, make)
    assert run.run(cell, SEED, 0, False, device=torch.device("cpu"), out=out, make_prover=maker) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct(tiny):
    res = _result(*tiny)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 2
    assert res["check"] == {"proofs_failed": [0, 0]}
    assert set(res["metrics"]) == {"proofs_per_s", "setup_s"}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_broken_timed_path_is_not_correct(tiny, fault):
    res = _result(*tiny, fault=fault)
    assert not res["correct"] and res["failed"] >= 1


def test_batch_proofs_accepted_and_flipped_byte_rejected(tiny):
    cell, make = tiny
    spans = {}
    prover = make(cell, SEED, torch.device("cpu"), spans, lambda: None)
    raws = prover.iterate(1)
    inputs = [cell.reference.public_inputs(cell.config, w) for w in prover.witnesses[1]]
    k = rg.input_scalars(cell.reference.circuit(cell.config), prover.toxic)
    assert rg.verify(list(zip(raws, inputs)), prover.toxic, k, random.Random(1)) == [True, True]
    for pos in (5, 60, 150):
        bad = bytearray(raws[0])
        bad[pos] ^= 1
        assert rg.verify([(bytes(bad), inputs[0]), (raws[1], inputs[1])], prover.toxic, k,
                         random.Random(1)) == [False, True]
    assert rg.verify([(raws[0], inputs[1])], prover.toxic, k, random.Random(1)) == [False]
