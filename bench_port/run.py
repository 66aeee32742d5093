#!/usr/bin/env python3
"""The port's benchmark: batched Groth16 proving on CUDA cards.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process.  It reads the cell from BENCHMARK.json at the root
of the checkout, then finds everything by name: the configuration's sizes
(`configs/<config>.json`), its circuit for the program (`configs/<config>.py`)
and for the reference (`configs/<config>_ref.py`), the traffic
(`traffic/<traffic>.json`) and each per-layer metric's reader
(`metrics/<metric>.py`).  A later cell, configuration or metric is files
and an entry in BENCHMARK.json; nothing here changes.

Set-up (the `setup_s` clock runs from the process's start to the first
timed iteration): load or build the port's CUDA and C libraries, draw the
toxic waste and the witnesses from the seed, make the CRS with the port's
`generate_parameters`, build `BatchProver` with its defaults, encode the
traffic's pool of witness batches (synthesis and wire bytes to the card),
and run one warm-up iteration per pooled batch.  The window: iterations
of `step` then `decode` over the pooled batches in turn, each ending in
the batch's proofs serialized to 192 bytes, until the clock passes
--seconds; `proofs_per_s` is the proofs of all iterations over the time
from the first one's start to the last one's end.  With --trace 1 the
window profiles two steady iterations and the per-layer metrics are read.

After the window: the peak memory is read, the program's state freed, and
every proof of the window judged by the plain reference (reference/):
each distinct proof (a pooled batch proves the same bytes each time it
comes round) is verified against the verifying key worked out again from
the seed and the frozen circuit, and the public inputs worked out from the
witnesses.  `correct` holds when no proof fails.  The numbers compared go
to standard error as the last lines and into the result's `check` key;
the result is the last line of standard output.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse
import importlib.util
import json
import random
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bellman_mpc_tpu")
PROFILED_ITERATIONS = 2


class RunError(RuntimeError):
    """The run cannot give a result: its exit code is not 0."""


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_PROCESS:8.2f} s] {msg}", file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise RunError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Cell:
    """One workload of BENCHMARK.json with its files, found by name."""

    def __init__(self, name: str, bench_dir: Path = HERE, spec_path: Optional[Path] = None):
        for p in (str(ROOT), str(HERE)):
            if p not in sys.path:
                sys.path.insert(0, p)
        spec = json.loads((spec_path or bench_dir.parent / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise RunError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = cells[name]
        self.name = name
        self.chips = int(self.spec["chips"])
        self.config_name = self.spec["config"]
        cfgdir = bench_dir / "configs"
        self.config = json.loads((cfgdir / f"{self.config_name}.json").read_text())
        self.program = load_module(cfgdir / f"{self.config_name}.py", f"bench_config_{self.config_name}")
        self.reference = load_module(cfgdir / f"{self.config_name}_ref.py", f"bench_config_{self.config_name}_ref")
        self.traffic = json.loads((bench_dir / "traffic" / f"{self.spec['traffic']}.json").read_text())
        if self.traffic["loop"] != "closed" or self.traffic["in_flight"] != 1:
            raise RunError("the generator runs closed loops with one batch in flight")
        self.batch = int(self.traffic["batch"])
        self.pool = int(self.traffic["pool"])

        def for_cell(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in spec["end_to_end"] if for_cell(m)]
        self.per_layer = [m for m in spec["per_layer"] if for_cell(m)]
        self.readers = {m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py", f"bench_metric_{m['name']}")
                        for m in self.per_layer}


def device_info(torch, chips: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def require_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the card and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, {torch.cuda.device_count()} are present")


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


class Prover:
    """The system under test: the port's CRS, BatchProver and pooled
    batches for one cell and seed."""

    msm_strategy = "auto"  # BatchProver's default; the CPU tests take "rns", the fastest there

    def __init__(self, cell: Cell, seed: int, device, spans: Dict[str, float], sync):
        from bellman_mpc_tpu_torch import native
        from bellman_mpc_tpu_torch.groth16 import Bls12Engine, generate_parameters
        from bellman_mpc_tpu_torch.ops import kernel_lib
        from bellman_mpc_tpu_torch.parallel import BatchProver

        t = time.perf_counter()
        if device.type == "cuda":
            kernel_lib.load()
        native.available()
        spans["load_s"] = time.perf_counter() - t

        from reference.groth16 import draw_toxic_waste

        self.toxic = draw_toxic_waste(random.Random(f"{seed}:toxic waste"))
        wrng = random.Random(f"{seed}:witnesses")
        self.witnesses = [cell.reference.draw_witnesses(cell.config, wrng, cell.batch) for _ in range(cell.pool)]
        engine = Bls12Engine(device)
        cfg = cell.config

        t = time.perf_counter()
        tx = self.toxic
        self.params = generate_parameters(engine, cell.program.circuits(cfg, [None])[0], engine.g1.generator(),
                                          engine.g2.generator(), tx["alpha"], tx["beta"], tx["gamma"], tx["delta"],
                                          tx["tau"])
        sync()
        spans["crs_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.bp = BatchProver(engine, self.params, cell.program.circuits(cfg, self.witnesses[0][:1])[0],
                              msm_strategy=self.msm_strategy)
        sync()
        spans["build_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.batches = [self.bp.encode_circuits(cell.program.circuits(cfg, w)) for w in self.witnesses]
        sync()
        spans["encode_s"] = time.perf_counter() - t

    def iterate(self, k: int) -> List[bytes]:
        """One timed iteration on pooled batch k: step, decode, serialize."""
        from bellman_mpc_tpu_torch.groth16 import proof_to_bytes

        return [proof_to_bytes(p) for p in self.bp.decode(*self.bp.step(*self.batches[k]))]

    def table_entries(self) -> Dict[int, int]:
        """Bases of each RNS table -> the points per base of one window."""
        return {n: (1 << (c - 1)) + 1 for _, n, c, _ in self.bp.table_info()}


def judge(cell: Cell, seed: int, toxic, witnesses, outputs) -> Dict[str, int]:
    """The window's proofs against the plain reference: every distinct
    (batch, position, bytes) verified once and counted as often as it came;
    a proof missing from an iteration counts as failed."""
    from reference.groth16 import input_scalars, verify

    t = time.perf_counter()
    k = input_scalars(cell.reference.circuit(cell.config), toxic)
    inputs = [[cell.reference.public_inputs(cell.config, w) for w in batch] for batch in witnesses]
    seen = Counter((pool_k, j, raws[j] if j < len(raws) else b"")
                   for pool_k, raws in outputs for j in range(cell.batch))
    keys = list(seen)
    verdicts = verify([(raw, inputs[pool_k][j]) for pool_k, j, raw in keys], toxic, k,
                      random.Random(f"{seed}:verifier weights"))
    failed = sum(seen[key] for key, ok in zip(keys, verdicts) if not ok)
    log(f"reference: {len(keys)} distinct proofs of {sum(seen.values())} verified in "
        f"{time.perf_counter() - t:.2f} s")
    return {"attempted": sum(seen.values()), "failed": failed}


def check_lines(verdict: Dict) -> Dict[str, List[float]]:
    """The numbers compared, each with its limit: the proofs of the window
    that fail the reference's check, none allowed."""
    return {"proofs_failed": [verdict["failed"], 0]}


def timed_window(prover: Prover, cell: Cell, seconds: float, sync, profile=None):
    """Iterations over the pooled batches in turn until the clock passes
    `seconds`; with `profile` (a Tracer), iterations 1 to PROFILED_ITERATIONS
    run under it and the window lasts at least that long.  Returns
    (outputs as (batch, proof bytes) per iteration, seconds)."""
    outputs, ends = [], []
    sync()
    t0 = time.perf_counter()
    while True:
        it = len(outputs)
        k = it % cell.pool
        if profile is not None and 1 <= it <= PROFILED_ITERATIONS:
            with profile.iteration(it == 1, it == PROFILED_ITERATIONS):
                outputs.append((k, prover.iterate(k)))
        else:
            outputs.append((k, prover.iterate(k)))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds and (profile is None or len(outputs) > PROFILED_ITERATIONS):
            break
    sync()
    its = sorted(b - a for a, b in zip([0.0] + ends, ends))
    log(f"iteration seconds: min {its[0]:.4f}, median {its[len(its) // 2]:.4f}, max {its[-1]:.4f}")
    return outputs, time.perf_counter() - t0


def run(cell: Cell, seed: int, seconds: float, trace: bool, device=None, out=sys.stdout, make_prover=Prover) -> int:
    """One run of the cell; `device` None means the card, which has to be
    there.  Tests pass the CPU and a `make_prover` that reuses its set-up."""
    import torch

    if device is None:
        require_cards(torch, cell.chips)
        device = torch.device("cuda", 0)
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the allocator's statistics exist once it has run
        torch.cuda.reset_peak_memory_stats(0)
        log(f"{card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cuda = device.type == "cuda"
    if trace and not cuda:
        raise RunError("a traced run reads the card's trace")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans: Dict[str, float] = {}
    prover = make_prover(cell, seed, device, spans, sync)
    log("set-up spans: " + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))

    t = time.perf_counter()
    for k in range(cell.pool):
        prover.iterate(k)
    sync()
    spans["warmup_s"] = time.perf_counter() - t

    tracer = None
    if trace:
        from tracing import Tracer

        tracer = Tracer(sync)
    setup_s = time.perf_counter() - T_PROCESS
    outputs, window_s = timed_window(prover, cell, seconds, sync, tracer)
    log(f"window: {len(outputs)} iterations of {cell.batch} proofs in {window_s:.3f} s")

    memory = (device_info(torch, cell.chips) if cuda
              else {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0})
    if trace:
        from roofline import int32_ops_per_s
        from tracing import aten_ops

        ctx = {"spans": dict(spans), "proofs_encoded": cell.pool * cell.batch,
               "proofs_traced": PROFILED_ITERATIONS * cell.batch,
               "peak_bytes": memory["memory_peak_bytes"], "trace": tracer.reduced(),
               "launches": tracer.recorder.launches, "table_entries": prover.table_entries(),
               "int_rate": int32_ops_per_s(device.index or 0)}
        _, ctx["aten_ops_per_step"] = aten_ops(lambda: prover.bp.step(*prover.batches[0]))
        sync()
    toxic, witnesses = prover.toxic, prover.witnesses
    del prover
    if cuda:
        torch.cuda.empty_cache()

    bad = forbidden_modules()
    if bad:
        raise RunError(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}")

    verdict = judge(cell, seed, toxic, witnesses, outputs)
    checks = check_lines(verdict)
    correct = all(v <= lim for v, lim in checks.values())

    result = {"correct": correct, "attempted": verdict["attempted"], "failed": verdict["failed"]}
    if trace:
        result["metrics"] = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        memory.update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["window_s"])
        result["breakdown"] = {"device_ops": ctx["trace"]["device_ops"], "idle_gaps": ctx["trace"]["idle_gaps"]}
    else:
        values = {"proofs_per_s": len(outputs) * cell.batch / window_s, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = memory
    result["check"] = checks
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload)
        return run(cell, args.seed, args.seconds, bool(args.trace))
    except (RunError, ImportError) as e:
        print(f"bench_port: {e}", file=sys.stderr, flush=True)
        return 2


if __name__ == "__main__":
    sys.exit(main())
