"""Step times of the rns BatchProver and its opt-ins, side by side on one card.

Builds chip_smoke.py's main-path configuration (MiMC-322, constants seed 42,
B = 16 witnesses from seed 0) once per configuration: rns, and rns under
chip_smoke.OPT_INS (BMT_GLV=1, BMT_MERGE_G1=1, both), all resident on the
card, and checks that each gives the rns proofs.  Then, for --rounds
rounds, it times one step of each configuration (`BatchProver.step`,
synchronised, host clock), the order rotated every round, and reports each
one's median, quartiles and range, and per opt-in the rounds in which its
step beat rns's step of the same round.  Last, per configuration, one
step's aten operator calls (chip_smoke.step_ops) and, on the card, one
step under torch.profiler: the device's busy time (the CUDA kernel and
memory events summed) and its idle share beside the median step.

    python3 opt_ins_step.py [--rounds 10]

`--device cpu --mimc-rounds 8 --rounds 2` runs the same protocol on the CPU
at a small size (no device time), as a quick check of the script itself.
Prints one line per configuration, the card's name and power limit, and
last a JSON summary.
Imports nothing of JAX and nothing of the JAX package.
"""

import argparse
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def device_busy_ms(bp, args) -> float:
    """Device time of one step: every CUDA kernel, memcpy and memset event
    torch.profiler records, summed."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        bp.step(*args)
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3


def quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2], "min": min(xs), "max": max(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mimc-rounds", type=int, default=322)
    opts = ap.parse_args()
    import torch

    from bellman_mpc_tpu_torch.groth16 import Bls12Engine, generate_random_parameters
    from bellman_mpc_tpu_torch.models import MiMCDemo, mimc_constants
    from bellman_mpc_tpu_torch.parallel import BatchProver

    on_card = opts.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("opt_ins_step: no CUDA device available", file=sys.stderr)
        return 1
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    engine = Bls12Engine("cuda:0" if on_card else "cpu")
    host = engine.fr_host
    constants = mimc_constants(host, seed=42, rounds=opts.mimc_rounds)
    params = generate_random_parameters(engine, MiMCDemo(constants))
    prng = random.Random(0)
    circuits = [MiMCDemo(constants, prng.randrange(host.p), prng.randrange(host.p)) for _ in range(cs.B_PROOFS)]
    configs = {"rns": {}, **cs.OPT_INS}
    provers, want = {}, None
    for name, env in configs.items():
        with cs.environ(**env):
            bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), msm_strategy="rns")
        args = bp.encode_circuits(circuits)
        proofs = bp.decode(*bp.step(*args))
        want = want or proofs
        assert proofs == want, f"{name}: proofs differ from rns's"
        provers[name] = (bp, args)
    names = list(configs)
    times = {name: [] for name in names}
    for r in range(opts.rounds):
        for name in names[r % len(names):] + names[: r % len(names)]:
            bp, args = provers[name]
            sync()
            t0 = time.perf_counter()
            bp.step(*args)
            sync()
            times[name].append(time.perf_counter() - t0)
    summary = {"rounds": opts.rounds, "device": str(engine.device), "configs": {}}
    for name in names:
        bp, args = provers[name]
        row = {"step_s": quartiles(times[name]), "steps_s": times[name],
               "aten_ops_step": cs.step_ops(bp, args)["aten_ops"] if on_card else None}
        if name != "rns":
            row["wins_over_rns"] = sum(t < t0 for t, t0 in zip(times[name], times["rns"]))
        if on_card:
            busy = device_busy_ms(bp, args)
            row.update(device_busy_ms=busy, idle_share=1 - busy / 1e3 / row["step_s"]["median"])
        summary["configs"][name] = row
        print(f"{name}: " + json.dumps(row), flush=True)
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, check=True).stdout.strip()
        summary["card"] = smi
        print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
