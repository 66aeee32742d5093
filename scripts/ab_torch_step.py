"""Step and kernel times of two checkouts of the PyTorch port, side by side
on one card.

One worker process per checkout builds that checkout's kernels and runs
chip_smoke.py's main-path configuration (MiMC-322, constants seed 42,
BatchProver "rns", B = 16 witnesses from seed 0); both stay resident on the
card.  Each worker first counts one step's kernel launches and, with
torch.profiler, its PyTorch (aten) ops.  The workers then take turns: in
each round every checkout times one step (`BatchProver.step`, synchronised,
host clock), the decode of that step's output (`BatchProver.decode`) and
then its kernels, the base first in even rounds and the other checkout first
in odd rounds, while the worker not being timed waits on its pipe.
Kernels: K1 and K2 on gathered table points
(chip_smoke.fold_window_cases), K3 on (71, 16384) random residues and K4
on (24, 8192) and (24, 16384) Fr limbs (chip_smoke.lazy_limbs), each as its
device time from CUDA graph replays (chip_smoke.graph_time_ms; K4 with 20
calls per graph) and as its eager time (chip_smoke.cuda_time_ms, which also
carries the wrapper's Python).  Last, each checkout makes one sequential
proof (`create_random_proof` of witness 0), timed.  Before any timing, both
checkouts must give the same step output, the same decoded proofs and the
same kernel outputs, bit for bit; their launch counts are reported, not
compared, since a change may route work through other kernels.

    git archive <commit> | tar -x -C trees/base   # a directory .gitignore lists
    python3 scripts/ab_torch_step.py --base trees/base [--rounds 10]

`--device cpu --mimc-rounds 8 --rounds 2` runs the same protocol on the CPU
at a small size (the kernels' plain versions; no kernel times), as a quick
check of the script itself.  Prints one line per timed turn, the card's
name and power limit, and last a JSON summary (also written to
chiprun_out/ab_torch_step.json); workers' logs go to chiprun_out/ too.
Imports nothing of JAX and nothing of the JAX package.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"
K3_LANES = 16384
K4_LANES = (8192, 16384)
REPS = 50


def _chip_smoke():
    """This checkout's chip_smoke.py, whichever checkout's package is imported."""
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(obj) -> str:
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        else:
            h.update(x.detach().cpu().contiguous().numpy().tobytes())

    walk(obj)
    return h.hexdigest()


def worker(tree: str, device: str, mimc_rounds: int) -> int:
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)  # anything the package prints goes to the log, not the pipe
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import bellman_mpc_tpu_torch as pkg

    assert Path(pkg.__file__).resolve().is_relative_to(Path(tree).resolve()), pkg.__file__
    from bellman_mpc_tpu_torch.curves import rns_point as rpt
    from bellman_mpc_tpu_torch.fields.bls12_381 import fr
    from bellman_mpc_tpu_torch.groth16 import Bls12Engine, create_random_proof, generate_random_parameters
    from bellman_mpc_tpu_torch.models import MiMCDemo, mimc_constants
    from bellman_mpc_tpu_torch.ops import fold_kernels as fk
    from bellman_mpc_tpu_torch.ops import kernel_lib as kl
    from bellman_mpc_tpu_torch.ops.mont_kernels import mont_mul
    from bellman_mpc_tpu_torch.parallel import BatchProver

    cs = _chip_smoke()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if not cuda:  # two workers' default thread pools starve each other on the CPU
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    if cuda:
        kl.build()
    engine = Bls12Engine(dev)
    constants = mimc_constants(engine.fr_host, seed=42, rounds=mimc_rounds)
    params = generate_random_parameters(engine, MiMCDemo(constants))
    bp = BatchProver(engine, params, MiMCDemo(constants, 0, 0), msm_strategy="rns")
    prng = random.Random(0)
    circuits = [MiMCDemo(constants, prng.randrange(engine.fr_host.p), prng.randrange(engine.fr_host.p))
                for _ in range(cs.B_PROOFS)]
    args = bp.encode_circuits(circuits)
    kl.reset_launch_counts()
    out = bp.step(*args)
    sync()
    counts = dict(kl.launch_counts)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        bp.step(*args)
        sync()
    ops = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    rng = random.Random(2024)
    cases = {name: kern for name, (_, kern, _) in cs.fold_window_cases(bp, rng).items()}
    f = rpt.default_rns_field()
    xs = f.encode([rng.randrange(f.p) for _ in range(K3_LANES)], device=dev).res
    ys = f.encode([rng.randrange(f.p) for _ in range(K3_LANES)], device=dev).res
    cases["rns_mul_many"] = lambda: fk.rns_mul_many(f, xs, ys)
    for lanes in K4_LANES:
        a4, b4 = (cs.lazy_limbs(fr, lanes, rng, dev) for _ in range(2))
        cases[f"mont_mul_{lanes}"] = lambda a4=a4, b4=b4: mont_mul(fr, a4, b4)
    proofs = bp.decode(*out)
    proto.write(json.dumps({
        "ready_s": time.perf_counter() - t0, "launches": counts, "aten_ops_per_step": ops,
        "step": _digest(out), "proofs": repr(proofs),
        "kernels": {name: _digest(kern()) for name, kern in cases.items()},
    }) + "\n")
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "step":
            sync()
            t0 = time.perf_counter()
            bp.step(*args)
            sync()
            reply = {"step_s": time.perf_counter() - t0}
        elif cmd == "decode":
            sync()
            t0 = time.perf_counter()
            bp.decode(*out)
            sync()
            reply = {"decode_s": time.perf_counter() - t0}
        elif cmd == "kernels":
            reply = {name: {"ms": cs.graph_time_ms(kern, REPS, 20 if name.startswith("mont_mul") else 1)
                            if cuda else None,
                            "eager_ms": cs.cuda_time_ms(kern, REPS) if cuda else None}
                     for name, kern in cases.items()}
        elif cmd == "sequential":
            t0 = time.perf_counter()
            seq = create_random_proof(engine, circuits[0], params)
            sync()
            reply = {"sequential_proof_s": time.perf_counter() - t0, "equals_batch_proof_0": seq == proofs[0]}
        else:
            break
        proto.write(json.dumps(reply) + "\n")
    return 0


def _spread(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": statistics.median(xs), "quartiles": [q[0], q[2]], "min": min(xs), "max": max(xs),
            "all": xs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mimc-rounds", type=int, default=322)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        return worker(a.worker, a.device, a.mimc_rounds)
    import torch

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("ab_torch_step: no CUDA device available", file=sys.stderr)
        return 1
    if not a.base or not (Path(a.base) / "bellman_mpc_tpu_torch").is_dir():
        print("ab_torch_step: --base must be the root of a checkout of the port", file=sys.stderr)
        return 1
    smi = None
    if a.device.startswith("cuda"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, check=True).stdout.strip()
    OUT.mkdir(exist_ok=True)
    trees = {"base": str(Path(a.base).resolve()), "change": str(ROOT)}
    procs, logs = {}, {}
    for name, tree in trees.items():
        logs[name] = open(OUT / f"ab_torch_step.{name}.log", "w")
        procs[name] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker", tree, "--device", a.device,
             "--mimc-rounds", str(a.mimc_rounds)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=logs[name], text=True, cwd=tree)

    def recv(name):
        line = procs[name].stdout.readline()
        if not line:
            raise RuntimeError(f"the {name} worker ended (see {logs[name].name})")
        return json.loads(line)

    def ask(name, cmd):
        procs[name].stdin.write(cmd + "\n")
        procs[name].stdin.flush()
        return recv(name)

    try:
        ready = {name: recv(name) for name in trees}
        print(json.dumps({"ready": ready}), flush=True)
        for key in ("step", "proofs", "kernels"):
            assert ready["base"][key] == ready["change"][key], f"the checkouts differ in {key}"
        turns = []
        for r in range(a.rounds):
            for name in (("base", "change") if r % 2 == 0 else ("change", "base")):
                turn = {"round": r, "tree": name, **ask(name, "step"), **ask(name, "decode"),
                        "kernels": ask(name, "kernels")}
                turns.append(turn)
                print(json.dumps(turn), flush=True)
        sequential = {name: ask(name, "sequential") for name in trees}
        print(json.dumps({"sequential": sequential}), flush=True)
        assert all(v["equals_batch_proof_0"] for v in sequential.values()), sequential
    finally:
        for name, p in procs.items():
            if p.poll() is None:
                p.stdin.close()
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            logs[name].close()
    # per metric: each checkout's spread over the rounds, and in how many
    # rounds (one pair each) the change read lower than the base
    summary = {"trees": trees, "rounds": a.rounds, "device": smi or a.device,
               "launches": {name: ready[name]["launches"] for name in trees},
               "aten_ops_per_step": {name: ready[name]["aten_ops_per_step"] for name in trees},
               "sequential_proof_s": {name: sequential[name]["sequential_proof_s"] for name in trees},
               "metrics": {}}
    keys = [("step_s",), ("decode_s",)] + [(k, fld) for k in turns[0]["kernels"] for fld in ("ms", "eager_ms")]
    for key in keys:
        per = {name: [t[key[0]] if len(key) == 1 else t["kernels"][key[0]][key[1]]
                      for t in turns if t["tree"] == name] for name in trees}
        if None in per["base"]:
            continue
        summary["metrics"][".".join(key)] = {
            **{name: _spread(v) for name, v in per.items()},
            "rounds_change_lower": sum(c < b for b, c in zip(per["base"], per["change"]))}
    (OUT / "ab_torch_step.json").write_text(json.dumps(summary, indent=1))
    if smi:
        print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
