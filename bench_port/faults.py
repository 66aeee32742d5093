#!/usr/bin/env python3
"""The check's control and the faults it has to catch, planted under a run.

    python3 bench_port/faults.py --workload <cell> --fault <name> --seeds <n> [<n> ...] [--seconds <s>]

Each seed is a whole run of the cell (run.run: set-up, warm-up, window,
judgement) in this one process, with the timed path broken underneath by
patching the BatchProver that set-up built; it prints one line per seed
with the run's `correct` and the numbers compared.  The benchmark's own
runs never import this file.

* `control`: the check's control.  The configuration states no precision
  (the arithmetic is exact), so the control breaks the guarantee it does
  state: each proof attests its statement.  The step leaves out the h(x)
  MSM (the H query's term of C), the largest single piece of its work and
  the one a faster prover would be tempted to cut.
* `stale`: a step that returns its state unchanged: each step hands back
  the proofs the step before it left (a double buffer read one step late);
  the pool's batches alternate, so those prove other statements.
* `half`: half of the batch left out: the step proves the first B/2
  witnesses only.
* `altered`: an answer altered where it is produced: the step's first two
  A points are swapped.
The cells run on one card, so no exchange between cards can be left out.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402

FAULTS = ("control", "stale", "half", "altered")


def plant(fault: str, bp) -> None:
    """Break `bp` (a BatchProver) by `fault`, through its instance only."""
    if fault == "control":
        from bellman_mpc_tpu_torch.curves.device import point_identity

        msm = bp._msm

        def msm_without_h(grp, crs, bits):
            out = msm(grp, crs, bits)
            if crs is bp.crs_h:
                return point_identity(grp.ops, tuple(out[0].shape[1:]), out[0].device)
            return out

        bp._msm = msm_without_h
    elif fault == "stale":
        step, state = bp.step, []

        def stale_step(*args):
            state.append(step(*args))
            return state.pop(0) if len(state) > 1 else state[0]

        bp.step = stale_step
    elif fault == "half":
        step = bp.step

        def half_step(*args):
            return step(*(x[: x.shape[0] // 2] for x in args))

        bp.step = half_step
    elif fault == "altered":
        step = bp.step

        def altered_step(*args):
            g_a, g_b, g_c = step(*args)
            swap = [1, 0] + list(range(2, g_a[0].shape[-2]))
            g_a = tuple(x[..., swap, :] for x in g_a)
            return g_a, g_b, g_c

        bp.step = altered_step
    else:
        raise ValueError(f"unknown fault {fault!r}; the faults are {', '.join(FAULTS)}")


def faulty_prover(fault: str, base=run.Prover):
    """A `make_prover` for run.run: set-up as usual, then the fault planted."""

    def make(cell, seed, device, spans, sync):
        prover = base(cell, seed, device, spans, sync)
        plant(fault, prover.bp)
        return prover

    return make


def run_faulty(cell, seed: int, seconds: float, fault: str, device=None, base=run.Prover) -> dict:
    """One run of `cell` with `fault` planted; returns its result line."""
    out = io.StringIO()
    rc = run.run(cell, seed, seconds, False, device=device, out=out, make_prover=faulty_prover(fault, base))
    if rc != 0:
        raise run.RunError(f"the run ended with {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=FAULTS)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = run.Cell(args.workload)
    for seed in args.seeds:
        res = run_faulty(cell, seed, args.seconds, args.fault)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "failed": res["failed"], "check": res["check"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
