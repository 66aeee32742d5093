"""h(x): milliseconds per proof of the h(x) pipeline on the card's stream
over the profiled iterations: the program's span "step.h" in
BatchProver.step (two CUDA events around the coset NTTs, read after the
run, utils/profiling.py), its records made while torch.profiler recorded,
summed over their proofs.  The time between the events includes every
wait of the card for the host to queue the pipeline's next kernel.
Nothing where the program keeps no such span."""


def read(ctx):
    try:
        from bellman_mpc_tpu_torch.utils import profiling

        records = profiling.read(traced=True)["spans"].get("step.h")
    except (ImportError, AttributeError):
        return None
    if not records:
        return None
    return 1e3 * sum(s for s, _ in records) / sum(n for _, n in records)
