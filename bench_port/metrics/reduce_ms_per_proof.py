"""Reduce: milliseconds per proof of the MSMs' tree reductions on the
card's stream over the profiled iterations: the program's span "msm.reduce"
around each ops/msm._rns_fold_reduce (two CUDA events around the tree of
complete additions and the bridge to limb form, read after the run,
utils/profiling.py), its records made while torch.profiler recorded,
summed over the iterations and divided by their proofs.  The time between
the events includes every wait of the card for the host.  Nothing where
the program keeps no such span."""


def read(ctx):
    try:
        from bellman_mpc_tpu_torch.utils import profiling

        records = profiling.read(traced=True)["spans"].get("msm.reduce")
    except (ImportError, AttributeError):
        return None
    if not records:
        return None
    return 1e3 * sum(s for s, _ in records) / ctx["proofs_traced"]
