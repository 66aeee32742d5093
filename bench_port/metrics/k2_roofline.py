"""K2, the G2 fold kernel: the share of its roofline over the profiled
iterations, the least time of each launch (roofline.fold_bound at its lanes
and gathered table points) over the device time of `fold_kernel<G2Ops>`."""

from roofline import fold_bound
from tracing import kernel_time


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    secs, n = kernel_time(tr, "fold_kernel<", "G2Ops>")
    calls = ctx["launches"]["rns_fold_window_g2"]
    if n == 0 or n != len(calls) or secs <= 0:
        return None
    entries = ctx["table_entries"]
    ms = sum(fold_bound(ctx["int_rate"], "rns_fold_window_g2", lanes, bases * entries[bases])[0]
             for lanes, bases in calls)
    return 100.0 * ms / 1e3 / secs
