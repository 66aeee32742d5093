"""K4, the limb Montgomery multiply: the share of its roofline over the
profiled iterations, the least time of each launch (roofline.mont_mul_bound
at its lanes, its operands' bytes and its field) over the device time of
`mont_mul_kernel<L>`."""

from roofline import mont_mul_bound
from tracing import kernel_time


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    secs, n = kernel_time(tr, "mont_mul_kernel<")
    calls = ctx["launches"]["mont_mul"]
    if n == 0 or n != len(calls) or secs <= 0:
        return None
    ms = sum(mont_mul_bound(ctx["int_rate"], lanes, nbytes, p, L)[0] for lanes, nbytes, p, L in calls)
    return 100.0 * ms / 1e3 / secs
