"""Device: the share of the traced window in which no operation ran on the
card, from the union of the device intervals that torch.profiler recorded
over the profiled iterations."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
