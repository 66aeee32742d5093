"""Device: milliseconds in which an operation ran on the card, per proof,
over the profiled iterations (the union of the device intervals over the
proofs those iterations made).  It stays put where the host's speed moves
proofs_per_s, so it shows a change in the work the card does."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["busy_s"]:
        return None
    return 1e3 * tr["busy_s"] / ctx["proofs_traced"]
