"""Table build: seconds of BatchProver(...) (the CRS's bases on the card,
the window tables in RNS form; host clock, the card synchronized)."""


def read(ctx):
    return ctx["spans"]["build_s"]
