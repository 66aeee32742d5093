"""Set-up: seconds of the port's generate_parameters for the cell's
circuit and seeded toxic waste (host clock, the card synchronized)."""


def read(ctx):
    return ctx["spans"]["crs_s"]
