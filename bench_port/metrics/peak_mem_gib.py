"""Device: torch.cuda.max_memory_allocated() at the window's close (the
statistics reset at the process's start), in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
