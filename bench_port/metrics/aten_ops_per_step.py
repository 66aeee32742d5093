"""Dispatch: the aten operator calls of one BatchProver.step, counted by a
TorchDispatchMode (tracing.aten_ops) after the window."""


def read(ctx):
    return ctx.get("aten_ops_per_step")
