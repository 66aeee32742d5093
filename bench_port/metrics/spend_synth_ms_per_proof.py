"""Host synthesis: milliseconds per proof of the witness synthesis of the
circuits encoded (the program's span "encode.synthesize" around each
circuit's synthesize in encode_circuits, utils/profiling.py), the mean
over the run's records; nothing where the program keeps no such span."""


def read(ctx):
    try:
        from bellman_mpc_tpu_torch.utils import profiling

        records = profiling.read()["spans"].get("encode.synthesize")
    except (ImportError, AttributeError):
        return None
    if not records:
        return None
    return 1e3 * sum(s for s, _ in records) / sum(n for _, n in records)
