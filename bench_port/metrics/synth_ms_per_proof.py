"""Host synthesis: milliseconds per proof of encoding the pooled witness
batches (witness synthesis, the native evaluation of A, B, C and the wire
bytes to the card), by the host clock around encode_circuits."""


def read(ctx):
    return 1e3 * ctx["spans"]["encode_s"] / ctx["proofs_encoded"]
