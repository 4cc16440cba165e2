"""indexed_readback_ms: host milliseconds per call in the program's span
``indexed.readback`` (the decoded bytes and the ok flags copied to the
host) in the traced window."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "indexed.readback")
