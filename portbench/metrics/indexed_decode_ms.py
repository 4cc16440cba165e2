"""indexed_decode_ms: host milliseconds per call in the program's span
``indexed.decode`` (K11 over every chunk lane and each
``indexed_materialize`` round, through the read-back of ``produced``) in
the traced window."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "indexed.decode")
