"""indexed_verify_ms: host milliseconds per call in the program's span
``indexed.verify`` (each stream's bytes sliced and its Adler-32 compared
on the host) in the traced window."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "indexed.verify")
