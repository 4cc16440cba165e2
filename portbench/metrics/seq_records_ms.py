"""seq_records_ms: host milliseconds per call in the program's span
``sequential.records`` (each K4 launch of the sequential path, through the
read-back of its exits: ``bpos``, ``done``, ``nout``) in the traced
window; nothing for a program without the span."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "sequential.records")
