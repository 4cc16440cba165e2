"""stage1_ms: host milliseconds per call in the program's span
``discovery.stage1`` (block discovery's scan of every bit offset of each
stream, through the read-back of its survivors) in the traced window."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "discovery.stage1")
