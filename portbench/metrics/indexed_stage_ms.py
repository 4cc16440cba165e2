"""indexed_stage_ms: host milliseconds per call in the program's span
``indexed.stage`` (``stage_indexed``: each stream's words, bit count and
index rows packed and moved to the device) in the traced window."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "indexed.stage")
