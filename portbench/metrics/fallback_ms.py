"""fallback_ms: host milliseconds per call in the program's span
``inflate.sequential`` (the block-by-block decode of the streams block
discovery left) in the traced window; nothing when no stream fell back
there."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "inflate.sequential")
