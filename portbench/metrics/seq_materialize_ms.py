"""seq_materialize_ms: host milliseconds per call in the program's span
``sequential.materialize`` (each launch's records expanded by
``materialize``, its bytes read back, the windows kept on the device,
uploaded or read back, each stream's bytes appended) in the traced
window; nothing for a program without the span."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "sequential.materialize")
