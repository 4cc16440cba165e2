"""host_parse_ms: host milliseconds per call in the program's spans
``discovery.parse`` (the host's parse of every validated header) and
``discovery.tables`` (K4's tables built and uploaded) in the traced
window."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "discovery.parse", "discovery.tables")
