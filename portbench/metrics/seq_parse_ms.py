"""seq_parse_ms: host milliseconds per call in the program's span
``sequential.parse`` (the sequential path's host side: the streams' words
staged, every ``_advance_headers`` (framing, dynamic headers, stored
blocks copied), each launch's tables and per-lane uploads) in the traced
window; nothing for a program without the span."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "sequential.parse")
