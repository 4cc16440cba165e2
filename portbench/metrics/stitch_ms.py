"""stitch_ms: host milliseconds per call in the program's span
``discovery.stitch`` (the chained lanes' records into bytes on the device,
K7's Adler-32, the read-back and the checksum compare) in the traced
window."""

from portbench import program


def read(ctx):
    return program.span_ms_per_call(ctx, "discovery.stitch")
