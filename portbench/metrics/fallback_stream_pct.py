"""fallback_stream_pct: the share of the streams entering block discovery
that it left to the sequential path, from the program's counters
(``discovery.fallback.<reason>`` over ``discovery.streams``, set-up and
window: the same batches)."""

from portbench import program


def read(ctx):
    n = program.counts(ctx)
    if n is None:
        return None
    left = sum(v for k, v in n.items() if k.startswith("discovery.fallback."))
    return program.share_pct(left, n.get("discovery.streams", 0))
