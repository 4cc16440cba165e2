"""lane_yield_pct: the share of the lanes block discovery parsed and K4
decoded that a walked chain used, from the program's counters
(``discovery.lanes_chained`` over ``discovery.lanes``, set-up and window:
the same batches)."""

from portbench import program


def read(ctx):
    n = program.counts(ctx)
    if n is None:
        return None
    return program.share_pct(n.get("discovery.lanes_chained", 0),
                             n.get("discovery.lanes", 0))
