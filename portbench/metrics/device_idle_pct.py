"""device_idle_pct.<cells>: the share of the traced window in which the
device ran no operation (kernel, copy or fill).  One reader for every
split of the metric (``device_idle_pct.inflate``, ...), each named for
the end-to-end metric its cells report."""

from portbench import stats


def read(ctx):
    if not ctx.get("busy_s"):
        return None
    return stats.idle_pct(ctx["busy_s"], ctx["window_s"])
