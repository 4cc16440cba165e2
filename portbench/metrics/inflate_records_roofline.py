"""inflate_records_roofline: K4 (``csrc/inflate_records.cu``, ``inflate_kernel``)
against HBM's peak: the least time the decoded streams' bytes take at
3.35 TB/s (their compressed bytes read once and their decoded bytes
written once) over K4's device time in the traced window, whatever lanes
block discovery gave it."""

from portbench import stats, trace


def read(ctx):
    t = trace.kernel_seconds(ctx["device_ops"], r"\binflate_kernel\b")
    if t is None:
        return None
    nbytes = ctx["compressed_bytes"] + ctx["decoded_bytes"]
    return stats.roofline_pct(nbytes, t)
