"""decode_symbols_roofline: K11 (``csrc/decode_symbols.cu``,
``decode_symbols_kernel``) against HBM's peak: the least time the decoded
streams' bytes take at 3.35 TB/s (their compressed bytes read once and
their decoded bytes written once) over K11's device time in the traced
window, whatever records K11 writes to get there."""

from portbench import stats, trace


def read(ctx):
    t = trace.kernel_seconds(ctx["device_ops"], r"\bdecode_symbols_kernel\b")
    if t is None:
        return None
    nbytes = ctx["compressed_bytes"] + ctx["decoded_bytes"]
    return stats.roofline_pct(nbytes, t)
