"""decode2_roofline: K3 (``csrc/decode2.cu``, ``decode_kernel``) against
HBM's peak: the least time its work's bytes take at 3.35 TB/s (the
compressed bytes read once and the decoded bytes written once) over its
device time in the traced window."""

from portbench import stats, trace


def read(ctx):
    t = trace.kernel_seconds(ctx["device_ops"], r"\bdecode_kernel\b")
    if t is None:
        return None
    nbytes = ctx["compressed_bytes"] + ctx["decoded_bytes"]
    return stats.roofline_pct(nbytes, t)
