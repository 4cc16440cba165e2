"""assign_pack_roofline: K1 (``csrc/assign_pack.cu``, ``assign_pack_kernel``)
against HBM's peak: the least time its work's bytes take at 3.35 TB/s
(the input bytes it reads once and the compressed bytes the steps
produced, written once) over its device time in the traced window."""

from portbench import stats, trace


def read(ctx):
    t = trace.kernel_seconds(ctx["device_ops"], r"\bassign_pack_kernel\b")
    if t is None:
        return None
    nbytes = ctx["input_bytes"] + ctx["compressed_bytes"]
    return stats.roofline_pct(nbytes, t)
