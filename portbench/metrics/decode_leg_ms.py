"""decode_leg_ms: device time per step from the event after the encode leg
to the event after the decode leg (``zlib_decode_step``: K3, the exit-bit
check, the decode-side Adler-32), summed over the traced window's steps,
over the steps."""


def read(ctx):
    spans = ctx.get("span_ms", {})
    if "decode_leg" not in spans or not ctx.get("steps"):
        return None
    return spans["decode_leg"] / ctx["steps"]
