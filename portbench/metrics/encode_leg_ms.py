"""encode_leg_ms: device time per step from the event before the encode
leg (``zlib_encode_step``: K1, the lane starts, K2, framing, K7) to the
event after it, summed over the traced window's steps, over the steps."""


def read(ctx):
    spans = ctx.get("span_ms", {})
    if "encode_leg" not in spans or not ctx.get("steps"):
        return None
    return spans["encode_leg"] / ctx["steps"]
