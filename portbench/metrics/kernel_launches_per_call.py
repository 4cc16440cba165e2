"""kernel_launches_per_call: the program's own kernels launched per call
of ``decompress_batch``, from its counters (every ``launch.<kernel>``
over ``inflate.calls``, set-up and window: the same batches)."""

from portbench import program


def read(ctx):
    n = program.counts(ctx)
    if n is None or not n.get("inflate.calls"):
        return None
    launches = sum(v for k, v in n.items() if k.startswith("launch."))
    return launches / n["inflate.calls"]
