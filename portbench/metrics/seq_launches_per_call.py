"""seq_launches_per_call: the sequential path's K4 launches (its rounds)
per call of ``decompress_batch``, from the program's counters
(``sequential.launches`` over ``inflate.calls``, set-up and window: the
same batches)."""

from portbench import program


def read(ctx):
    n = program.counts(ctx)
    if n is None or not n.get("inflate.calls"):
        return None
    return n.get("sequential.launches", 0) / n["inflate.calls"]
