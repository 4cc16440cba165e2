"""discovery_ms: host milliseconds per call in every span of the program
whose name starts ``discovery.`` (block discovery's stages: stage 1, K5,
K12, K4 over the lanes, the chain walks, the stitch) in the traced window,
whether or not discovery kept the streams; nothing for a program without
such spans, or a window with no call."""

from portbench import program


def read(ctx):
    try:
        from fdeflate_tpu_torch.utils.profiling import span_seconds
    except ImportError:
        return None
    names = [n for n in span_seconds() if n.startswith("discovery.")]
    return program.span_ms_per_call(ctx, *names)
