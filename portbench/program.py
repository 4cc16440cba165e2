"""The program's own spans and counters, as the per-layer metrics of a
traced run read them: ``fdeflate_tpu_torch.utils.profiling``'s
``span_seconds()`` (host seconds inside each span while a profiler ran,
which in a traced run is the window alone) and ``counts()`` (the process's
counters: set-up and window).  A program without them, or a window with no
call, reads nothing (None)."""

from __future__ import annotations


def _profiling():
    try:
        from fdeflate_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def span_ms_per_call(ctx, *names) -> float | None:
    """Milliseconds per call of the window inside the spans ``names``
    (their sum); None if none of them ran."""
    prof = _profiling()
    if not ctx.get("calls") or not hasattr(prof, "span_seconds"):
        return None
    seconds = prof.span_seconds()
    if not any(n in seconds for n in names):
        return None
    return 1e3 * sum(seconds.get(n, 0.0) for n in names) / ctx["calls"]


def counts(ctx) -> dict | None:
    """The program's counters, or None."""
    prof = _profiling()
    if not ctx.get("calls") or not hasattr(prof, "counts"):
        return None
    return prof.counts()


def share_pct(part: float, whole: float) -> float | None:
    """``part`` over ``whole`` in %, or None when ``whole`` is 0."""
    return 100.0 * part / whole if whole else None
