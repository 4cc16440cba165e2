"""The port's spans and counters, and the ``torch.profiler`` helpers.

``span(name)`` marks a stage of the program.  While a ``torch.profiler``
profile is active it is ``torch.profiler.record_function(name)``, so the
stage lies on the profiler's timeline beside the device's kernels, and its
host seconds are added to ``span_seconds()``; otherwise it is one shared
null context (one check of the profiler's state).  ``count(name, n)`` adds
to the process's counters, which are always on; ``counts()`` copies them.
Neither store is ever reset: a reader takes the difference of two readings
(``span_seconds()`` holds only time spent under a profiler).  Spans and
counts read values already on the host: none copies from the device or
waits for it.

``trace`` profiles a region (the spans and the kernels, in one Chrome
trace); ``sync`` waits for the devices of the CUDA tensors it is given (a
failed sync raises).  Reading a region:

    with profiling.trace(log_dir):
        decompress_batch(streams)
    profiling.counts()
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time

import torch

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_counts: dict[str, int] = {}
_seconds: dict[str, float] = {}


class _Span:
    """``record_function(name)`` that also adds its host seconds to
    ``span_seconds()``."""

    __slots__ = ("_name", "_rf", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        with _lock:
            _seconds[self._name] = _seconds.get(self._name, 0.0) + dt
        return self._rf.__exit__(*exc)


def span(name: str):
    """A context manager marking the stage ``name``: a profiler span while
    a profile is active, else the shared null context."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def span_seconds() -> dict[str, float]:
    """A copy of the host seconds spent inside each span while a profiler
    was active."""
    with _lock:
        return dict(_seconds)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a region of work with ``torch.profiler`` (CPU activity, and
    CUDA activity where CUDA is available); on exit the Chrome trace, the
    port's spans beside the host's operations and the device's kernels, is
    written to ``log_dir/trace.json`` (default: ``fdeflate_tpu_torch_trace``
    in the temporary directory).  Yields the profiler, whose
    ``key_averages()`` sums the region's ops, spans and kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "fdeflate_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(*tensors) -> None:
    """Wait until the work queued on each CUDA tensor's device has finished
    (objects that are not CUDA tensors are skipped)."""
    devices = {t.device for t in tensors
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
