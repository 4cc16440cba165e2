"""Profiling: throughput counters and torch.profiler trace helpers.

The port's copy of ``fdeflate_tpu/utils/profiling.py``: ``Throughput`` :16,
``counter`` :49 and ``report_all`` :55 as they are (the host clock);
``trace`` (:60) wraps ``torch.profiler.profile`` with CUDA activity where
CUDA is available and writes a Chrome trace into ``log_dir``; ``sync``
(:71) waits for the devices of the CUDA tensors it is given.  A failed
sync raises: the original's ``except Exception: pass`` is not copied.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Throughput:
    """Accumulating bytes/sec counter for a named op."""

    name: str
    bytes: int = 0
    seconds: float = 0.0
    calls: int = 0
    _t0: float = field(default=0.0, repr=False)

    @contextlib.contextmanager
    def measure(self, nbytes: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.bytes += nbytes
            self.calls += 1

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0

    def report(self) -> str:
        return (
            f"{self.name}: {self.gbps:.3f} GB/s "
            f"({self.bytes / 1e6:.1f} MB over {self.calls} calls)"
        )


_counters: dict[str, Throughput] = {}


def counter(name: str) -> Throughput:
    if name not in _counters:
        _counters[name] = Throughput(name)
    return _counters[name]


def report_all() -> str:
    return "\n".join(c.report() for c in _counters.values())


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a region of work with ``torch.profiler`` (CPU activity, and
    CUDA activity where CUDA is available); on exit the Chrome trace is
    written to ``log_dir/trace.json`` (default: ``fdeflate_tpu_torch_trace``
    in the temporary directory).  Yields the profiler, whose
    ``key_averages()`` sums the region's ops and kernels."""
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
