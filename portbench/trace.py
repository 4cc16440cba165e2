"""Reading a ``torch.profiler`` trace of the measured window: the device's
kernels as a timeline, the host's operations, and the breakdown the
result line carries.  Used only with ``--trace 1``."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

from . import stats


def short_name(name: str) -> str:
    """A kernel's name without its return type, template or arguments."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


# The spans the benchmark's own files open with ``record_function``; the
# profiler mirrors each on the device's timeline, where it is no work.
SPANS = ("window", "encode_leg", "decode_leg", "synchronize",
         "decompress_batch")


def timelines(prof):
    """(device, host): lists of (name, start_s, end_s) of the device's
    operations (kernels, copies, fills; not the mirrors of host spans) and
    of the host's operations and spans, from a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = {e.name for e in events if e.device_type == DeviceType.CPU
             and getattr(e, "is_user_annotation", False)}
    spans |= set(SPANS)
    device, host = [], []
    for e in events:
        s = e.time_range.start * 1e-6
        t = e.time_range.end * 1e-6
        if e.device_type == DeviceType.CPU:
            host.append((e.name, s, t))
        elif (e.device_type == DeviceType.CUDA and e.name not in spans
              and not getattr(e, "is_user_annotation", False)):
            device.append((e.name, s, t))
    return device, host


def kernel_seconds(device, pattern: str) -> float | None:
    """Device seconds of the operations whose name matches ``pattern``
    (a regular expression searched in the full name); None if none ran."""
    rx = re.compile(pattern)
    hits = [t - s for name, s, t in device if rx.search(name)]
    return sum(hits) if hits else None


def top_ops(device, n: int = 10):
    """The n device operations that took most time, [name, seconds]."""
    by = defaultdict(float)
    for name, s, t in device:
        by[short_name(name)] += t - s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device, host, lo: float, hi: float, n: int = 10):
    """The device's idle time inside [lo, hi], summed by what the host was
    doing in the middle of each gap (its innermost operation or span
    there, "host idle" if none): the n largest, [name, seconds]."""
    busy = stats.merge((max(s, lo), min(t, hi)) for _n, s, t in device
                       if t > lo and s < hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by = defaultdict(float)
    for s, t in gaps:
        mid = (s + t) / 2
        name = "host idle"
        j = bisect.bisect_right(starts, mid) - 1
        while j >= 0:
            hname, hs, ht = host[j]
            if ht >= mid:
                name = hname
                break
            j -= 1
            if mid - hs > 5.0:
                break
        by[name] += t - s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
