"""The matched encoder's stages timed at the width its users run, on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 -m fdeflate_tpu_torch.tools.time_matched [--reps 3]

The corpus is 16 x 1 MiB IDAT (``tools/corpus.make_idat_corpus(16, 1 <<
20)``), through ``compress_batch_device`` at levels 1, 2 and 3.  Every
stream is checked against ``zlib.decompress`` first.  Printed per level:

* the whole call by the host clock (median of ``--reps`` calls) and its
  input GB/s;
* each stage by CUDA events around it (``stage_ms``: the stage functions
  of ``ops/matchscan`` wrapped in turn, the card synchronised after each):
  stage 1, the host's first-pass trees, stage 1.5 and the host's code
  lengths per pass, the host headers, stage 2, K7 (``adler32_batch``) and
  the read-back;
* stage 1's parts the same way: the byte histogram, both ``find_matches``
  passes, ``extend_winners``, ``greedy_tile``, ``merge_chains`` and the
  roles;
* the peak device memory above what was held before the call;

then the row scans at [16, 2^20] int32 (``matchscan._row_scan``'s doubling
against PyTorch's ``cummax`` flat, rows kept apart by an offset, and along
the rows), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import time
import zlib
from collections import defaultdict

import torch

from fdeflate_tpu_torch.ops import matchscan as M
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus

# Functions of ops/matchscan that compress_batch_matched calls, in order.
STAGES = ("_stage1", "_first_pass_trees", "_demote_segments",
          "_code_lengths", "_headers", "_pack_symbols", "adler32_batch",
          "_read_back")
# Stage 1's parts (called through the module's globals too).
PARTS = ("_byte_hist", "find_matches", "extend_winners", "greedy_tile",
         "merge_chains", "_roles_and_freqs")


@contextlib.contextmanager
def patched(names, wrap):
    """Replace each of ``names`` in ops/matchscan by ``wrap(name, fn)``."""
    saved = {name: getattr(M, name) for name in names}
    try:
        for name, fn in saved.items():
            setattr(M, name, wrap(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(M, name, fn)


def stage_ms(call, names=STAGES):
    """(call()'s result, {name: [ms of each call]}): CUDA events around each
    call of each of ``names``, the card synchronised before and after."""
    times = defaultdict(list)

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
            return out
        return timed

    with patched(names, wrap):
        out = call()
    return out, dict(times)


def host_ms(call, reps: int) -> float:
    """Median milliseconds of ``call`` by the host clock, synchronised."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def peak_bytes(call, dev) -> int:
    """Peak device memory of ``call`` above what was held before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    call()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev) - base


def fmt(times: dict) -> str:
    return "; ".join(f"{k} " + " + ".join(f"{t:.4f}" for t in v)
                     for k, v in times.items())


def scan_forms(dev, B: int = 16, N: int = 1 << 20) -> dict:
    """ms of one inclusive row max-scan of int32[B, N] in three forms."""
    x = torch.randint(-1, N, (B, N), dtype=torch.int32, device=dev)
    off = torch.arange(B, device=dev, dtype=torch.int64)[:, None] << 32

    def flat():
        y = (x.to(torch.int64) + off).reshape(-1).cummax(0).values
        return (y.reshape(B, N) - off).to(torch.int32)

    forms = {"doubling (_row_scan)": lambda: M._row_scan(x, torch.maximum),
             "torch.cummax flat, row offsets": flat,
             "torch.cummax along rows": lambda: x.cummax(1).values}
    want = forms["doubling (_row_scan)"]()
    out = {}
    for name, fn in forms.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"row scan {name} differs")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end)
    return out


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_matched: CUDA is not available")
    dev = torch.device("cuda")
    corpus = make_idat_corpus(16, 1 << 20)
    streams = [r.tobytes() for r in corpus]
    nbytes = corpus.size
    for level in (1, 2, 3):
        def call():
            return M.compress_batch_device(streams, level)

        out = call()
        if [zlib.decompress(o) for o in out] != streams:
            raise AssertionError(f"level {level}: zlib roundtrip failed")
        ms = host_ms(call, args.reps)
        _out, stages = stage_ms(call)
        _out, parts = stage_ms(call, PARTS)
        peak = peak_bytes(call, dev)
        print(f"level {level} ({len(streams)} x {corpus.shape[1]} B IDAT, "
              f"{sum(map(len, out))} B out): {ms:.4f} ms host clock, "
              f"{nbytes / ms / 1e6:.4f} GB/s of input; peak "
              f"{peak / 2**30:.3f} GiB", flush=True)
        print(f"level {level} stages, ms: {fmt(stages)}", flush=True)
        print(f"level {level} stage 1 parts, ms: {fmt(parts)}", flush=True)
    scans = scan_forms(dev)
    print("row max-scan of int32[16, 2^20], one call: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in scans.items()), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
