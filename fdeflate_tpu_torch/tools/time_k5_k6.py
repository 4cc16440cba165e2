"""K5 validate_headers and K6 decode_sep timed at their paths' shapes on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 -m fdeflate_tpu_torch.tools.time_k5_k6 [--reps 10]

It uses only entry points that every slice of the port since the sep
profile has had, so the same file, copied into an older checkout, times
that checkout's kernels: to compare two trees, run it from each in one
machine session, in turns (parent, change, change, parent).  Printed, one
line each, as medians of ``--reps`` CUDA-event timings of single calls
(ms):

* K6 on the sep tree's streams of 16 x 1 MiB IDAT (``make_idat_corpus``),
  C = 512, the sep decode leg (``zlib_decode_step(tree=sep_profile())``)
  around it, and K3 with the sep tree's table on the same streams (the
  yardstick of a group decode);
* K5 on every stage-1 survivor of 8 MiB of word-salad text at zlib 6, of
  8 MiB of IDAT at zlib 1 and of one 1 MiB IDAT stream at zlib 1;
* the K5 calls inside one ``try_foreign_batch`` of 16 x 1 MiB IDAT streams
  at zlib 1: their launches and the sum of their one-call times (CUDA
  events around each call of ``discovery.validate_headers``, the name
  every slice calls it by);

then the card's name and power limit.  K6's bytes are checked against the
input and K5's flags against its plain version on the 1 MiB stream before
they are timed.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import zlib

import torch

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.decode2 import decode2
from fdeflate_tpu_torch.ops.decode_sep import decode_sep
from fdeflate_tpu_torch.ops.validate_headers import (validate_headers,
                                                     validate_headers_plain)
from fdeflate_tpu_torch.parallel import discovery as PD
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.time_k2_k4 import cuda_ms, word_salad
from fdeflate_tpu_torch.trees import profile_tables, sep_tables


def time_k6(dev, reps: int) -> None:
    B, N, C = 16, 1 << 20, 512
    sep = P.sep_profile()
    data = torch.from_numpy(make_idat_corpus(B, N)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    words, _tb, adler, starts, eof = P.zlib_encode_step(C, tree=sep)(data, lengths)
    meta, vals = sep_tables(sep.lens, dev)
    if not torch.equal(decode_sep(words, starts, meta, vals, N, C)[0], data):
        raise AssertionError("K6: bytes differ from the input")
    dec = P.zlib_decode_step(C, N, tree=sep)
    dtab = profile_tables(sep, str(dev)).dtab
    k6 = cuda_ms(lambda: decode_sep(words, starts, meta, vals, N, C), reps)
    leg = cuda_ms(lambda: dec(words, starts, eof, adler, lengths), reps)
    k3 = cuda_ms(lambda: decode2(words, starts, dtab, N, C), reps)
    print(f"K6 16 x 1 MiB, C={C}: kernel {k6:.4f} ms, sep decode leg "
          f"{leg:.4f} ms; K3 with the sep table on the same streams "
          f"{k3:.4f} ms", flush=True)


def time_k5(label: str, z: bytes, dev, reps: int, check: bool) -> None:
    wd = PD.stage_words(z, device=dev)
    c = torch.from_numpy(PD.scan_stage1_device(z, device=dev, words=wd)).to(dev)
    n = len(z) * 8
    if check:
        got, want = validate_headers(wd, c, n), validate_headers_plain(wd, c, n)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K5 {label}: differs from its plain version")
    ms = cuda_ms(lambda: validate_headers(wd, c, n), reps)
    print(f"K5 {label} ({c.numel()} candidates): kernel {ms:.4f} ms",
          flush=True)


def time_k5_in_batch(batch: list[bytes], dev, reps: int) -> None:
    """Launches and summed one-call times of the K5 calls that one
    ``try_foreign_batch`` makes (medians over ``reps`` calls)."""
    orig = PD.validate_headers
    spans = []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kw)
        end.record()
        spans.append((start, end))
        return out

    PD.validate_headers = timed
    try:
        want = [zlib.decompress(z) for z in batch]
        if P.try_foreign_batch(batch, device=dev) != want:
            raise AssertionError("try_foreign_batch differs from zlib")
        totals, calls = [], []
        for _ in range(reps):
            spans.clear()
            P.try_foreign_batch(batch, device=dev)
            torch.cuda.synchronize()
            totals.append(sum(s.elapsed_time(e) for s, e in spans))
            calls.append(len(spans))
    finally:
        PD.validate_headers = orig
    print(f"K5 in try_foreign_batch, {len(batch)} x 1 MiB idat1: "
          f"{statistics.median(calls):.0f} launches per call, "
          f"{statistics.median(totals):.4f} ms summed", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k5_k6: CUDA is not available")
    dev = torch.device("cuda")

    time_k6(dev, args.reps)
    text = zlib.compress(word_salad(8 << 20), 6)
    idat = zlib.compress(make_idat_corpus(8, 1 << 20).tobytes(), 1)
    batch = [zlib.compress(r.tobytes(), 1)
             for r in make_idat_corpus(16, 1 << 20, seed=7)]
    time_k5("text6 8 MiB", text, dev, args.reps, False)
    time_k5("idat1 8 MiB", idat, dev, args.reps, False)
    time_k5("idat1 1 MiB", batch[0], dev, args.reps, True)
    time_k5_in_batch(batch, dev, max(3, args.reps // 3))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
