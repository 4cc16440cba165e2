"""K2 combine and K4 inflate_records timed at their paths' shapes on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 -m fdeflate_tpu_torch.tools.time_k2_k4 [--reps 10]

Its entry points (``discovery.lane_layout`` the newest of them) stay put,
so the same file, copied into an older checkout that has them, times that
checkout's kernels: to compare two trees, run it from each in one machine
session, in turns (parent, change, change, parent).  Printed, one line
each, as medians of ``--reps`` CUDA-event timings of single calls (ms):

* K2 on K1's windows of 16 x 1 MiB IDAT (``make_idat_corpus``), C = 512,
  and the encode leg (``encode_fixed``) around it;
* K4 on every lane block discovery finds in 8 MiB of word-salad text at
  zlib 6 and 8 MiB of IDAT at zlib 1 (``try_foreign``'s lanes) and in 16 x
  1 MiB IDAT streams at zlib 1 (``try_foreign_batch``'s lanes over the
  concatenated words), with the lanes' count, and the record-decode piece
  (per-lane uploads, K4, read-back: ``discovery._lane_decode``) of each;
* K12 (``ops/header_tables``) on every K5-good header of bench.py's
  images 16-31 at zlib 6 (16 x 1 MiB, the discovery cell's streams): one
  call, back to back, and the parse stage around it (its inputs'
  upload, K12, the read-back of its statuses), with its bound (the header
  bits read and the tables written at 3.35 TB/s); skipped in a checkout
  that has no K12;

then the card's name and power limit.  Every K4 output is checked to give
each stream's whole chain (``discovery._walk``) before it is timed.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import zlib

import numpy as np
import torch

from fdeflate_tpu_torch.ops.assign_pack import assign_pack
from fdeflate_tpu_torch.ops.inflate import pad_words
from fdeflate_tpu_torch.ops.inflate_records import DONE_EOB, inflate_records
from fdeflate_tpu_torch.ops.repack import combine
from fdeflate_tpu_torch.ops.ultrafast import (encode_fixed, lane_starts,
                                              stream_words)
from fdeflate_tpu_torch.parallel import discovery as PD
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.trees import trained_tables

MAX_STEPS = 6144   # try_foreign's default


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of single calls of ``fn`` (CUDA events, after a
    warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def word_salad(n: int, seed: int = 9) -> bytes:
    """The foreign leg's text (``chip_smoke.word_salad``): words of 3-11
    random bytes."""
    rng = np.random.default_rng(seed)
    wp = [rng.bytes(int(rng.integers(3, 12))) for _ in range(256)]
    return b"".join(wp[int(rng.integers(256))] for _ in range(n // 7 + 1))[:n]


def time_k4(label: str, streams: list[bytes], dev, reps: int) -> None:
    words_np, base = pad_words(streams)
    words = torch.from_numpy(words_np).to(dev)
    lanes, tables, wend, bit_end, ranges, _dropped = PD.lane_layout(
        streams, words, base)
    args = PD.lane_inputs(lanes, words, wend, bit_end, tables)
    K = PD.lane_budget(MAX_STEPS)
    _recs, bpos, _nout, done = inflate_records(*args, K)
    bpos, eob = bpos.cpu().numpy(), done.cpu().numpy() == DONE_EOB
    if len(ranges) < len(streams) or not all(
            PD._walk(lanes, lo, hi, bpos, eob, int(base[si]) * 32)[2]
            for si, (lo, hi) in ranges.items()):
        raise AssertionError(f"{label}: K4 gave no chain")
    k4 = cuda_ms(lambda: inflate_records(*args, K), reps)
    piece = cuda_ms(lambda: PD._lane_decode(lanes, MAX_STEPS, words, wend,
                                            bit_end, tables), reps)
    print(f"K4 {label}: {len(lanes)} lanes, K={K}: kernel {k4:.4f} ms, "
          f"record decode (tables + K4 + read-back) {piece:.4f} ms",
          flush=True)


def back_to_back_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` with ``reps`` calls queued between
    two CUDA events (the median of three such runs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def k12_inputs(dev):
    """K12's inputs as the discovery cell gives them: every K5-good header
    of bench.py's images 16-31 at zlib 6 (16 x 1 MiB, image 20's false
    header among them) over the streams' concatenated words, on ``dev``:
    (words, offs, wend, bit_end)."""
    raw = [r.tobytes() for r in make_idat_corpus(32, 1 << 20, 0)[16:]]
    streams = [zlib.compress(r, 6) for r in raw]
    words_np, base = pad_words(streams)
    words = torch.from_numpy(words_np).to(dev)
    surv = {si: PD.scan_stage1_device(
        z, device=dev, words=words[base[si]:base[si + 1]])
        for si, z in enumerate(streams)}
    valid = PD.validate_stage2_batch(streams, surv, words, base)
    cols = PD.stage2_batch_inputs(
        streams, {si: v[0] for si, v in valid.items()}, base)
    return (words, *torch.from_numpy(cols).to(dev))


def k12_bytes(offs, info) -> int:
    """K12's bytes: each header's bits read, to its symbol start (its 17
    bits of fixed fields where it was skipped), and its meta and tab
    written."""
    status, _bfinal, start = info[:3].cpu().numpy()
    bits = np.where(status == 1, 17, start - offs.cpu().numpy())
    return int(((bits + 7) // 8).sum()) + len(status) * 4 * (64 + 160)


def time_k12(dev, reps: int) -> None:
    try:
        from fdeflate_tpu_torch.ops.header_tables import header_tables
    except ImportError:
        print("K12: not in this checkout", flush=True)
        return
    args = k12_inputs(dev)
    info = header_tables(*args)[0]
    nbytes = k12_bytes(args[1], info)
    one = cuda_ms(lambda: header_tables(*args), reps)
    queued = back_to_back_ms(lambda: header_tables(*args), reps)
    cols = torch.stack(args[1:]).cpu()
    stage = cuda_ms(lambda: header_tables(
        args[0], *cols.to(dev))[0].cpu(), reps)
    counts = np.bincount(info[0].cpu().numpy(), minlength=3).tolist()
    print(f"K12 zlib6 16 x 1 MiB images 16-31: {info.shape[1]} headers "
          f"(lanes, skipped, dropped {counts}): kernel {one:.4f} ms one call, "
          f"{queued:.4f} ms back to back, parse stage (upload, K12, "
          f"read-back) {stage:.4f} ms; bound {nbytes / 3.35e9:.6f} ms "
          f"({nbytes} bytes at 3.35 TB/s)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k2_k4: CUDA is not available")
    dev = torch.device("cuda")

    B, N, C = 16, 1 << 20, 512
    t = trained_tables(str(dev))
    data = torch.from_numpy(make_idat_corpus(B, N)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    win, bits = assign_pack(data, lengths, C, t)
    pos0 = lane_starts(bits, B, C, t.header_bits)[0].reshape(-1).to(torch.int32)
    W = stream_words(N, t)
    k2 = cuda_ms(lambda: combine(win, bits, pos0, B, W), args.reps)
    enc = cuda_ms(lambda: encode_fixed(data, lengths, C), args.reps)
    print(f"K2 16 x 1 MiB, C={C}: kernel {k2:.4f} ms, encode leg {enc:.4f} ms",
          flush=True)

    text = zlib.compress(word_salad(8 << 20), 6)
    idat = zlib.compress(make_idat_corpus(8, 1 << 20).tobytes(), 1)
    batch = [zlib.compress(r.tobytes(), 1)
             for r in make_idat_corpus(B, N, seed=7)]
    time_k4("text6 8 MiB", [text], dev, args.reps)
    time_k4("idat1 8 MiB", [idat], dev, args.reps)
    time_k4("idat1 16 x 1 MiB batch", batch, dev, args.reps)
    time_k12(dev, args.reps)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
