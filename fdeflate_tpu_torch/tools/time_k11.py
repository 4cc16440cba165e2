"""K11 decode_symbols and the indexed decode leg timed at the headline width on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 -m fdeflate_tpu_torch.tools.time_k11 [--reps 5]

The corpus is 16 x 1 MiB IDAT (``make_idat_corpus``), encoded one lane per
stream with a C = 512 chunk index (``compress_batch_ultra_fast(
with_index=512)``) and staged as ``decompress_batch_indexed`` stages it
(``max_steps`` by its rule, ``max(2048, cap // C)``).  The decode is
checked first: every stream equals its input and none falls back to
``decompress_batch``; K11 equals its plain version on the same lanes.
Printed, one line each, as medians of ``--reps`` CUDA-event timings of
single calls and, beside them, per call of ``--reps`` calls queued back
to back (ms):

* K11 on the 8192 chunk lanes, and its plain version (one call);
* the indexed decode leg split: the rearrangement of the records stream
  by stream, ``materialize``, the whole ``indexed_materialize`` (the two
  and the distance check), the host's read of ``produced`` for the
  capacity check (``indexed_materialize`` with and without it), and the
  whole ``indexed_decode_step`` (K11 + ``indexed_materialize``), with its
  decoded GB/s;
* the one-lane encode: ``encode_indexed`` (K1 at C = 1, K2, framing, K7,
  ``symbol_index``) and K1 alone at C = 1;
* host clock: ``compress_batch_ultra_fast(with_index=512)`` and
  ``decompress_batch_indexed`` (bytes in, bytes out, GB/s of output),
  and the peak device memory of ``decompress_batch_indexed``;

then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.assign_pack import assign_pack
from fdeflate_tpu_torch.ops.decode_symbols import (STOPPED, decode_symbols,
                                                   decode_symbols_plain,
                                                   engine_inputs)
from fdeflate_tpu_torch.ops.inflate import WINDOW, materialize
from fdeflate_tpu_torch.parallel import device_pipeline as DP
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.time_k2_k4 import cuda_ms
from fdeflate_tpu_torch.tools.time_k8_k9 import queued_ms
from fdeflate_tpu_torch.trees import trained_tables

B, N, C = 16, 1 << 20, 512


def headline_lanes(streams, index, dev):
    """``decode_symbols`` keywords of the chunk lanes of
    ``decompress_batch_indexed(streams, index)`` on ``dev``, and its first
    output capacity."""
    words, total_bits, chunk_starts, cap = DP.stage_indexed(streams, index, dev)
    starts, bits_l, stops, srow, active = DP.chunk_lanes(total_bits,
                                                         chunk_starts)
    t = DP.trained_symbol_tables(str(dev))
    case = dict(words=words, bit_pos=starts, bit_end=bits_l,
                out_pos=torch.full_like(starts, 1 << 30), active=active,
                table_id=torch.zeros_like(starts), litlen=t[0],
                litlen_sec=t[1], dist=t[2], dist_sec=t[3], bit_stop=stops,
                stream_row=srow, litlen_first=t[4],
                max_steps=max(2048, cap // C), chain=4)
    return case, (words, total_bits, chunk_starts), cap


def plain_k11(case: dict):
    """K11's plain version on the case's own device."""
    kw = dict(case)
    steps = kw.pop("max_steps")
    words, lanes, rows, tabs, first, _t = engine_inputs(**kw)
    return decode_symbols_plain(words, *lanes, rows, *tabs, first, steps,
                                kw["chain"])


def host_ms(fn, reps: int) -> float:
    """Median host-clock milliseconds of ``fn`` (which returns host data)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k11: CUDA is not available")
    dev = torch.device("cuda")
    corpus = make_idat_corpus(B, N)
    streams_in = [r.tobytes() for r in corpus]
    data = torch.from_numpy(corpus).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    streams, index = P.compress_batch_ultra_fast(streams_in, with_index=C)
    before = DP.decompress_batch_indexed.fallbacks
    if P.decompress_batch_indexed(streams, index) != streams_in:
        raise AssertionError("decompress_batch_indexed differs from the input")
    if DP.decompress_batch_indexed.fallbacks != before:
        raise AssertionError("a stream fell back to decompress_batch")
    case, staged, cap = headline_lanes(streams, index, dev)
    got = decode_symbols(**case)
    want = plain_k11(case)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        if not torch.equal(g, w):
            raise AssertionError("K11 differs from its plain version")
    records, state = got
    status = torch.where(case["active"], state[2], STOPPED)
    rec5 = records[:5]
    re5 = [DP._rearrange(a, C) for a in rec5]
    produced = DP.indexed_materialize(records, status, None, C, cap)[1]
    window = torch.zeros((B, WINDOW), dtype=torch.uint8, device=dev)
    step = DP.indexed_decode_step(C, case["max_steps"], cap)
    t = trained_tables(str(dev))
    del got, want

    def with_read():
        return DP.indexed_materialize(records, status, None, C, cap)[1].cpu()

    fns = {
        f"K11 decode_symbols ({B * C} lanes, {case['max_steps']} steps)":
            lambda: decode_symbols(**case),
        "rearrange (5 record arrays)":
            lambda: [DP._rearrange(a, C) for a in rec5],
        f"materialize ([{C * case['max_steps']}, {B}] records, cap {cap})":
            lambda: materialize([x.T for x in re5], window, produced, cap,
                                want_window=False),
        "indexed_materialize": lambda: DP.indexed_materialize(
            records, status, None, C, cap),
        "indexed_materialize + read of produced": with_read,
        "indexed_decode_step (K11 + indexed_materialize)":
            lambda: step(*staged),
        f"encode_indexed (one lane per stream, C={C} index)":
            lambda: DP.encode_indexed(data, lengths, C),
        "K1 assign_pack at C=1": lambda: assign_pack(data, lengths, 1, t),
    }
    one = {}
    for name, fn in fns.items():
        one[name] = cuda_ms(fn, args.reps)
        queued = queued_ms(fn, args.reps)
        print(f"{name}: {one[name]:.4f} ms one call, {queued:.4f} ms back "
              f"to back", flush=True)
    print(f"K11 plain version: {cuda_ms(lambda: plain_k11(case), 1):.4f} ms "
          f"one call", flush=True)
    leg = one["indexed_decode_step (K11 + indexed_materialize)"]
    print(f"indexed decode leg: {B * N / leg / 1e6:.4f} GB/s of output "
          f"(one call)", flush=True)
    enc = host_ms(lambda: P.compress_batch_ultra_fast(streams_in,
                                                      with_index=C), args.reps)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    dec = host_ms(lambda: P.decompress_batch_indexed(streams, index),
                  args.reps)
    peak = torch.cuda.max_memory_allocated(dev) - base
    print(f"host clock: compress_batch_ultra_fast(with_index={C}) {enc:.4f} "
          f"ms; decompress_batch_indexed {dec:.4f} ms = "
          f"{B * N / dec / 1e6:.4f} GB/s of output, peak device memory "
          f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held "
          f"before", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
