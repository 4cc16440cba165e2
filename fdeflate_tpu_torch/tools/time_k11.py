"""K11 decode_symbols and the indexed decode leg timed at the headline width on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 -m fdeflate_tpu_torch.tools.time_k11 [--reps 5]

The corpus is 16 x 1 MiB IDAT (``make_idat_corpus``), encoded one lane per
stream with a C = 512 chunk index (``compress_batch_ultra_fast(
with_index=512)``) and staged as ``decompress_batch_indexed`` stages it
(``max_steps`` by its rule, ``max(2048, cap // C)``).  The decode is
checked first: every stream equals its input and none falls back to
``decompress_batch``; both forms of K11 equal its plain version on the same
lanes.  Printed, one line each, as medians of ``--reps`` CUDA-event
timings of single calls and, beside them, per call of ``--reps`` calls
queued back to back (ms):

* K11 on the 8192 chunk lanes in its live form (``_decode_symbols_live``,
  the indexed path's: each lane's rows up to its step count) and its full
  form (the public ``decode_symbols``: every row), with the bound of each
  (bytes over 3.35 TB/s: the words read once, 21 B per record written, the
  lanes' inputs, state and step counts, the tables), and the plain version
  (one call);
* the kernel's own device time (``torch.profiler``, no host time) in both
  forms, and the word-refill probe: the live form after 256 MiB read on
  the card (its words no longer in the 50 MB L2) against right after
  another call (words in L2), and the cycles per step of the longest lane
  at the card's maximum SM clock, also at chain 1 and 2 (one and two
  table lookups of literals a step in place of four);
* the indexed decode leg: ``indexed_materialize`` on the live records,
  the same with the host's read of ``produced`` (the capacity check), and
  the whole ``indexed_decode_step`` (K11 + ``indexed_materialize``), with
  its decoded GB/s;
* the one-lane encode: ``encode_ultrafast_batch(num_chunks=512)`` (K1 at
  C = 1, K2, framing, K7, ``symbol_index``) and K1 alone at C = 1;
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
from torch.profiler import ProfilerActivity, profile

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.assign_pack import assign_pack
from fdeflate_tpu_torch.ops.decode_symbols import (STOPPED,
                                                   _decode_symbols_live,
                                                   decode_symbols,
                                                   decode_symbols_plain,
                                                   engine_inputs)
from fdeflate_tpu_torch.ops.ultrafast import encode_ultrafast_batch
from fdeflate_tpu_torch.parallel import device_pipeline as DP
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.time_k2_k4 import cuda_ms
from fdeflate_tpu_torch.tools.time_k8_k9 import queued_ms
from fdeflate_tpu_torch.trees import trained_tables
from fdeflate_tpu_torch.utils import profiling

B, N, C = 16, 1 << 20, 512
HBM_BYTES_PER_S = 3.35e12


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
    """K11's plain version on the case's own device: (records, state,
    steps), the full records and each lane's step count."""
    kw = dict(case)
    steps = kw.pop("max_steps")
    words, lanes, rows, tabs, first, _t = engine_inputs(**kw)
    records, state = decode_symbols_plain(words, *lanes, rows, *tabs, first,
                                          steps, kw["chain"])
    return records, state, (records[5] >= 0).sum(0, dtype=torch.int32)


def live_view(records, state, steps):
    """What K11's live form defines: each record array's rows below its
    lane's step count (flattened), the counts and the state."""
    K = records[0].shape[0]
    live = torch.arange(K, device=steps.device)[:, None] < steps[None, :]
    return tuple(r[live] for r in records) + (steps,) + tuple(state)


def k11_bytes(case: dict, total_bits, records: int) -> int:
    """Bytes K11's function moves for ``records`` records written: the
    stream words its lanes read once, 21 B a record, the lanes' inputs (7
    int32), state (9 B) and step counts (4 B), the tables."""
    L = case["bit_pos"].numel()
    words_read = int(((total_bits.to(torch.int64) + 31) // 32).sum())
    return (4 * words_read + 21 * records + (28 + 9 + 4) * L
            + 4 * (2 * 4096 + 512 + 2))


def host_ms(fn, reps: int) -> float:
    """Median host-clock milliseconds of ``fn`` (which returns host data)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def smi(query: str) -> str:
    """``nvidia-smi``'s answer to ``--query-gpu=query`` for the card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def kernel_ms(fn, reps: int, before=None) -> float:
    """Mean device time (ms) of K11's kernel over ``reps`` calls of ``fn``,
    as ``torch.profiler`` records the kernel itself (no host time);
    ``before`` runs ahead of each call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "decode_symbols_kernel" in e.key]
    if not ev or not sum(e.device_time_total for e in ev):
        raise RuntimeError("the profiler recorded no device time for K11")
    return (sum(e.device_time_total for e in ev)
            / sum(e.count for e in ev) / 1e3)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k11: CUDA is not available")
    dev = torch.device("cuda")
    corpus = make_idat_corpus(B, N)
    streams_in = [r.tobytes() for r in corpus]
    streams, index = P.compress_batch_ultra_fast(streams_in, with_index=C)
    case, staged, cap = headline_lanes(streams, index, dev)
    data = torch.from_numpy(corpus).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    before = profiling.counts().get("indexed.fallback", 0)
    if P.decompress_batch_indexed(streams, index) != streams_in:
        raise AssertionError("decompress_batch_indexed differs from the input")
    if profiling.counts().get("indexed.fallback", 0) != before:
        raise AssertionError("a stream fell back to decompress_batch")
    want = plain_k11(case)
    full = decode_symbols(**case)
    live = _decode_symbols_live(**case)
    for g, w in zip(full[0] + full[1], want[0] + want[1]):
        if not torch.equal(g, w):
            raise AssertionError("K11's full form differs from plain")
    for g, w in zip(live_view(*live), live_view(*want)):
        if not torch.equal(g, w):
            raise AssertionError("K11's live form differs from plain")
    records, state, steps = live
    status = torch.where(case["active"], state[2], STOPPED)
    step = DP.indexed_decode_step(C, case["max_steps"], cap)
    t = trained_tables(str(dev))
    L, ran, longest = steps.numel(), int(steps.sum()), int(steps.max())
    del full, want

    def with_read():
        return DP.indexed_materialize(records, status, None, C, cap,
                                      steps=steps)[1].cpu()

    live_name = (f"K11 live form ({L} lanes, {case['max_steps']} steps, "
                 f"{ran} run)")
    fns = {
        live_name: lambda: _decode_symbols_live(**case),
        "K11 full form (decode_symbols)": lambda: decode_symbols(**case),
        "indexed_materialize (live records)": lambda: DP.indexed_materialize(
            records, status, None, C, cap, steps=steps),
        "indexed_materialize + read of produced": with_read,
        "indexed_decode_step (K11 + indexed_materialize)":
            lambda: step(*staged),
        f"encode_ultrafast_batch(num_chunks={C}) (one lane per stream)":
            lambda: encode_ultrafast_batch(data, lengths, num_chunks=C),
        "K1 assign_pack at C=1": lambda: assign_pack(data, lengths, 1, t),
    }
    one = {}
    for name, fn in fns.items():
        one[name] = cuda_ms(fn, args.reps)
        queued = queued_ms(fn, args.reps)
        print(f"{name}: {one[name]:.4f} ms one call, {queued:.4f} ms back "
              f"to back", flush=True)
    live_bound = k11_bytes(case, staged[1], ran) / HBM_BYTES_PER_S * 1e3
    full_bound = (k11_bytes(case, staged[1], case["max_steps"] * L)
                  / HBM_BYTES_PER_S * 1e3)
    print(f"K11 bounds (bytes): live form {live_bound:.6f} ms, full form "
          f"{full_bound:.6f} ms", flush=True)
    print(f"K11 plain version: {cuda_ms(lambda: plain_k11(case), 1):.4f} ms "
          f"one call", flush=True)
    live_fn = fns[live_name]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    warm = kernel_ms(live_fn, args.reps)
    cold = kernel_ms(live_fn, args.reps, before=lambda: flush.sum())
    full_k = kernel_ms(fns["K11 full form (decode_symbols)"], args.reps)
    clock = smi("clocks.max.sm")
    mhz = float(clock.split()[0])
    print(f"K11 kernel device time (torch.profiler): live form {warm:.4f} ms "
          f"right after a call, {cold:.4f} ms after 256 MiB read (its words "
          f"out of L2); full form {full_k:.4f} ms; longest lane {longest} "
          f"steps: at most {warm * 1e3 * mhz / longest:.0f} cycles a step at "
          f"the card's maximum SM clock, {clock}", flush=True)
    for chain in (1, 2):
        kw = dict(case, chain=chain)
        n = int(_decode_symbols_live(**kw)[2].max())
        ms = kernel_ms(lambda: _decode_symbols_live(**kw), args.reps)
        print(f"K11 live form at chain {chain}: {ms:.4f} ms device time, "
              f"longest lane {n} steps: at most {ms * 1e3 * mhz / n:.0f} "
              f"cycles a step", flush=True)
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
    print(smi("name,power.limit"))


if __name__ == "__main__":
    main()
