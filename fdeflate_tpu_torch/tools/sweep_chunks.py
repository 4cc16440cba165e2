"""Lane-count sweep of the port's kernels and legs on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 -m fdeflate_tpu_torch.tools.sweep_chunks [--reps 20]

At the headline batch (``make_idat_corpus(16, 1 << 20)``) it encodes and
decodes at C = 512, 256, 1024, 2048, 4096 and 512 again (the repeat shows
the run-to-run spread), checks each roundtrip (decoded bytes, exit bits,
Adler-32), and prints per C the medians of ``--reps`` CUDA-event timings
of K1, K2, K3 and of the encode and decode legs, in ms, with the
compressed size; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess

import torch

from fdeflate_tpu_torch.ops.assign_pack import assign_pack
from fdeflate_tpu_torch.ops.decode2 import decode2
from fdeflate_tpu_torch.ops.repack import combine
from fdeflate_tpu_torch.ops.ultrafast import (encode_ultrafast_batch,
                                              lane_starts, stream_words)
from fdeflate_tpu_torch.parallel.device_pipeline import decode_verify
from fdeflate_tpu_torch.trees import trained_tables

BATCH, LENGTH = 16, 1 << 20
CHUNKS = (512, 256, 1024, 2048, 4096, 512)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events, after a warm-up)."""
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


def sweep_row(data, lengths, C: int, t, reps: int) -> dict:
    B, N = data.shape
    words, total_bits, adler, starts, eof = encode_ultrafast_batch(
        data, lengths, C, t)
    out, bpos_ok, ck_ok = decode_verify(words, starts, eof, adler, lengths,
                                        N, C, t)
    if not (torch.equal(out, data) and bool(bpos_ok.all())
            and bool(ck_ok.all())):
        raise AssertionError(f"roundtrip failed at C={C}")
    win, bits = assign_pack(data, lengths, C, t)
    pos0 = lane_starts(bits, B, C, t.header_bits)[0].reshape(-1).to(torch.int32)
    W = stream_words(N, t)
    return {
        "C": C, "lanes": B * C, "S": N // C,
        "K1": cuda_ms(lambda: assign_pack(data, lengths, C, t), reps),
        "K2": cuda_ms(lambda: combine(win, bits, pos0, B, W), reps),
        "K3": cuda_ms(lambda: decode2(words, starts, t.dtab, N, C), reps),
        "encode_leg": cuda_ms(
            lambda: encode_ultrafast_batch(data, lengths, C, t), reps),
        "decode_leg": cuda_ms(
            lambda: decode_verify(words, starts, eof, adler, lengths, N, C, t),
            reps),
        "compressed_bytes": int((total_bits // 8 + 4).sum()),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_chunks: CUDA is not available")
    os.environ.pop("JAX_PLATFORMS", None)   # bench.py imports jax if set
    from bench import make_idat_corpus

    dev = torch.device("cuda")
    t = trained_tables(str(dev))
    data = torch.from_numpy(make_idat_corpus(BATCH, LENGTH)).to(dev)
    lengths = torch.full((BATCH,), LENGTH, dtype=torch.int32, device=dev)
    cols = ("C", "lanes", "S", "K1", "K2", "K3", "encode_leg", "decode_leg",
            "compressed_bytes")
    print(" | ".join(cols))
    for C in CHUNKS:
        row = sweep_row(data, lengths, C, t, args.reps)
        print(" | ".join(f"{row[c]:.4f}" if isinstance(row[c], float)
                         else str(row[c]) for c in cols), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
