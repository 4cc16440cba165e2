"""K7 adler32_tiles and K10 combine_grouped timed at their paths' shapes on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 -m fdeflate_tpu_torch.tools.time_k7_k10 [--reps 10]

It uses only entry points that every slice of the port since the blocked
layout has had (``adler32_tiles``, ``adler32_pallas``, ``adler32_batch``,
``zlib_encode_step``, ``combine`` with and without ``group``), so the same
file, copied into an older checkout, times that checkout's code: to
compare two trees, run it from each in one machine session, in turns
(parent, change, change, parent).  Printed, one line each, as medians of
``--reps`` CUDA-event timings of single calls and, beside them, per call
of 10 x ``--reps`` calls queued back to back (ms):

* K7 on a 64 MiB buffer with a length mask (``adler32_tiles``: the tile
  sums, the TPU kernel's outputs) and the whole ``adler32_pallas``;
* ``adler32_batch`` (the encode's per-stream Adler-32) on 16 x 1 MiB IDAT
  (``make_idat_corpus``), and the encode leg (``zlib_encode_step``, C =
  512) around it;
* K10's whole call (``combine(..., group=8)``) and K2 (``combine``) on
  K1's windows of the same streams;

then the card's name and power limit.  Checksums are checked against
zlib.adler32 and K10's words against K2's before they are timed.
"""

from __future__ import annotations

import argparse
import subprocess
import zlib

import torch

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.adler32 import adler32_batch
from fdeflate_tpu_torch.ops.adler32_pallas import adler32_tiles
from fdeflate_tpu_torch.ops.assign_pack import assign_pack
from fdeflate_tpu_torch.ops.repack import combine
from fdeflate_tpu_torch.ops.ultrafast import lane_starts, stream_words
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.time_k2_k4 import cuda_ms
from fdeflate_tpu_torch.tools.time_k8_k9 import queued_ms
from fdeflate_tpu_torch.trees import trained_tables


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k7_k10: CUDA is not available")
    dev = torch.device("cuda")
    B, N, C = 16, 1 << 20, 512
    n = 64 << 20
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    buf = torch.randint(0, 256, (n,), generator=gen, dtype=torch.uint8,
                        device=dev)
    lt = torch.tensor([n - 12345], dtype=torch.int64, device=dev)
    if int(P.adler32_pallas(buf, lt)) != zlib.adler32(
            buf[: n - 12345].cpu().numpy().tobytes()):
        raise AssertionError("adler32_pallas differs from zlib.adler32")
    corpus = make_idat_corpus(B, N)
    data = torch.from_numpy(corpus).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    if adler32_batch(data, lengths).tolist() != [
            zlib.adler32(r.tobytes()) for r in corpus]:
        raise AssertionError("adler32_batch differs from zlib.adler32")
    t = trained_tables(str(dev))
    win, bits = assign_pack(data, lengths, C, t)
    pos0 = lane_starts(bits, B, C, t.header_bits)[0].reshape(-1).to(
        torch.int32)
    W = stream_words(N, t)
    if not torch.equal(combine(win, bits, pos0, B, W, group=8),
                       combine(win, bits, pos0, B, W)):
        raise AssertionError("K10 differs from K2")
    enc = P.zlib_encode_step(C)

    fns = {
        "K7 adler32_tiles 64 MiB": lambda: adler32_tiles(buf, lt),
        "adler32_pallas 64 MiB": lambda: P.adler32_pallas(buf, lt),
        "adler32_batch 16 x 1 MiB": lambda: adler32_batch(data, lengths),
        f"encode leg 16 x 1 MiB, C={C}": lambda: enc(data, lengths),
        "K10 combine(group=8)": lambda: combine(win, bits, pos0, B, W,
                                                group=8),
        "K2 combine": lambda: combine(win, bits, pos0, B, W),
    }
    for name, fn in fns.items():
        one = cuda_ms(fn, args.reps)
        queued = queued_ms(fn, 10 * args.reps)
        print(f"{name}: {one:.4f} ms one call, {queued:.4f} ms back to back",
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
