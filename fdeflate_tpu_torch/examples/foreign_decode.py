"""Foreign-stream decode example — arbitrary zlib input on the card.

The port's copy of ``examples/foreign_decode.py``.  Decodes zlib streams
this package did not produce (zlib, zlib-ng, libdeflate, PNG IDATs from
any encoder) through the block-parallel path of
``fdeflate_tpu_torch.decompress_batch``: dynamic-block headers are found
structurally (stage 1 on the card, K5 validate_headers), every block
decodes in its own lane of K4 inflate_records with its own trees, and one
materialize and K7's Adler-32 finish each stream.  Streams the discovery
cannot cover take the sequential path; output is always Adler-32
verified.

Usage:
  python -m fdeflate_tpu_torch.examples.foreign_decode f1.zz [f2.zz ...]
  python -m fdeflate_tpu_torch.examples.foreign_decode --demo
(``--device cpu`` runs the kernels' plain versions on the CPU.)
"""

from __future__ import annotations

import argparse
import time
import zlib

import numpy as np

import fdeflate_tpu_torch as P


def demo(*, device="cuda", streams: int = 4, size: int = 1 << 20) -> None:
    """``streams`` word-salad streams of ``size`` bytes at zlib 6, decoded
    as one batch, then the first through ``decompress_to_vec``."""
    rng = np.random.default_rng(0)
    words = [rng.bytes(int(rng.integers(3, 12))) for _ in range(256)]
    zs, datas = [], []
    for s in range(streams):
        r = np.random.default_rng(s)
        d = b"".join(words[int(r.integers(256))] for _ in range(size // 6 + 1))
        d = d[:size]
        datas.append(d)
        zs.append(zlib.compress(d, 6))

    t0 = time.perf_counter()
    outs = P.decompress_batch(zs, device=device)  # one batch of launches
    dt = time.perf_counter() - t0
    total = sum(len(d) for d in datas)
    if not all(o == d for o, d in zip(outs, datas)):
        raise AssertionError("a decoded stream differs from its input")
    print(f"decoded {len(zs)} foreign zlib streams ({total} B) in "
          f"{dt:.2f}s on {device} — bit-exact vs zlib")

    # single-stream convenience API
    if P.decompress_to_vec(zs[0], device=device) != datas[0]:
        raise AssertionError("decompress_to_vec differs from the input")
    print("decompress_to_vec: OK")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.demo or not args.files:
        demo(device=args.device)
        return
    streams = []
    for p in args.files:
        with open(p, "rb") as f:
            streams.append(f.read())
    t0 = time.perf_counter()
    outs = P.decompress_batch(streams, device=args.device)
    dt = time.perf_counter() - t0
    for p, o in zip(args.files, outs):
        if isinstance(o, Exception):
            print(f"{p}: {type(o).__name__}")
        else:
            out_path = p + ".out"
            with open(out_path, "wb") as f:
                f.write(o)
            print(f"{p}: {len(o)} bytes -> {out_path}")
    print(f"{dt:.2f}s total")


if __name__ == "__main__":
    main()
