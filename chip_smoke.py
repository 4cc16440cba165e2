"""On-card check of the PyTorch/CUDA port (``fdeflate_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``fdeflate_tpu_torch/csrc`` with nvcc,
holds each kernel bit for bit against its plain PyTorch version on the card,
drives the headline roundtrip (16 Sub-filtered PNG IDAT streams of 1 MiB,
C = 512 fixed-geometry chunks) through the public entry points, checks the
result (zlib.decompress of every stream, decoded bytes, exit bits and
Adler-32), and times the kernels and the encode and decode legs against
their plain versions with CUDA events.

Output: progress lines, then the kernel JSON line, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the exit code is nonzero; without CUDA it exits 1 and prints no
result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np

BATCH, LENGTH, CHUNKS = 16, 1 << 20, 512   # bench.py's headline geometry
KERNEL_REPS, PLAIN_REPS = 10, 3


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
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


def max_abs_err(torch, pairs) -> float:
    """Largest |kernel - plain| over (kernel output, plain output) pairs;
    raises unless each pair has one shape and dtype."""
    err = 0.0
    for got, want in pairs:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
        if got.numel():
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
            err = max(err, float(diff))
    return err


def run_kernels(torch, t, data, lengths, C):
    """Each kernel and its plain version on the same inputs, held equal.

    Returns {name: (kernel fn, plain fn, max_abs_err)}; the fns rerun the
    kernel or its plain version on these inputs (for timing)."""
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack, assign_pack_plain
    from fdeflate_tpu_torch.ops.decode2 import decode2, decode2_plain
    from fdeflate_tpu_torch.ops.repack import combine, combine_plain
    from fdeflate_tpu_torch.ops.ultrafast import (_encode, lane_starts,
                                                  stream_words)

    B, N = data.shape
    W = stream_words(N, t)
    win, bits = assign_pack_plain(data, lengths, C, t)
    pos0 = lane_starts(bits, B, C, t.header_bits)[0].reshape(-1).to(torch.int32)
    words, _tb, _adler, starts, _eof = _encode(
        data, lengths, C, t, assign_pack_plain, combine_plain)
    fns = {
        "assign_pack": (lambda: assign_pack(data, lengths, C, t),
                        lambda: assign_pack_plain(data, lengths, C, t)),
        "combine": (lambda: combine(win, bits, pos0, B, W),
                    lambda: combine_plain(win, bits, pos0, B, W)),
        "decode2": (lambda: decode2(words, starts, t.dtab, N, C),
                    lambda: decode2_plain(words, starts, t.dtab, N, C)),
    }
    out = {}
    for name, (kern, plain) in fns.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(torch, zip(got, want))
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain by {err}")
        out[name] = (kern, plain, err)
    return out


def ragged(data: np.ndarray, lengths) -> np.ndarray:
    data = data.copy()
    for b, n in enumerate(lengths):
        data[b, n:] = 0
    return data


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    import fdeflate_tpu_torch as P
    from fdeflate_tpu_torch import _build
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack, assign_pack_plain
    from fdeflate_tpu_torch.ops.decode2 import decode2, decode2_plain
    from fdeflate_tpu_torch.ops.repack import combine, combine_plain
    from fdeflate_tpu_torch.ops.ultrafast import _encode, encode_ultrafast_batch
    from fdeflate_tpu_torch.parallel.device_pipeline import (_decode_verify,
                                                             decode_verify)
    from fdeflate_tpu_torch.trees import trained_tables

    os.environ.pop("JAX_PLATFORMS", None)   # bench.py imports jax if set
    from bench import make_idat_corpus

    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}  (torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s, nvcc "
          f"{'not run (library up to date)' if _build.build_seconds is None else f'{_build.build_seconds:.1f} s'}",
          flush=True)
    ptxas = _build.BUILD_DIR / "ptxas.log"
    if ptxas.exists():
        print(ptxas.read_text().strip(), flush=True)

    dev = torch.device("cuda")
    t = trained_tables(str(dev))

    # ---- 1. each kernel against its plain version at small geometries ----
    N = 8192
    lens = [N, N - 700, 9]
    small = ragged(make_idat_corpus(3, N, seed=1), lens)
    small[1, :3000] = np.random.default_rng(1).integers(0, 256, 3000)
    run_kernels(torch, t, torch.from_numpy(small).to(dev),
                torch.tensor(lens, dtype=torch.int32, device=dev), 4)
    print("kernels == plain at B=3 N=8192 C=4 ragged [8192, 7492, 9]: ok",
          flush=True)
    wide = make_idat_corpus(4, 1 << 16, seed=2)
    wide[1] = np.random.default_rng(2).integers(0, 256, 1 << 16)
    wide[2, 5000:40000] = 0
    run_kernels(torch, t, torch.from_numpy(wide).to(dev),
                torch.full((4,), 1 << 16, dtype=torch.int32, device=dev), 512)
    print("kernels == plain at B=4 N=65536 C=512 (2048 lanes): ok", flush=True)

    # Corrupted stream: the decode kernel and its plain version still agree.
    sd = torch.from_numpy(small).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    words, _tb, _ad, starts, _eof = encode_ultrafast_batch(sd, sl, 4, t)
    words[0, 100] ^= 0x5A5A5A5A
    errs = max_abs_err(torch, zip(decode2(words, starts, t.dtab, N, 4),
                                  decode2_plain(words, starts, t.dtab, N, 4)))
    if errs != 0:
        raise AssertionError("decode2 differs from plain on a corrupted stream")
    print("decode2 == plain on a corrupted stream: ok", flush=True)

    # The batch API (one lane per stream, symbol index): zlib takes every
    # stream back, and streams and index equal the CPU path's.
    small_in = [r.tobytes() for r in make_idat_corpus(3, 40000, seed=3)]
    small_in += [b"", bytes(1000), small_in[0][:12345]]
    got, index = P.compress_batch_ultra_fast(small_in, with_index=8,
                                             device="cuda")
    if [zlib.decompress(s) for s in got] != small_in:
        raise AssertionError("compress_batch_ultra_fast: zlib roundtrip failed")
    want, want_index = P.compress_batch_ultra_fast(small_in, with_index=8,
                                                   device="cpu")
    if got != want or not np.array_equal(index, want_index):
        raise AssertionError("compress_batch_ultra_fast: cuda != cpu")
    print("compress_batch_ultra_fast(with_index=8): 6/6 zlib.decompress, "
          "streams and index == cpu: ok", flush=True)

    # ---- 2. the main path at the bench geometry, through the entry points --
    corpus = make_idat_corpus(BATCH, LENGTH)
    data = torch.from_numpy(corpus).to(dev)
    lengths = torch.full((BATCH,), LENGTH, dtype=torch.int32, device=dev)
    streams_in = [r.tobytes() for r in corpus]
    torch.cuda.synchronize()
    kernels = {"assign_pack": assign_pack, "combine": combine,
               "decode2": decode2}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    words, total_bits, adler, index, _eof = P.zlib_encode_step(CHUNKS)(
        data, lengths)
    streams = P.finalize_streams(words, total_bits, adler)
    out, bpos_ok, ck_ok = P.fused_zlib_roundtrip(
        CHUNKS, LENGTH, device="cuda")(data, lengths)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"main path ({BATCH} x {LENGTH} B, C={CHUNKS}): {wall:.3f} s wall "
          f"incl. host copies; launches {launches}", flush=True)
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    n_ok = sum(zlib.decompress(s) == streams_in[i] for i, s in enumerate(streams))
    print(f"zlib.decompress: {n_ok}/{len(streams)} streams equal the input",
          flush=True)
    if n_ok != BATCH or index.shape != (BATCH, CHUNKS):
        raise AssertionError("zlib roundtrip failed")
    if not torch.equal(out, data):
        raise AssertionError("decoded bytes differ from the input")
    if not (bool(bpos_ok.all()) and bool(ck_ok.all())):
        raise AssertionError(f"bpos_ok {bpos_ok.tolist()} ck_ok {ck_ok.tolist()}")
    ratio = sum(map(len, streams)) / (BATCH * LENGTH)
    print(f"decoded == input, bpos_ok all, ck_ok all; compressed/raw = {ratio:.4f}",
          flush=True)

    # ---- 3. times at the main path's shapes (card: see the line above) ----
    res = run_kernels(torch, t, data, lengths, CHUNKS)
    rows = []
    sources = {
        "assign_pack": ("fdeflate_tpu_torch/csrc/assign_pack.cu",
                        "fdeflate_tpu/ops/pallas_assign.py:96 (_kernel) + "
                        "fdeflate_tpu/ops/pallas_pack.py:130 (_kernel_v2)"),
        "combine": ("fdeflate_tpu_torch/csrc/combine.cu",
                    "fdeflate_tpu/ops/repack.py:227 (_combine_kernel)"),
        "decode2": ("fdeflate_tpu_torch/csrc/decode2.cu",
                    "fdeflate_tpu/ops/pallas_decode2.py:294 (_kernel_light) + "
                    "fdeflate_tpu/ops/repack.py:126 (_slab_kernel)"),
    }
    for kname, (kern, plain, err) in res.items():
        ms = cuda_ms(torch, kern, KERNEL_REPS)
        plain_ms = cuda_ms(torch, plain, PLAIN_REPS)
        src, repl = sources[kname]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches[kname],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        print(f"{kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"[{card}]", flush=True)

    enc = P.zlib_encode_step(CHUNKS)
    words, _tb, adler, starts, eof = enc(data, lengths)
    legs = {
        "encode": (lambda: enc(data, lengths),
                   lambda: _encode(data, lengths, CHUNKS, t,
                                   assign_pack_plain, combine_plain)),
        "decode": (lambda: decode_verify(
                       words, starts, eof, adler, lengths, LENGTH, CHUNKS, t),
                   lambda: _decode_verify(
                       words, starts, eof, adler, lengths, LENGTH, CHUNKS, t,
                       decode2_plain)),
    }
    mib = BATCH * LENGTH / 2**20
    for leg, (kern, plain) in legs.items():
        ms = cuda_ms(torch, kern, KERNEL_REPS)
        plain_ms = cuda_ms(torch, plain, PLAIN_REPS)
        print(f"{leg} leg: kernels {ms:.4f} ms ({mib / ms * 1e3 / 1024:.3f} GiB/s), "
              f"plain {plain_ms:.4f} ms [{card}]", flush=True)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
