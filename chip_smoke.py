"""On-card check of the PyTorch/CUDA port (``fdeflate_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``fdeflate_tpu_torch/csrc`` with nvcc (one
process per source, all at once) and drives the port's paths:

1-3. The headline roundtrip (16 Sub-filtered PNG IDAT streams of 1 MiB,
     C = 512 fixed-geometry chunks): K1-K3 against their plain versions,
     and K1's and K3's warps on the edge inputs of
     ``fdeflate_tpu_torch/tools/edges.py`` (all zeros, no runs, runs of
     258n-1..258n+1 on segment and tile edges, S = 8 and S = 4, lanes past
     the length, K1 on one 1 MiB lane at C = 1, K3 on streams with 64
     words corrupted each, an EOB spliced into a lane and random chunk
     starts; K2 on lanes of 0 bits, lanes shorter than a word,
     word-aligned starts, the last word's high half at W and trailing
     words); the roundtrip through the public entry points
     (zlib.decompress of every stream, decoded bytes, exit bits,
     Adler-32) with K1, K2, K3 and K7 (the encode's Adler-32) counted;
     ``adler32_batch`` through K7 against its plain body on the corpus
     and on ragged lengths; kernel and leg times, the encode leg split
     into K1, K2, K7 and framing.
4.   K4 inflate_records and K5 validate_headers against their plain
     versions, bit for bit: blocks of a 1 MiB zlib-6 text stream, a Z_FIXED
     block, a block with one distance code and one with none, an invalid
     distance code, a corrupted stream, a budget-exhausted run, and K4's
     edge inputs of tools/edges.py (blocks at levels 1, 6, 9, IDAT and
     Huffman-only with their false candidates, corrupted, too few slots,
     too far, bit_end inside blocks, random starts: lanes ending with every
     exit code 0-5); K5 on all stage-1 survivors of the stream and of
     random bytes, and on two streams' words at once (each candidate
     bounded by its own stream, each stream's answers those it gets
     alone).
5.   The foreign-stream path at the JAX bench's sizes through the entry
     points: 8 MiB word-salad text at zlib 6 and 8 MiB of IDAT bytes at
     zlib 1 through try_foreign, 16 x 1 MiB IDAT streams at zlib 1 through
     decompress_batch (the try_foreign_batch route), and a small mixed
     batch through the sequential route (stored, Z_FIXED, tiny, empty,
     corrupted, truncated).  Every output equals zlib.decompress, the error
     streams give the JAX package's error classes, and the full-size
     streams take the block-parallel route.
6.   Times with CUDA events: K4 and K5 against their plain versions at the
     path's shapes, the foreign leg split into stage 1, stage 2 (K5),
     record decode (host tables + K4 + readback) and stitch (materialize
     + Adler-32), output GB/s per stream kind, host zlib.decompress on the
     same streams, and K4's work per stream (lanes, false candidates,
     records, threads per lane, spans and sync rounds per span); K5's
     launches per ``try_foreign_batch`` call (must be 1), its one call on
     one 1 MiB stream and over the batch's candidates, and the batched
     stage 2.
7.   The septree profile: K6 decode_sep against its plain version on the
     small batches (clean and corrupted) and on its edge inputs (ragged,
     corrupted, an EOB at every sub-step position of a word and at lane,
     tile and last-symbol edges, random starts; its serial lanes exactly
     those whose decode meets an EOB), the 16 x 1 MiB C = 512 roundtrip
     with ``tree=sep_profile()`` through the entry points (zlib.decompress
     of every stream, bytes, exit bits, Adler-32), the sep/trained size
     ratio, K6's spans, sync rounds and serial lanes there, leg times, K6
     and plain K6 times, and K3 timed on the same streams with the sep
     tree's table.
8.   The adaptive tree: ``fused_adaptive_roundtrip`` at the same corpus and
     geometry (bytes, exit bits, Adler-32), the code lengths built on the
     card against the host build, K1 and K3 with the batch's tree against
     their plain versions, tree-build, encode and decode times, and the
     payload bits against the trained tree.
9.   The checksum entry point ``adler32_pallas`` (K7 adler32_tiles) on a
     64 MiB buffer with a length mask, at a size that is not a multiple of
     1024 and on an unaligned view, and K7 on a batch with lengths 0, 1,
     1023, 1025 and N: equal to zlib.adler32, K7's tile sums equal to its
     plain version's; K7 alone, the whole ``adler32_pallas``, the torch
     tile-sum reduction (the yardstick) and the plain version, one call
     and back to back.
10.  The blocked layout at the headline geometry:
     ``fused_ultrafast_roundtrip_v2`` (K1 into lane windows, K3 on each
     window; K2 must not launch), every stream decoded with both checks,
     encode, decode and whole times.
11.  The A/B chain at C = 2048 (S = 512, inside the v1 pack's S <= 630):
     tokens -> ``pack_tokens`` -> K9 pack_v1 -> ``decode_blocked(
     light=False)`` (K8 decode2_canon) -> checks.  K9's windows equal K1's,
     K8's bytes and exit bits equal K3's on the same windows (clean and
     corrupted), K8 and K9 equal their plain versions at full size; K8's
     spans, sync rounds and serial lanes (none on the trained tree), K8
     with runs of base 0 against plain (every lane serial); times of K8,
     K9 and their plain versions beside K1 and K3 at the same C.
12.  K10 combine_grouped (``combine(..., group=8)``) at the headline
     geometry: the encode through it gives 16 streams that zlib.decompress
     takes back; one K10 launch per call and no torch op but allocations
     before it; K10 equals K2 and its plain version; K10 and K2 times, one
     call and back to back.
13.  The indexed chunk-parallel decode at the headline width: the 16 x 1
     MiB corpus through ``compress_batch_ultra_fast(with_index=512)`` (one
     lane per stream: K1 at C = 1, K2, K7) and ``decompress_batch_indexed``
     (K11 decode_symbols once over the 8192 chunk lanes in its live form,
     each lane's records up to its step count, read by
     ``indexed_materialize``); every stream equal to its input and none
     decoded by the fallback (``decompress_batch``);
     ``fused_ultrafast_roundtrip(512, max_steps, N)`` with ``ok``,
     ``checksum_ok``, ``produced == lengths`` and ``out == data``; K11's
     full form (the public ``decode_symbols``, every row) and its live form
     (rows below each lane's step count, the counts, the state) against
     the plain version on the card on all 8192 headline lanes and on its
     edge inputs (tools/edges.py: codes of up to 15 bits through the
     secondary tables, truncation, reads past the last word, corrupted
     fixed-code streams, invalid entries, stacked tables, exhausted
     steps); times of both forms with both bounds (K11's row: the live
     form, the main path's, with the full form's time and bound beside
     it), ``indexed_materialize``, the whole ``indexed_decode_step``, the
     one-lane encode and the whole ``decompress_batch_indexed`` (decoded
     GB/s), and its peak memory.
14.  The matched encoder (general levels 1-3) at the width its users run:
     16 x 1 MiB IDAT through ``compress_batch_device`` at levels 1, 2 and
     3, K7 (its Adler-32) counted once per call; every stream equal under
     zlib.decompress and its Adler-32 from K7 equal to zlib.adler32;
     ``adler32_batch`` (K7) against its plain body on that corpus; the five
     1 MiB size corpora (uniform, low, mixture, distribution, IDAT) through
     levels 1-3 on the card and with ``device="cpu"``, the bytes equal,
     each size beside zlib level 1's; per level the whole call by the host
     clock (input GB/s), each stage by CUDA events (stage 1, the host's
     first-pass trees, stage 1.5 and the host's code lengths per pass, the
     host headers, stage 2, K7 and the read-back), torch ops per stage and
     the peak device memory.  K7's row carries its launches and time here
     (``matched_launches``, ``matched_ms``, per level).

15.  Scale-out at world size 1: ``make_mesh((1, 1))`` starts a one-process
     NCCL group; on the 16 x 1 MiB corpus ``roundtrip_step`` (C = 512,
     phase 13's ``max_steps``), ``roundtrip_step_v2``, ``_zlib`` and
     ``_adaptive`` (C = 512), ``checksum_tree_reduce`` (== zlib.adler32),
     ``sharded_encode_ultrafast`` (its streams through zlib.decompress) and
     ``sharded_decode_symbols`` on those one-lane streams (every lane at
     EOB, its records materialized to the input), each gathered with
     ``full_tensor()`` and equal to the unsharded function on the same
     input; ``foreign_records_step`` on phase 5's 8 MiB text6 blocks staged
     in JAX's lane-blocked layout (every block at EOB, bpos and done equal
     to K4's direct call on the stream); ``dryrun_multichip(1)``,
     ``entry()`` and ``entry_v1()``.  K1, K2, K3, K4, K7 and K11 are
     counted per step (each must launch where the step runs it; their
     rows carry ``mesh_launches``).  Every kernel call a step makes is
     recorded (``recorded``: its arguments and result copied) and held
     bit for bit to the kernel's plain version on the same arguments
     (``hold_calls``; a K11 call of more than ``HELD_STEPS`` steps is run
     again, kernel and plain, at ``HELD_STEPS``); the rows carry
     ``mesh_max_abs_err``.  ``foreign_records_step``'s bpos and done on
     every lane, padding lanes included, equal the plain K4's.  Each
     step's time is printed beside the unsharded function's, in turns
     over ``PAIRS`` pairs with the spread of their differences: the cost
     of the mesh layer and of NCCL at world size 1.

Each path is driven with every kernel's launch count set to 0 just before
it and read just after; a kernel of the path that did not launch fails the
run.  Every kernel's row carries its bound (``bound_ms``, ``bound_by``:
bytes over 3.35 TB/s or int32 operations over 16.75 TOP/s, counted from
this run's inputs, for the work the kernel's function needs) and
``library_ms`` (null: no single PyTorch call computes any of these
functions; K7's row adds the yardstick, ``yardstick_ms``).  Output:
progress lines, then the
kernel JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is nonzero; without CUDA it exits 1 and prints no result.  It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np

BATCH, LENGTH, CHUNKS = 16, 1 << 20, 512   # bench.py's headline geometry
AB_CHUNKS = 2048                            # the A/B chain: S = 512 <= 630
GROUP = 8                                   # K10's lanes per staging
KERNEL_REPS, PLAIN_REPS = 10, 3
FOREIGN_MB = 8                              # bench.py's foreign leg size
CHECKSUM_BYTES = 64 << 20                   # adler32_pallas phase's buffer
MATCHED_BATCH, MATCHED_LENGTH = 16, 1 << 20  # find_matches' widest rows

# The least time the card could take for a kernel's work (``bound_ms``):
# the larger of its bytes over the H100 SXM's 3.35 TB/s of HBM3 and its
# integer operations over the card's int32 rate.  The H100 SXM's published
# peak is 67 TFLOP/s of float32 outside the tensor cores, i.e.
# 128 float32 lanes per SM and an FMA counted as two; an SM has 64 int32
# lanes, so 67 / 4 = 16.75 TOP/s of int32.  Bytes count each input read
# once and each output written once; operations count what the kernel's
# function needs on this run's data, not what its algorithm does (the
# quadratic pair tests of K9's TPU kernel and the per-symbol compare
# chains of K6's and K8's are not counted: the same function has linear or
# table-lookup forms), with the per-item
# costs stated at each kernel's count.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of a kernel's work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, source, replaces, launches, err, ms, plain_ms,
               work) -> dict:
    """One entry of the kernel JSON line; ``work`` = (bytes, operations)
    that the kernel's function needs, whatever algorithm the kernel uses.
    ``library_ms`` is None: no single PyTorch call computes any of the
    port's kernels' functions (each needs bit shifts around a scatter, or
    a decode loop)."""
    bound_ms, bound_by = bound(*work)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def used_words(torch, chunk_bits) -> int:
    """Window words that hold payload, summed over lanes."""
    return int(((chunk_bits.to(torch.int64) + 31) >> 5).sum())


def out_bytes(xs) -> int:
    """Bytes of a kernel's output tensors."""
    return sum(x.numel() * x.element_size() for x in xs)


def symbol_count(torch, data, lengths, S: int) -> int:
    """Deflate symbols the lanes decode (literals and run symbols; the
    token grammar is tree-independent)."""
    from fdeflate_tpu_torch.ops.assign_pack import token_symbols

    return int((token_symbols(data, lengths, S) >= 0).sum())


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events, after a
    warm-up unless ``warm`` is False)."""
    if warm:
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


def back_to_back_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` with ``reps`` calls queued back to
    back between two CUDA events, the median of three such runs.  The host
    queues a call while the card runs the one before, so this is the
    card's time where it exceeds the host's, and the host's otherwise;
    ``cuda_ms`` (one call at a time) adds the host's time before the first
    launch to the card's."""
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


# Ops a wrapper may dispatch besides its launch: allocations and views.
NO_COMPUTE = {"aten.empty.memory_format", "aten.select.int",
              "aten.unsqueeze.default", "aten.view.default"}


def torch_ops(fn):
    """(fn's result, the names of the torch ops it dispatched)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    with Ops() as mode:
        out = fn()
    return out, mode.names


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


def edge_phase(torch, dev):
    """Phase 1's edge inputs of K1's, K2's and K3's warps
    (tools/edges.py): K1 on all zeros, random bytes with no runs, runs of
    258n-1..258n+1 on segment and tile edges, S = 8, lanes past the length
    and one 1 MiB lane at C = 1; K3 on each batch's streams clean, with 64
    words corrupted per stream, with an EOB spliced into a lane, from
    random chunk starts and, at S = 4, on K1's windows and from random
    starts; K2 on lanes of 0 bits, lanes shorter than a word, word-aligned
    starts, the last word's high half at W, trailing words and a mix.
    Every output is held to the plain version's.  Returns the max abs
    errors."""
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack, assign_pack_plain
    from fdeflate_tpu_torch.ops.decode2 import decode2, decode2_plain
    from fdeflate_tpu_torch.ops.repack import combine, combine_plain
    from fdeflate_tpu_torch.tools.edges import (k1_edge_inputs, k1_long_lane,
                                                k2_edge_cases, k3_edge_cases)
    from fdeflate_tpu_torch.trees import trained_tables

    t = trained_tables(str(dev))
    errs = {"assign_pack": 0.0, "decode2": 0.0}
    k3_labels = []
    for label, arr, lens, C in k1_edge_inputs() + [k1_long_lane()]:
        d = torch.from_numpy(arr).to(dev)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        errs["assign_pack"] = max(errs["assign_pack"], check_equal(
            torch, f"assign_pack ({label})", assign_pack(d, ln, C, t),
            assign_pack_plain(d, ln, C, t)))
        if arr.shape[0] * C == 1:
            continue  # one 1 MiB lane: the plain K3 loops once per symbol
        for case, words, starts, dtab, N, Ck, want in k3_edge_cases(d, ln, C):
            got = decode2(words, starts, dtab, N, Ck)
            errs["decode2"] = max(errs["decode2"], check_equal(
                torch, f"decode2 ({label}: {case})", got,
                decode2_plain(words, starts, dtab, N, Ck)))
            if want is not None and not torch.equal(got[0], want):
                raise AssertionError(f"decode2 ({label}: {case}) != input")
            k3_labels.append(f"{label}: {case}")
    print(f"assign_pack == plain on {len(k1_edge_inputs()) + 1} edge batches "
          f"(incl. C = 1 at 1 MiB); decode2 == plain on {len(k3_labels)} "
          f"edge cases {k3_labels}: ok", flush=True)
    errs["combine"] = 0.0
    k2_labels = []
    for label, win, bits, pos0, B, W in k2_edge_cases():
        win, bits, pos0 = (x.to(dev) for x in (win, bits, pos0))
        errs["combine"] = max(errs["combine"], check_equal(
            torch, f"combine ({label})", (combine(win, bits, pos0, B, W),),
            (combine_plain(win, bits, pos0, B, W),)))
        k2_labels.append(label)
    print(f"combine == plain on {len(k2_labels)} edge cases {k2_labels}: ok",
          flush=True)
    return errs


def word_salad(n: int, seed: int = 9) -> bytes:
    """bench.py's foreign-leg text: words of 3-11 random bytes."""
    rng = np.random.default_rng(seed)
    wp = [rng.bytes(int(rng.integers(3, 12))) for _ in range(256)]
    return b"".join(wp[int(rng.integers(256))] for _ in range(n // 7 + 1))[:n]


def small_mixed_batch():
    """The sequential route's batch: (streams, expected), expected = the
    bytes or the JAX package's error class for each stream
    (tests/test_torch_inflate.py holds the classes to the JAX path)."""
    text = word_salad(12000, seed=9)
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
    z = zlib.compress(text, 6)
    corrupt = bytearray(z)
    corrupt[114] ^= 0x55
    return [
        (zlib.compress(text, 0), text),
        (co.compress(text[:3000]) + co.flush(), text[:3000]),
        (zlib.compress(b"hello world" * 3, 6), b"hello world" * 3),
        (zlib.compress(b"", 6), b""),
        (bytes(corrupt), "DistanceTooFarBack"),
        (z[: len(z) // 2], "InsufficientInput"),
        (z[:-1] + bytes([z[-1] ^ 1]), "WrongChecksum"),
    ]


def check_equal(torch, name: str, got, want) -> float:
    """Hold a kernel's outputs against its plain version's; returns the
    max abs difference (0) or raises."""
    err = max_abs_err(torch, zip(got, want))
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain by {err}")
    return err


def foreign_kernel_inputs(torch, dev, make_idat_corpus):
    """Phase 4's K4 lanes over one flat word buffer: every block of a
    1 MiB zlib-6 text stream and of a corrupted copy, a Z_FIXED block, a
    block with one distance code (the port's own encoder), a
    Z_HUFFMAN_ONLY block read with no distance codes, and a text block
    read with no distance codes (an invalid distance code).  Returns
    (K4 args, text stream, text stream's words)."""
    import fdeflate_tpu_torch as P
    from fdeflate_tpu_torch.ops.inflate import fixed_meta_tab, pad_words
    from fdeflate_tpu_torch.ops.inflate_records import (NO_LIMIT,
                                                        block_tables,
                                                        pack_tables)
    from fdeflate_tpu_torch.parallel import discovery as PD

    text = word_salad(1 << 20, seed=5)
    z_text = zlib.compress(text, 6)
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
    z_fixed = co.compress(text[:5000]) + co.flush()
    (z_one,) = P.compress_batch_ultra_fast(
        [make_idat_corpus(1, 1 << 16, seed=4)[0].tobytes()], device=dev)
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_HUFFMAN_ONLY)
    z_huff = co.compress(text[:20000]) + co.flush()
    corrupt = bytearray(z_text)
    corrupt[len(corrupt) // 2] ^= 0xFF
    streams = [z_text, z_fixed, z_one, z_huff, bytes(corrupt)]
    words_np, base = pad_words(streams)

    def parse(z):
        return PD._scan_parse(z, device=dev)

    text_lanes = parse(z_text)
    (one,) = parse(z_one)
    if np.count_nonzero(one[3][288:320]) != 1:
        raise AssertionError("the one-distance-code block has another tree")
    huff = parse(z_huff)[0]
    lanes = []   # (stream, symbol start, (meta, tab), bit_end?, out0)
    for _o, _b, sym, lengths, hlit in text_lanes:
        lanes.append((0, sym, block_tables(lengths, hlit), False, NO_LIMIT))
        lanes.append((4, sym, block_tables(lengths, hlit), True, 0))
    lanes.append((1, 19, fixed_meta_tab(), True, 0))
    lanes.append((2, one[2], block_tables(one[3], one[4]), True, 0))
    for (_o, _b, sym, lengths, hlit), si in ((huff, 3), (text_lanes[0], 0)):
        nodist = lengths.copy()
        nodist[288:320] = 0
        lanes.append((si, sym, block_tables(nodist, hlit), False, NO_LIMIT))
    meta, tab = pack_tables([t for _s, _p, t, _e, _o in lanes], dev)

    def col(vals):
        return torch.tensor(vals, dtype=torch.int64, device=dev)

    args = (torch.from_numpy(words_np).to(dev),
            col([int(base[si]) * 32 + sym for si, sym, *_ in lanes]),
            col([int(base[si + 1]) for si, *_ in lanes]),
            col([int(base[si]) * 32 + len(streams[si]) * 8 if cut else NO_LIMIT
                 for si, _s, _t, cut, _o in lanes]),
            col([o for *_, o in lanes]), meta, tab)
    return args, z_text, PD.stage_words(z_text, device=dev)


def foreign_split(torch, P, PD, z: bytes, dev):
    """Times of the foreign leg's pieces on one stream (CUDA events, ms),
    output GB/s in the device-resident contract, and host zlib GB/s."""
    wd = PD.stage_words(z, device=dev)
    t = {"stage 1": cuda_ms(torch, lambda: PD.scan_stage1_device(
        z, device=dev, words=wd), 3)}
    c1 = PD.scan_stage1_device(z, device=dev, words=wd)
    t["stage 2 (K5)"] = cuda_ms(torch, lambda: PD.validate_stage2_device(
        z, c1, words_dev=wd, device=dev), 3)
    scan = cuda_ms(torch, lambda: PD._scan_parse(z, words_dev=wd,
                                                 device=dev), 3)
    t["host header parse"] = scan - t["stage 1"] - t["stage 2 (K5)"]
    lanes = PD._scan_parse(z, words_dev=wd, device=dev)
    L = len(lanes)
    bounds = (np.full(L, wd.numel()), np.full(L, len(z) * 8))
    t["record decode (tables + K4 + readback)"] = cuda_ms(
        torch, lambda: PD._lane_decode(lanes, 6144, wd, *bounds), 3)
    recs, bpos, eob, nout = PD._lane_decode(lanes, 6144, wd, *bounds)
    chain, _final = PD._chain(lanes, 0, L, bpos, eob)
    mask = np.zeros(L, bool)
    mask[chain] = True
    produced = [int(nout[chain].sum())]
    t["stitch (materialize + Adler-32)"] = cuda_ms(
        torch, lambda: PD._stitch(recs, mask, [(0, L)], produced), 3)
    total = cuda_ms(torch, lambda: P.try_foreign(
        z, words_dev=wd, return_device=True, device=dev), 3)
    host = min(timed(lambda: zlib.decompress(z)) for _ in range(3))
    return t, total, host, L, (lanes, wd, bounds, c1)


def k4_report(torch, PD, lanes, wd, bounds, K: int) -> str:
    """K4's work on one stream's lanes: lanes, records, threads per lane
    (the kernel's fdt::inf_threads of each lane's hint), spans and sync
    rounds (the kernel's counters), and false-candidate lanes (lanes that
    are not links of the confirmed chain)."""
    from fdeflate_tpu_torch.ops.inflate_records import DONE_EOB, inflate_records

    args = PD.lane_inputs(lanes, wd, *bounds)
    stats = torch.zeros(4, dtype=torch.int64, device=wd.device)
    recs, bpos, _nout, done = inflate_records(*args, K, stats=stats)
    start = args[1].cpu().numpy()
    end = np.minimum(args[2].cpu().numpy() * 32, args[3].cpu().numpy())
    nxt = np.append(start[1:], -1)
    end = np.where((nxt > start) & (nxt < end), nxt, end)
    m = np.ones_like(start)
    while ((m < 32) & (1024 * m < end - start)).any():
        m = np.where((m < 32) & (1024 * m < end - start), 2 * m, m)
    L = len(lanes)
    walk = PD._chain(lanes, 0, L, bpos.cpu().numpy(),
                     done.cpu().numpy() == DONE_EOB)
    chain = 0 if walk is None else len(walk[0])
    s = stats.tolist()
    ms = dict(zip(*(x.tolist() for x in np.unique(m, return_counts=True))))
    return (f"{L} lanes ({L - chain} false candidates), "
            f"{int((recs != 0).sum())} records, threads per lane {ms}, "
            f"{s[1]} spans ({s[2]} continued by another), sync rounds "
            f"{s[3] / max(s[1], 1):.3f} per span, at most {s[0]}")


def k5_batch_report(torch, P, PD, batch, dev, card) -> int:
    """K5 on a batch: its launches in one ``try_foreign_batch`` call (must
    be 1), its one-call time on one 1 MiB stream of the batch, the one
    launch over the batch's candidates, and the whole batched stage 2
    (host concatenation, upload, K5, read-back).  Returns the launches."""
    from fdeflate_tpu_torch.ops.inflate import pad_words
    from fdeflate_tpu_torch.ops.validate_headers import validate_headers

    torch.cuda.synchronize()
    validate_headers.launches = 0
    P.try_foreign_batch(batch, device=dev)
    launches = validate_headers.launches
    if launches != 1:
        raise AssertionError(f"try_foreign_batch launched K5 {launches} times")
    w1 = PD.stage_words(batch[0], device=dev)
    c1 = torch.from_numpy(PD.scan_stage1_device(batch[0], device=dev,
                                                words=w1)).to(dev)
    one = cuda_ms(torch, lambda: validate_headers(w1, c1, len(batch[0]) * 8),
                  KERNEL_REPS)
    words_np, base = pad_words(batch)
    words = torch.from_numpy(words_np).to(dev)
    surv = {si: PD.scan_stage1_device(
        z, device=dev, words=words[base[si]:base[si + 1]])
        for si, z in enumerate(batch)}
    c, we, nb = torch.from_numpy(PD.stage2_batch_inputs(batch, surv, base)).to(dev)
    launch = cuda_ms(torch, lambda: validate_headers(words, c, nb, wend=we),
                     KERNEL_REPS)
    whole = cuda_ms(torch, lambda: PD.validate_stage2_batch(
        batch, surv, words, base), KERNEL_REPS)
    print(f"K5 in try_foreign_batch of {len(batch)} x 1 MiB idat1: "
          f"{launches} launch per call over {c.numel()} candidates, "
          f"{launch:.4f} ms one call; batched stage 2 (concatenation, "
          f"upload, K5, read-back) {whole:.4f} ms; K5 on one 1 MiB stream "
          f"({c1.numel()} candidates) {one:.4f} ms [{card}]", flush=True)
    return launches


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def ragged(data: np.ndarray, lengths) -> np.ndarray:
    data = data.copy()
    for b, n in enumerate(lengths):
        data[b, n:] = 0
    return data


def kernel_inputs(make_idat_corpus):
    """The small batches every kernel is held to its plain version on:
    [(label, u8[B, N], lengths, C)], one ragged, one wide."""
    N = 8192
    lens = [N, N - 700, 9]
    small = ragged(make_idat_corpus(3, N, seed=1), lens)
    small[1, :3000] = np.random.default_rng(1).integers(0, 256, 3000)
    wide = make_idat_corpus(4, 1 << 16, seed=2)
    wide[1] = np.random.default_rng(2).integers(0, 256, 1 << 16)
    wide[2, 5000:40000] = 0
    return [(f"B=3 N={N} C=4 ragged {lens}", small, lens, 4),
            ("B=4 N=65536 C=512 (2048 lanes)", wide, [1 << 16] * 4, 512)]


def sep_phase(torch, P, dev, data, lengths, streams_in, streams_trained,
              inputs, card):
    """Phase 7, the septree profile: K6 against its plain version on the
    small batches (clean and corrupted, every lane's bytes and exit bit)
    and on its edge inputs (``edges.k6_edge_cases``: the K1 edge batches
    encoded with the sep tree, ragged, corrupted, an EOB at every sub-step
    position of a word and at lane, tile and last-symbol edges, random
    starts), its serial lanes exactly those whose decode meets an EOB; the
    sep roundtrip through the entry points with K1, K2 and K6 counted; then
    K6 at the path's shapes (its spans, sync rounds and serial lanes) and
    the sep times beside K3's with the sep table.  Returns K6's row."""
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack
    from fdeflate_tpu_torch.ops.decode2 import decode2
    from fdeflate_tpu_torch.ops.decode_sep import (decode_sep,
                                                   decode_sep_plain,
                                                   decode_sep_plain_eob)
    from fdeflate_tpu_torch.ops.repack import combine
    from fdeflate_tpu_torch.tools.edges import k1_edge_inputs, k6_edge_cases
    from fdeflate_tpu_torch.trees import profile_tables, sep_tables

    sep = P.sep_profile()
    meta, vals = sep_tables(sep.lens, dev)
    err = 0.0

    def held(label, words, starts, meta, vals, N, C, want=None):
        """K6 against its plain version: bytes, exit bits, and its serial
        lanes exactly those whose decode meets an EOB.  Returns the stats."""
        stats = torch.zeros(5, dtype=torch.int64, device=dev)
        got = decode_sep(words, starts, meta, vals, N, C, stats=stats)
        out, bpos, eob = decode_sep_plain_eob(words, starts, meta, vals, N,
                                              C)
        torch.cuda.synchronize()
        nonlocal err
        err = max(err, check_equal(torch, f"decode_sep ({label})", got,
                                   (out, bpos)))
        if int(stats[4]) != int(eob.sum()):
            raise AssertionError(f"decode_sep ({label}): {int(stats[4])} "
                                 f"lanes serial, {int(eob.sum())} meet an EOB")
        if want is not None and not torch.equal(got[0], want):
            raise AssertionError(f"decode_sep ({label}): bytes != input")
        return stats

    edge_labels, edge_serial = [], 0
    for label, arr, lens, C in k1_edge_inputs():
        d = torch.from_numpy(arr).to(dev)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        for case, *args in k6_edge_cases(d, ln, C, sep):
            edge_serial += int(held(f"{label}: {case}", *args)[4])
            edge_labels.append(f"{label}: {case}")
    print(f"decode_sep == plain on {len(edge_labels)} edge cases "
          f"{edge_labels}; {edge_serial} lanes decoded serially, each one "
          f"whose decode meets an EOB: ok", flush=True)
    for label, arr, lens, C in inputs:
        d = torch.from_numpy(arr).to(dev)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        words, _tb, _ad, starts, _eof = P.zlib_encode_step(C, tree=sep)(d, ln)
        for corrupt in (False, True):
            if corrupt:
                words = words.clone()
                words[0, 100] ^= 0x5A5A5A5A
            held(label, words, starts, meta, vals, arr.shape[1], C,
                 None if corrupt else d)
        print(f"decode_sep == plain at {label}, clean and corrupted (every "
              f"lane's bytes and exit bit): ok", flush=True)

    B, N = data.shape
    kernels = {"assign_pack": assign_pack, "combine": combine,
               "decode_sep": decode_sep}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    enc = P.zlib_encode_step(CHUNKS, tree=sep)
    words, total_bits, adler, starts, eof = enc(data, lengths)
    streams = P.finalize_streams(words, total_bits, adler)
    out, bpos_ok, ck_ok = P.fused_zlib_roundtrip(
        CHUNKS, N, tree=sep, device=dev)(data, lengths)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"sep path ({B} x {N} B, C={CHUNKS}, tree=sep_profile()): "
          f"{wall:.3f} s wall incl. host copies; launches {launches}",
          flush=True)
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the sep path was not launched: {launches}")
    n_ok = sum(zlib.decompress(s) == streams_in[i] for i, s in enumerate(streams))
    print(f"sep zlib.decompress: {n_ok}/{len(streams)} streams equal the input",
          flush=True)
    if n_ok != B:
        raise AssertionError("sep zlib roundtrip failed")
    if not torch.equal(out, data):
        raise AssertionError("sep: decoded bytes differ from the input")
    if not (bool(bpos_ok.all()) and bool(ck_ok.all())):
        raise AssertionError(f"sep: bpos_ok {bpos_ok.tolist()} ck_ok {ck_ok.tolist()}")
    ratio = sum(map(len, streams)) / sum(map(len, streams_trained))
    print(f"sep decoded == input, bpos_ok all, ck_ok all; sep/trained "
          f"compressed size = {ratio:.6f}", flush=True)

    stats = held("sep path", words, starts, meta, vals, N, CHUNKS, data)
    s_ = stats.tolist()
    print(f"decode_sep (K6) at {B} x {N} B, C={CHUNKS}: {s_[1]} spans ({s_[2]} "
          f"continued by another), sync rounds {s_[3] / max(s_[1], 1):.3f} "
          f"per span, at most {s_[0]}; {s_[4]} lanes decoded serially",
          flush=True)
    dec = P.zlib_decode_step(CHUNKS, N, tree=sep)
    enc_ms = cuda_ms(torch, lambda: enc(data, lengths), KERNEL_REPS)
    dec_ms = cuda_ms(torch, lambda: dec(words, starts, eof, adler, lengths),
                     KERNEL_REPS)
    ms = cuda_ms(torch, lambda: decode_sep(words, starts, meta, vals, N,
                                           CHUNKS), KERNEL_REPS)
    plain_ms = cuda_ms(torch, lambda: decode_sep_plain(
        words, starts, meta, vals, N, CHUNKS), PLAIN_REPS)
    # K3 (the canonical-table kernel) on the same sep streams, with the sep
    # tree's 4096-entry table: whether the class-separated design pays here.
    dtab = profile_tables(sep, str(dev)).dtab
    k3_same = torch.equal(decode2(words, starts, dtab, N, CHUNKS)[0], data)
    k3_ms = cuda_ms(torch, lambda: decode2(words, starts, dtab, N, CHUNKS),
                    KERNEL_REPS)
    mib = B * N / 2**20
    print(f"sep encode leg {enc_ms:.4f} ms ({mib / enc_ms * 1e3 / 1024:.3f} "
          f"GiB/s), decode leg {dec_ms:.4f} ms ({mib / dec_ms * 1e3 / 1024:.3f} "
          f"GiB/s); decode_sep (K6): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms; K3 with the sep table on the same streams {k3_ms:.4f} ms "
          f"(bytes == input: {k3_same}) [{card}]", flush=True)
    L = B * CHUNKS
    nw = int(((eof.to(torch.int64) + 31) >> 5).sum())
    syms = symbol_count(torch, data, lengths, N // CHUNKS)
    # per symbol, K3's count of the same function: peek, look up, three
    # fields, shift, count, store (8)
    work = (4 * nw + 8 * L + 4 * 96 + B * N, 8 * syms)
    return kernel_row("decode_sep", "fdeflate_tpu_torch/csrc/decode_sep.cu",
                      "fdeflate_tpu/ops/pallas_decode2.py:704 (_kernel_sep) "
                      "+ fdeflate_tpu/ops/repack.py:126 (_slab_kernel)",
                      launches["decode_sep"], err, ms, plain_ms, work)


def adaptive_phase(torch, P, dev, data, lengths, card):
    """Phase 8, the adaptive tree: the roundtrip through the entry point
    with K1 and K3 counted, the tree built on the card against the same
    build on the host, K1 and K3 with the batch's tree against their plain
    versions, and the tree-build, encode and decode times.  Returns the
    max abs errors of K1 and K3 with that tree."""
    from fdeflate_tpu_torch.ops import adaptive as PA
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack, assign_pack_plain
    from fdeflate_tpu_torch.ops.decode2 import decode2, decode2_plain
    from fdeflate_tpu_torch.trees import canonical_codes, code_tables, trained_tables

    B, N = data.shape
    S = N // CHUNKS
    step = P.fused_adaptive_roundtrip(CHUNKS, N, device=dev)
    kernels = {"assign_pack": assign_pack, "decode2": decode2}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out, bpos_ok, ck_ok, total_bits = step(data, lengths)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"adaptive path ({B} x {N} B, C={CHUNKS}): {wall:.3f} s wall; "
          f"launches {launches}", flush=True)
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the adaptive path was not launched: {launches}")
    if not torch.equal(out, data):
        raise AssertionError("adaptive: decoded bytes differ from the input")
    if not (bool(bpos_ok.all()) and bool(ck_ok.all())):
        raise AssertionError(f"adaptive: bpos_ok {bpos_ok.tolist()} ck_ok {ck_ok.tolist()}")

    freqs = PA.symbol_freqs(data, lengths, S)
    lens_card = PA.code_lengths_dp(freqs)
    if not torch.equal(lens_card.cpu(), PA.code_lengths_dp(freqs.cpu())):
        raise AssertionError("adaptive: code lengths on the card != on the host")
    win, _cb, _ad, _lens, ta = PA.encode_adaptive_blocked(data, lengths, CHUNKS)
    starts = torch.zeros(B * CHUNKS, 1, dtype=torch.int32, device=dev)
    errs = {
        "assign_pack": check_equal(
            torch, "assign_pack (adaptive tree)",
            assign_pack(data, lengths, CHUNKS, ta),
            assign_pack_plain(data, lengths, CHUNKS, ta)),
        "decode2": check_equal(
            torch, "decode2 (adaptive tree)", decode2(win, starts, ta.dtab, S, 1),
            decode2_plain(win, starts, ta.dtab, S, 1)),
    }
    trained = assign_pack(data, lengths, CHUNKS, trained_tables(str(dev)))[1]
    trained_bits = int(trained.to(torch.int64).sum())
    print(f"adaptive decoded == input, bpos_ok all, ck_ok all; lengths on the "
          f"card == host; K1, K3 with the batch's tree == plain; payload bits "
          f"{int(total_bits)} adaptive, {trained_bits} trained "
          f"(ratio {int(total_bits) / trained_bits:.6f})", flush=True)

    def build():
        lens = PA.code_lengths_dp(PA.symbol_freqs(data, lengths, S))
        return code_tables(canonical_codes(lens)[0], lens)

    build_ms = cuda_ms(torch, build, 3)
    dp_ms = cuda_ms(torch, lambda: PA.code_lengths_dp(freqs), 3)
    enc_ms = cuda_ms(torch, lambda: PA.encode_adaptive_blocked(
        data, lengths, CHUNKS), 3)
    k3_ms = cuda_ms(torch, lambda: decode2(win, starts, ta.dtab, S, 1),
                    KERNEL_REPS)
    rt_ms = cuda_ms(torch, lambda: step(data, lengths), 3)
    print(f"adaptive tree build (freqs + DP + tables) {build_ms:.4f} ms (DP "
          f"alone {dp_ms:.4f} ms); encode (build + K1) {enc_ms:.4f} ms; K3 on "
          f"the lane windows {k3_ms:.4f} ms; whole roundtrip {rt_ms:.4f} ms "
          f"[{card}]", flush=True)
    return errs


def checksum_phase(torch, P, dev, card, main_launches):
    """Phase 9, the checksum entry point and K7's batch: adler32_pallas on
    a 64 MiB buffer with a length mask, at a size that is not a multiple
    of 1024 and on an unaligned view, and K7 on a batch with lengths 0, 1,
    1023, 1025 and N, with K7 counted (one launch a call) and held to
    zlib.adler32, its tile sums to the plain version's; then K7 alone,
    the whole adler32_pallas, the torch tile-sum reduction (the
    yardstick: one call, half of the function) and the plain version, one
    call and back to back.  Returns K7's row, with its main-path launches
    ``main_launches``."""
    from fdeflate_tpu_torch.ops.adler32_pallas import (adler32_checksums,
                                                       adler32_tiles,
                                                       adler32_tiles_plain,
                                                       fold_tiles)

    n = CHECKSUM_BYTES
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    buf = torch.randint(0, 256, (n,), generator=gen, dtype=torch.uint8,
                        device=dev)
    host = buf.cpu().numpy()
    view, N = min(5000001, n - 3), 70001
    rows = buf[5:5 + 6 * (N + 3)].reshape(6, N + 3)[:, :N]
    row_lens = [0, 1, 1023, 1025, N, 4096]
    cases = [("64 MiB, length 64 MiB - 12345", buf[None], [n - 12345],
              host[None]),
             ("64 MiB - 777 B, whole", buf[None, : n - 777], [n - 777],
              host[None, : n - 777]),
             (f"unaligned view of {view} B", buf[None, 3:3 + view], [view],
              host[None, 3:3 + view]),
             (f"6 unaligned rows of {N} B, lengths {row_lens}", rows,
              row_lens, rows.cpu().numpy())]
    torch.cuda.synchronize()
    adler32_tiles.launches = 0
    got = [P.adler32_pallas(x[0], ln[0]) for _l, x, ln, _h in cases[:3]]
    lens = [torch.tensor(ln, dtype=torch.int64, device=dev)
            for _l, _x, ln, _h in cases]
    tiles = [(torch.empty(x.shape[0], -(-x.shape[1] // 1024),
                          dtype=torch.int32, device=dev),
              torch.empty(x.shape[0], -(-x.shape[1] // 1024),
                          dtype=torch.int32, device=dev))
             for _l, x, _ln, _h in cases]
    batch = [adler32_checksums(x, lt, *sw)
             for (_l, x, _ln, _h), lt, sw in zip(cases, lens, tiles)]
    torch.cuda.synchronize()
    launches = adler32_tiles.launches
    if launches != len(cases) + 3:
        raise AssertionError(f"adler32_tiles launched {launches} times for "
                             f"{len(cases) + 3} calls")
    err = 0.0
    for k, (label, x, ln, h) in enumerate(cases):
        want = [zlib.adler32(h[b, :ln[b]].tobytes()) for b in range(len(ln))]
        if batch[k].tolist() != want or (k < 3 and int(got[k]) != want[0]):
            raise AssertionError(f"K7 {label}: {batch[k].tolist()} != {want}")
        plain = adler32_tiles_plain(x, lens[k])
        err = max(err, check_equal(torch, f"adler32_tiles {label}",
                                   tiles[k], plain))
        if not torch.equal(fold_tiles(*plain, lens[k]), batch[k]):
            raise AssertionError(f"K7 {label}: != the plain fold")
    print(f"adler32_pallas and K7's batch == zlib.adler32 on "
          f"{[c[0] for c in cases]}; tile sums == plain; one launch a call: "
          f"ok", flush=True)
    lt = torch.tensor([n - 12345], dtype=torch.int64, device=dev)
    fns = {
        "K7 alone": lambda: adler32_checksums(buf[None], lt),
        "adler32_pallas": lambda: P.adler32_pallas(buf, lt),
        "yardstick": lambda: torch.sum(buf.view(-1, 1024), 1,
                                       dtype=torch.int32),
    }
    one = {k: cuda_ms(torch, fn, KERNEL_REPS) for k, fn in fns.items()}
    queued = {k: back_to_back_ms(torch, fn, KERNEL_REPS)
              for k, fn in fns.items()}
    def plain():
        return fold_tiles(*adler32_tiles_plain(buf, lt), lt)

    plain_ms = cuda_ms(torch, plain, PLAIN_REPS)
    plain_queued = back_to_back_ms(torch, plain, PLAIN_REPS)
    host_s = min(timed(lambda: zlib.adler32(host)) for _ in range(3))
    print("checksum at 64 MiB: " + "; ".join(
        f"{k} {one[k]:.4f} ms one call ({queued[k]:.4f} back to back)"
        for k in fns) + f"; plain {plain_ms:.4f} ms ({plain_queued:.4f}); "
          f"K7 {n / queued['K7 alone'] / 1e6:.3f} GB/s back to back; host "
          f"zlib.adler32 {host_s * 1e3:.4f} ms [{card}]", flush=True)
    # per byte: plain sum, weighted sum, weight (3); the length in, the
    # checksum out
    work = (n - 12345 + 16, 3 * (n - 12345))
    row = kernel_row("adler32_tiles",
                     "fdeflate_tpu_torch/csrc/adler32_tiles.cu",
                     "fdeflate_tpu/ops/adler32_pallas.py:32 (_tile_kernel)",
                     main_launches, err, one["K7 alone"], plain_ms, work)
    row["yardstick_ms"] = one["yardstick"]
    return row


def v2_phase(torch, P, dev, data, lengths, card):
    """Phase 10, the blocked-layout roundtrip at the headline geometry:
    ``fused_ultrafast_roundtrip_v2`` with K1 and K3 counted and K2 held at
    no launch, every stream decoded to its input with both checks, and the
    encode, decode and whole times."""
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack
    from fdeflate_tpu_torch.ops.decode2 import decode2, decode_blocked
    from fdeflate_tpu_torch.ops.repack import combine
    from fdeflate_tpu_torch.ops.ultrafast import encode_ultrafast_blocked
    from fdeflate_tpu_torch.parallel.device_pipeline import _checks

    B, N = data.shape
    S = N // CHUNKS
    step = P.fused_ultrafast_roundtrip_v2(CHUNKS, N, device=dev)
    kernels = {"assign_pack": assign_pack, "decode2": decode2,
               "combine": combine}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out, bpos_ok, ck_ok = step(data, lengths)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"v2 path ({B} x {N} B, C={CHUNKS}, fused_ultrafast_roundtrip_v2): "
          f"{wall:.3f} s wall; launches {launches}", flush=True)
    if not (launches["assign_pack"] > 0 and launches["decode2"] > 0):
        raise AssertionError(f"a kernel of the v2 path was not launched: {launches}")
    if launches["combine"] != 0:
        raise AssertionError("the v2 path launched K2 (it has no linear words)")
    if not torch.equal(out, data):
        raise AssertionError("v2: decoded bytes differ from the input")
    if not (bool(bpos_ok.all()) and bool(ck_ok.all())):
        raise AssertionError(f"v2: bpos_ok {bpos_ok.tolist()} ck_ok {ck_ok.tolist()}")

    win, cb, adler = encode_ultrafast_blocked(data, lengths, CHUNKS)

    def decode():
        o, bp = decode_blocked(win, S // 4)
        return _checks(o.reshape(B, N), bp.reshape(B, CHUNKS), cb, lengths,
                       adler, CHUNKS)

    enc_ms = cuda_ms(torch, lambda: encode_ultrafast_blocked(
        data, lengths, CHUNKS), KERNEL_REPS)
    dec_ms = cuda_ms(torch, decode, KERNEL_REPS)
    whole_ms = cuda_ms(torch, lambda: step(data, lengths), KERNEL_REPS)
    mib = B * N / 2**20
    print(f"v2 decoded == input, bpos_ok all, ck_ok all; encode "
          f"(encode_ultrafast_blocked) {enc_ms:.4f} ms, decode "
          f"(decode_blocked + checks) {dec_ms:.4f} ms, whole step "
          f"{whole_ms:.4f} ms ({mib / whole_ms * 1e3 / 1024:.3f} GiB/s) "
          f"[{card}]", flush=True)


def ab_phase(torch, P, dev, data, lengths, card):
    """Phase 11, the A/B chain at C = 2048: assign_tokens -> pack_tokens ->
    K9 -> ``decode_blocked(light=False)`` (K8) -> checks, with K8 and K9
    counted.  K9's windows equal K1's, K8's bytes and exit bits equal K3's
    on the same windows, each kernel equals its plain version (full size,
    and K8 on corrupted windows); K8's spans, sync rounds and serial lanes
    (none on the trained tree), and K8 with a table that breaks K3's
    protocol against plain, every lane serial.  Returns the rows of K8 and
    K9."""
    from fdeflate_tpu_torch.ops.adler32 import adler32_batch
    from fdeflate_tpu_torch.ops.assign_pack import (assign_pack,
                                                    assign_tokens, wwin)
    from fdeflate_tpu_torch.ops.decode2 import (canon_tables, decode2,
                                                decode2_canon,
                                                decode2_canon_plain,
                                                decode_blocked)
    from fdeflate_tpu_torch.ops.pack import (encode_blocked_v1, pack_blocked,
                                             pack_blocked_plain, pack_tokens,
                                             token_offsets)
    from fdeflate_tpu_torch.parallel.device_pipeline import _checks
    from fdeflate_tpu_torch.tools.edges import k8_unsafe_packed
    from fdeflate_tpu_torch.trees import trained_tables

    B, N = data.shape
    C = AB_CHUNKS
    S, L = N // C, B * C
    T, ww = S // 4, wwin(S)
    t = trained_tables(str(dev))
    kernels = {"pack_v1": pack_blocked, "decode2_canon": decode2_canon}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    win, bits = encode_blocked_v1(data, lengths, C, t)
    out, bpos = decode_blocked(win, T, light=False)
    bpos_ok, ck_ok = _checks(out.reshape(B, N), bpos.reshape(B, C),
                             bits.reshape(B, C), lengths,
                             adler32_batch(data, lengths), C)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"A/B chain ({B} x {N} B, C={C}, S={S}): {wall:.3f} s wall; "
          f"launches {launches}", flush=True)
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the A/B chain was not launched: {launches}")
    if not torch.equal(out.reshape(B, N), data):
        raise AssertionError("A/B chain: decoded bytes differ from the input")
    if not (bool(bpos_ok.all()) and bool(ck_ok.all())):
        raise AssertionError(f"A/B: bpos_ok {bpos_ok.tolist()} ck_ok {ck_ok.tolist()}")
    k1_win, k1_bits = assign_pack(data, lengths, C, t)
    if not (torch.equal(win, k1_win) and torch.equal(bits, k1_bits)):
        raise AssertionError("K9's windows differ from K1's at C = 2048")
    starts = torch.zeros(L, 1, dtype=torch.int32, device=dev)
    k3 = decode2(win, starts, t.dtab, S, 1)
    if not (torch.equal(out, k3[0]) and torch.equal(bpos, k3[1].reshape(L))):
        raise AssertionError("K8's bytes or exit bits differ from K3's")

    v, nb, _ = assign_tokens(data, lengths, S, t)
    tok = pack_tokens(v, nb, token_offsets(nb, C), C)
    meta, packed = canon_tables(str(dev))
    err9 = check_equal(torch, "pack_v1", (pack_blocked(tok, ww),),
                       (pack_blocked_plain(tok, ww),))
    corrupt = win.clone()
    corrupt[::997, 7] ^= 0x5A5A5A5A
    corrupt[5::1001, 0] ^= 0x7FFFFFFF
    err8 = max(check_equal(torch, f"decode2_canon {label}",
                           decode2_canon(w, T, meta, packed),
                           decode2_canon_plain(w, T, meta, packed))
               for label, w in (("clean", win), ("corrupted", corrupt)))
    got = decode2_canon(corrupt, T, meta, packed)
    want = decode2(corrupt, starts, t.dtab, S, 1)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1].reshape(L))):
        raise AssertionError("K8 differs from K3 on corrupted windows")
    print(f"A/B decoded == input, bpos_ok all, ck_ok all; K9 windows == K1's; "
          f"K8 bytes and exit bits == K3's (clean and corrupted); K8, K9 == "
          f"plain at full size: ok", flush=True)
    stats = torch.zeros(5, dtype=torch.int64, device=dev)
    decode2_canon(win, T, meta, packed, stats=stats)
    s_ = stats.tolist()
    print(f"decode2_canon (K8) at {B} x {N} B, C={C}: {s_[1]} spans ({s_[2]} "
          f"continued by another), sync rounds {s_[3] / max(s_[1], 1):.3f} "
          f"per span, at most {s_[0]}; {s_[4]} lanes decoded serially",
          flush=True)
    if s_[4] != 0 or s_[1] < L:
        raise AssertionError(f"K8 on the trained tree: stats {s_}")
    # A table that breaks K3's protocol (runs of base 0): every lane serial.
    bad = k8_unsafe_packed(packed, "run of base 0")
    stats.zero_()
    sub = win[: 4 * 1024]
    err8 = max(err8, check_equal(torch, "decode2_canon (runs of base 0)",
                                 decode2_canon(sub, T, meta, bad, stats=stats),
                                 decode2_canon_plain(sub, T, meta, bad)))
    if int(stats[4]) != sub.shape[0] or int(stats[1]) != 0:
        raise AssertionError(f"K8 on runs of base 0: stats {stats.tolist()}")
    print(f"decode2_canon with runs of base 0 == plain on {sub.shape[0]} "
          f"lanes, each decoded serially: ok", flush=True)

    ms = {
        "pack_v1": cuda_ms(torch, lambda: pack_blocked(tok, ww), KERNEL_REPS),
        "decode2_canon": cuda_ms(torch, lambda: decode2_canon(
            win, T, meta, packed), KERNEL_REPS),
        "assign_pack": cuda_ms(torch, lambda: assign_pack(data, lengths, C, t),
                               KERNEL_REPS),
        "decode2": cuda_ms(torch, lambda: decode2(win, starts, t.dtab, S, 1),
                           KERNEL_REPS),
        "chain encode": cuda_ms(torch, lambda: encode_blocked_v1(
            data, lengths, C, t), PLAIN_REPS),
    }
    plain = {
        "pack_v1": cuda_ms(torch, lambda: pack_blocked_plain(tok, ww),
                           PLAIN_REPS),
        "decode2_canon": cuda_ms(torch, lambda: decode2_canon_plain(
            win, T, meta, packed), PLAIN_REPS),
    }
    print(f"A/B at C={C}: K9 pack_v1 {ms['pack_v1']:.4f} ms (plain "
          f"{plain['pack_v1']:.4f}), K1 assign_pack {ms['assign_pack']:.4f} "
          f"ms; K8 decode2_canon {ms['decode2_canon']:.4f} ms (plain "
          f"{plain['decode2_canon']:.4f}), K3 decode2 on the same windows "
          f"{ms['decode2']:.4f} ms; chain encode (tokens + K9) "
          f"{ms['chain encode']:.4f} ms [{card}]", flush=True)
    nw = used_words(torch, bits)
    syms = symbol_count(torch, data, lengths, S)
    return [
        # The function is the lane windows from the tokens, linear work (K1
        # builds the same windows): per token, three fields (3); per pair,
        # merge, split into two words, two ORs (5).
        kernel_row("pack_v1", "fdeflate_tpu_torch/csrc/pack_v1.cu",
                   "fdeflate_tpu/ops/pallas_pack.py:35 (_kernel)",
                   launches["pack_v1"], err9, ms["pack_v1"], plain["pack_v1"],
                   (4 * L * S + 4 * L * ww, 3 * L * S + 5 * L * (S // 2))),
        # per symbol, K3's count of the same contract: peek, look up, three
        # fields, shift, count, store (8)
        kernel_row("decode2_canon", "fdeflate_tpu_torch/csrc/decode2_canon.cu",
                   "fdeflate_tpu/ops/pallas_decode2.py:166 (_kernel)",
                   launches["decode2_canon"], err8, ms["decode2_canon"],
                   plain["decode2_canon"],
                   (4 * nw + 4 * (32 + 512) + B * N + 4 * L, 8 * syms)),
    ]


def grouped_phase(torch, P, dev, data, lengths, streams_in, card):
    """Phase 12, K10 at the headline geometry: the encode with
    ``combine(..., group=8)`` (K10 counted) gives 16 streams that
    zlib.decompress takes back; one K10 launch per ``combine(group=8)``
    call, and no torch op but allocations and views in it (the slab
    search is on the card); K10 equals K2 and its plain version on K1's
    windows; K10's whole call and K2, one call and back to back.  Returns
    K10's row."""
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack
    from fdeflate_tpu_torch.ops.repack import (combine, combine_grouped,
                                               combine_plain)
    from fdeflate_tpu_torch.ops.ultrafast import (_encode, lane_starts,
                                                  stream_words)
    from fdeflate_tpu_torch.trees import trained_tables

    B, N = data.shape
    t = trained_tables(str(dev))

    def k10(win, bits, pos0, b, w):
        return combine(win, bits, pos0, b, w, group=GROUP)

    torch.cuda.synchronize()
    combine_grouped.launches = 0
    words, total_bits, adler, _s, _e = _encode(data, lengths, CHUNKS, t,
                                               assign_pack, k10)
    streams = P.finalize_streams(words, total_bits, adler)
    torch.cuda.synchronize()
    launches = combine_grouped.launches
    if launches != 1:
        raise AssertionError(f"the encode launched K10 {launches} times")
    n_ok = sum(zlib.decompress(s) == streams_in[i] for i, s in enumerate(streams))
    if n_ok != B:
        raise AssertionError(f"K10 path: {n_ok}/{B} streams through zlib")
    win, bits = assign_pack(data, lengths, CHUNKS, t)
    pos0 = lane_starts(bits, B, CHUNKS, t.header_bits)[0].reshape(-1).to(
        torch.int32)
    W = stream_words(N, t)
    before = combine_grouped.launches
    got, ops = torch_ops(lambda: combine(win, bits, pos0, B, W, group=GROUP))
    torch.cuda.synchronize()
    if combine_grouped.launches != before + 1 or not set(ops) <= NO_COMPUTE:
        raise AssertionError(f"combine(group={GROUP}): launches "
                             f"{combine_grouped.launches - before}, ops {ops}")
    if not torch.equal(got, combine(win, bits, pos0, B, W)):
        raise AssertionError("K10 differs from K2")
    err = check_equal(torch, "combine_grouped", (got,),
                      (combine_plain(win, bits, pos0, B, W),))
    fns = {"K10": lambda: combine(win, bits, pos0, B, W, group=GROUP),
           "K2": lambda: combine(win, bits, pos0, B, W)}
    one = {k: cuda_ms(torch, fn, KERNEL_REPS) for k, fn in fns.items()}
    queued = {k: back_to_back_ms(torch, fn, KERNEL_REPS)
              for k, fn in fns.items()}
    plain_ms = cuda_ms(torch, lambda: combine_plain(win, bits, pos0, B, W),
                       PLAIN_REPS)
    print(f"K10 combine_grouped (group={GROUP}): launches {launches}, "
          f"{n_ok}/{B} streams through zlib.decompress, one launch and ops "
          f"{sorted(set(ops))} per call, == K2 == plain; combine(group="
          f"{GROUP}) {one['K10']:.4f} ms one call ({queued['K10']:.4f} back "
          f"to back); K2 {one['K2']:.4f} ms ({queued['K2']:.4f}); plain "
          f"{plain_ms:.4f} ms [{card}]", flush=True)
    nw = used_words(torch, bits)
    L = B * CHUNKS
    # per payload word: shift, split, two ORs (4)
    return kernel_row("combine_grouped",
                      "fdeflate_tpu_torch/csrc/combine_grouped.cu",
                      "fdeflate_tpu/ops/repack.py:306 (_combine_kernel_grouped)",
                      launches, err, one["K10"], plain_ms,
                      (4 * nw + 8 * L + 4 * words.numel(), 4 * nw))


def indexed_phase(torch, P, dev, corpus, card):
    """Phase 13, the indexed decode at the headline width (see the module
    docstring).  Returns K11's row and the phase's ``max_steps``."""
    from fdeflate_tpu_torch.ops.adler32_pallas import adler32_tiles
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack
    from fdeflate_tpu_torch.ops.decode_symbols import (STOPPED,
                                                       _decode_symbols_live,
                                                       decode_symbols)
    from fdeflate_tpu_torch.ops.repack import combine
    from fdeflate_tpu_torch.ops.ultrafast import encode_ultrafast_batch
    from fdeflate_tpu_torch.parallel import device_pipeline as DP
    from fdeflate_tpu_torch.tools.edges import K11_KINDS, k11_edge_case
    from fdeflate_tpu_torch.tools.time_k11 import (headline_lanes, k11_bytes,
                                                   live_view, plain_k11)

    B, N = corpus.shape
    streams_in = [r.tobytes() for r in corpus]
    data = torch.from_numpy(corpus).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    kernels = {"assign_pack": assign_pack, "combine": combine,
               "adler32_tiles": adler32_tiles, "decode_symbols": decode_symbols}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    DP.decompress_batch_indexed.fallbacks = 0
    t0 = time.perf_counter()
    streams, index = P.compress_batch_ultra_fast(streams_in,
                                                 with_index=CHUNKS)
    back = P.decompress_batch_indexed(streams, index)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    fallbacks = DP.decompress_batch_indexed.fallbacks
    print(f"indexed path ({B} x {N} B, C={CHUNKS}): {wall:.3f} s wall incl. "
          f"host copies; launches {launches}; fallbacks {fallbacks}",
          flush=True)
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the indexed path was not launched: "
                             f"{launches}")
    if launches["decode_symbols"] != 1:
        raise AssertionError("decompress_batch_indexed did not launch K11 once")
    if fallbacks:
        raise AssertionError(f"{fallbacks} clean streams fell back to "
                             "decompress_batch")
    if back != streams_in:
        raise AssertionError("decompress_batch_indexed differs from the input")
    case, staged, cap = headline_lanes(streams, index, dev)
    max_steps = case["max_steps"]
    decode_symbols.launches = 0
    out, produced, ok, ck_ok = P.fused_ultrafast_roundtrip(
        CHUNKS, max_steps, N)(data, lengths)
    torch.cuda.synchronize()
    if decode_symbols.launches != 1:
        raise AssertionError("fused_ultrafast_roundtrip did not launch K11 once")
    if not (bool(ok.all()) and bool(ck_ok.all())
            and torch.equal(produced, lengths) and torch.equal(out, data)):
        raise AssertionError(f"fused_ultrafast_roundtrip: ok {ok.tolist()} "
                             f"ck_ok {ck_ok.tolist()}")
    print(f"decompress_batch_indexed == input ({len(streams)} streams, "
          f"{sum(map(len, streams))} B, max_steps {max_steps}, cap {cap}); "
          f"fused_ultrafast_roundtrip({CHUNKS}, {max_steps}, {N}): ok, ck_ok "
          f"all, produced == lengths, out == data", flush=True)

    # K11 against its plain version on the card, on the headline lanes and
    # on the edge inputs: the full form (every row) and the live form (each
    # lane's rows below its step count, the count, the state).
    got = decode_symbols(**case)
    want = plain_k11(case)
    err = check_equal(torch, "decode_symbols (headline lanes)",
                      got[0] + got[1], want[0] + want[1])
    live = _decode_symbols_live(**case)
    err = max(err, check_equal(torch, "K11 live form (headline lanes)",
                               live_view(*live), live_view(*want)))
    statuses = sorted(set(got[1][2].tolist()))
    ran = int(live[2].sum())
    print(f"decode_symbols == plain and the live form == plain on the "
          f"{case['bit_pos'].numel()} headline lanes ({max_steps} steps, "
          f"{ran} lane steps run, at most {int(live[2].max())} in a lane, "
          f"statuses {statuses}): ok", flush=True)
    for kind in K11_KINDS:
        e = k11_edge_case(kind)
        on = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in e.items()}
        g = decode_symbols(**on)
        w = plain_k11(on)
        err = max(err, check_equal(torch, f"decode_symbols ({kind})",
                                   g[0] + g[1], w[0] + w[1]))
        err = max(err, check_equal(torch, f"K11 live form ({kind})",
                                   live_view(*_decode_symbols_live(**on)),
                                   live_view(*w)))
        print(f"decode_symbols and its live form == plain on the {kind} "
              f"edge input (chain {e['chain']}, statuses "
              f"{sorted(set(g[1][2].tolist()))}): ok", flush=True)
    del got, want, g, w

    # Times: one call and back to back (card: see the line below).
    records, state, steps = live
    status = torch.where(case["active"], state[2], STOPPED)
    step = DP.indexed_decode_step(CHUNKS, max_steps, cap)
    fns = {
        "K11 live form (_decode_symbols_live)":
            lambda: _decode_symbols_live(**case),
        "K11 full form (decode_symbols)": lambda: decode_symbols(**case),
        "indexed_materialize (live records)":
            lambda: DP.indexed_materialize(records, status, None, CHUNKS, cap,
                                           steps=steps),
        "indexed_decode_step": lambda: step(*staged),
        f"one-lane encode (encode_ultrafast_batch(num_chunks={CHUNKS}))":
            lambda: encode_ultrafast_batch(data, lengths, num_chunks=CHUNKS),
    }
    one = {k: cuda_ms(torch, fn, 5) for k, fn in fns.items()}
    queued = {k: back_to_back_ms(torch, fn, 5) for k, fn in fns.items()}
    plain_ms = cuda_ms(torch, lambda: plain_k11(case), 1)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    P.decompress_batch_indexed(streams, index)
    api_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    for k in fns:
        print(f"{k}: {one[k]:.4f} ms one call ({queued[k]:.4f} ms back to "
              f"back) [{card}]", flush=True)
    leg = one["indexed_decode_step"]
    print(f"K11 plain version {plain_ms:.4f} ms; indexed decode leg "
          f"{B * N / leg / 1e6:.4f} GB/s of output one call "
          f"({B * N / queued['indexed_decode_step'] / 1e6:.4f} back to back); "
          f"decompress_batch_indexed {api_s * 1e3:.4f} ms host clock "
          f"({B * N / api_s / 1e9:.4f} GB/s of output), peak device memory "
          f"{peak / 2**30:.3f} GiB [{card}]", flush=True)

    # operations: 8 per symbol, as K3, K6 and K8
    ops = 8 * symbol_count(torch, data, lengths, N)
    live_bound, full_bound = (bound(k11_bytes(case, staged[1], r), ops)[0]
                              for r in (ran, max_steps * case["bit_pos"].numel()))
    print(f"K11 bounds: live form {live_bound:.6f} ms ({ran} records), full "
          f"form {full_bound:.6f} ms", flush=True)
    row = kernel_row("decode_symbols", "fdeflate_tpu_torch/csrc/decode_symbols.cu",
                     "fdeflate_tpu/ops/inflate.py:64 (decode_symbols, an XLA "
                     "while_loop; no TPU kernel)",
                     launches["decode_symbols"], err,
                     one["K11 live form (_decode_symbols_live)"], plain_ms,
                     (k11_bytes(case, staged[1], ran), ops))
    row.update({
        "back_to_back_ms": queued["K11 live form (_decode_symbols_live)"],
        "full_form_ms": one["K11 full form (decode_symbols)"],
        "full_form_back_to_back_ms": queued["K11 full form (decode_symbols)"],
        "full_form_bound_ms": full_bound})
    return row, max_steps


def matched_phase(torch, P, dev, card):
    """Phase 14, the matched encoder (general levels 1-3) at the width its
    users run (see the module docstring).  Returns K7's launches and time
    on this path, for K7's row."""
    from fdeflate_tpu_torch.ops.adler32 import (adler32_batch,
                                                adler32_batch_plain)
    from fdeflate_tpu_torch.ops.adler32_pallas import adler32_tiles
    from fdeflate_tpu_torch.tools.corpus import corpora, make_idat_corpus
    from fdeflate_tpu_torch.tools.time_matched import (STAGES, fmt, host_ms,
                                                       patched, peak_bytes,
                                                       stage_ms)

    corpus = make_idat_corpus(MATCHED_BATCH, MATCHED_LENGTH)
    streams = [r.tobytes() for r in corpus]
    nbytes = corpus.size
    launches, k7_ms = {}, {}
    for level in (1, 2, 3):
        torch.cuda.synchronize()
        adler32_tiles.launches = 0
        t0 = time.perf_counter()
        out = P.compress_batch_device(streams, level)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[level] = adler32_tiles.launches
        if launches[level] != 1:
            raise AssertionError(f"level {level}: K7 launched "
                                 f"{launches[level]} times, not once")
        n_ok = sum(zlib.decompress(o) == x for o, x in zip(out, streams))
        ck_ok = sum(int.from_bytes(o[-4:], "big") == zlib.adler32(x)
                    for o, x in zip(out, streams))
        if n_ok != len(streams) or ck_ok != len(streams):
            raise AssertionError(f"level {level}: {n_ok} streams equal under "
                                 f"zlib.decompress, {ck_ok} Adler-32 equal")
        print(f"matched level {level} ({len(streams)} x {MATCHED_LENGTH} B "
              f"IDAT): {wall:.3f} s wall (first call); K7 launches "
              f"{launches[level]}; {n_ok}/{len(streams)} == zlib.decompress, "
              f"K7's Adler-32 == zlib.adler32 on all; {sum(map(len, out))} B "
              f"out", flush=True)
    data = torch.from_numpy(corpus).to(dev)
    lengths = torch.full((len(streams),), MATCHED_LENGTH, dtype=torch.int32,
                         device=dev)
    got = adler32_batch(data, lengths).tolist()
    if (got != adler32_batch_plain(data, lengths).tolist()
            or got != [zlib.adler32(x) for x in streams]):
        raise AssertionError("adler32_batch (K7) on the matched corpus differs")
    del data

    # The card against its plain twin (device="cpu") on the size corpora.
    names, raws = zip(*corpora())
    raws = list(raws)
    for level in (1, 2, 3):
        on_card = P.compress_batch_device(raws, level)
        on_cpu = P.compress_batch_device(raws, level, device="cpu")
        if on_card != on_cpu:
            bad = [n for n, a, b in zip(names, on_card, on_cpu) if a != b]
            raise AssertionError(f"level {level}: card != cpu on {bad}")
        if [zlib.decompress(o) for o in on_card] != raws:
            raise AssertionError(f"level {level}: zlib roundtrip failed")
        print(f"matched level {level}, card == cpu on the five 1 MiB "
              f"corpora; bytes (zlib level 1): " + ", ".join(
                  f"{n} {len(o)} ({len(zlib.compress(r, 1))})"
                  for n, o, r in zip(names, on_card, raws)), flush=True)

    # Times (card: see the line below), op counts and peak memory.
    for level in (1, 2, 3):
        def call():
            return P.compress_batch_device(streams, level)

        ms = host_ms(call, 2)
        _out, stages = stage_ms(call)
        ops = {}

        def count(name, fn):
            def counted(*args, **kwargs):
                out, names_ = torch_ops(lambda: fn(*args, **kwargs))
                ops.setdefault(name, []).append(len(names_))
                return out
            return counted

        with patched(STAGES, count):
            call()
        peak = peak_bytes(call, dev)
        k7_ms[level] = stages["adler32_batch"][0]
        print(f"matched level {level}: {ms:.4f} ms host clock, "
              f"{nbytes / ms / 1e6:.4f} GB/s of input; peak device memory "
              f"{peak / 2**30:.3f} GiB above the held [{card}]", flush=True)
        print(f"matched level {level} stages (CUDA events), ms: "
              f"{fmt(stages)} [{card}]", flush=True)
        print(f"matched level {level} torch ops per stage: " + "; ".join(
            f"{k} {' + '.join(map(str, v))}" for k, v in ops.items()),
              flush=True)
    return launches, k7_ms


def paired_ms(torch, a, b, pairs: int) -> tuple[float, float, list]:
    """Medians of ``a`` and ``b`` timed one call at a time in turns (a
    first in even pairs, b first in odd ones) and the pairs' ``b - a``,
    sorted; ms by CUDA events, after one warm-up call of each."""
    def one(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    a(), b()
    ta, tb = [], []
    for i in range(pairs):
        for fn, out in ((a, ta), (b, tb)) if i % 2 == 0 else ((b, tb), (a, ta)):
            out.append(one(fn))
    return (statistics.median(ta), statistics.median(tb),
            sorted(y - x for x, y in zip(ta, tb)))


def mesh_kernels():
    """The launch-counted wrappers of the scale-out path: {K name: fn}."""
    from fdeflate_tpu_torch.ops.adler32_pallas import adler32_tiles
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack
    from fdeflate_tpu_torch.ops.decode2 import decode2
    from fdeflate_tpu_torch.ops.decode_symbols import decode_symbols
    from fdeflate_tpu_torch.ops.inflate_records import inflate_records
    from fdeflate_tpu_torch.ops.repack import combine

    return {"K1": assign_pack, "K2": combine, "K3": decode2,
            "K4": inflate_records, "K7": adler32_tiles, "K11": decode_symbols}


def counted(torch, fn):
    """(fn(), {K name: launches in that call}): every count set to 0 just
    before the call and read just after it."""
    kernels = mesh_kernels()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in kernels.items()}


HELD_STEPS = 4096   # a K11 call of more steps is held to plain at this many
PAIRS = 11          # phase 15's timing pairs (sharded, unsharded) per step


def snapshot(torch, x):
    """``x`` with every tensor in it (through tuples and lists) cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if type(x) in (tuple, list):
        return type(x)(snapshot(torch, v) for v in x)
    if isinstance(x, dict):
        return {k: snapshot(torch, v) for k, v in x.items()}
    return x


class Recorder:
    """A kernel wrapper that keeps each call's arguments (cloned before the
    call) and result (cloned after it) in ``calls``; reading and setting
    an attribute (the wrapper's launch count) goes to the wrapper."""

    def __init__(self, torch, fn, calls):
        object.__setattr__(self, "_torch", torch)
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_calls", calls)

    def __call__(self, *args, **kwargs):
        saved = snapshot(self._torch, (args, kwargs))
        out = self._fn(*args, **kwargs)
        self._calls.append((self._fn, *saved, snapshot(self._torch, out)))
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


def recorded(torch, calls, fn):
    """fn() with every kernel wrapper of the scale-out path recording into
    ``calls``: K1 ``assign_pack``, K2 ``combine``, K3 ``decode2``, K4
    ``inflate_records``, K7 ``adler32_checksums`` and K11's ``_run`` (both
    forms), replaced under every name a module of the port holds them by."""
    from fdeflate_tpu_torch.ops import decode_symbols as DS
    from fdeflate_tpu_torch.ops.adler32_pallas import adler32_checksums
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack
    from fdeflate_tpu_torch.ops.decode2 import decode2
    from fdeflate_tpu_torch.ops.inflate_records import inflate_records
    from fdeflate_tpu_torch.ops.repack import combine

    wrappers = (assign_pack, combine, decode2, inflate_records,
                adler32_checksums, DS._run)
    patched = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("fdeflate_tpu_torch"):
            continue
        for attr, value in list(vars(mod).items()):
            if any(value is w for w in wrappers):
                setattr(mod, attr, Recorder(torch, value, calls))
                patched.append((mod, attr, value))
    try:
        return fn()
    finally:
        for mod, attr, value in patched:
            setattr(mod, attr, value)


def hold_calls(torch, calls, launches) -> tuple[dict, list]:
    """Each recorded call's result against its kernel's plain version on
    the same arguments, bit for bit.  A K11 call of more than
    ``HELD_STEPS`` steps is run again, kernel and plain, at ``HELD_STEPS``
    (the full form's first rows of the recorded call held too).  Raises
    on a difference, or where a kernel launched more often than its
    wrapper was recorded.  Returns ({K name: max_abs_err}, [(K name,
    plain output)] in call order)."""
    from fdeflate_tpu_torch.ops import decode_symbols as DS
    from fdeflate_tpu_torch.ops.adler32_pallas import (adler32_checksums,
                                                       adler32_tiles_plain,
                                                       fold_tiles)
    from fdeflate_tpu_torch.ops.assign_pack import (assign_pack,
                                                    assign_pack_plain)
    from fdeflate_tpu_torch.ops.decode2 import decode2, decode2_plain
    from fdeflate_tpu_torch.ops.inflate_records import (inflate_records,
                                                        inflate_records_plain)
    from fdeflate_tpu_torch.ops.repack import combine, combine_plain
    from fdeflate_tpu_torch.tools.time_k11 import live_view

    def k11_plain(fill, *a):
        words, lanes, rows, tabs, first, _t = DS.engine_inputs(
            *a[:10], *a[11:])
        records, state = DS.decode_symbols_plain(
            words, *lanes, rows, *tabs, first, a[10], a[12])
        return records, state, (records[5] >= 0).sum(0, dtype=torch.int32)

    def k11_view(fill, out):
        return out[0] + out[1] if fill else live_view(*out)

    errs, plains, seen = {}, [], {}
    for fn, args, kwargs, out in calls:
        if fn is assign_pack:
            name, want = "K1", assign_pack_plain(*args, **kwargs)
        elif fn is combine:
            group = kwargs.get("group", args[5] if len(args) > 5 else 1)
            name = "K2" if group == 1 else "K10"
            want = combine_plain(*args[:5])
        elif fn is decode2:
            name, want = "K3", decode2_plain(*args, **kwargs)
        elif fn is inflate_records:
            name = "K4"
            want = inflate_records_plain(*args[:8], **{
                k: v for k, v in kwargs.items() if k != "stats"})
        elif fn is adler32_checksums:
            name = "K7"
            data, lengths = args[:2]
            want = fold_tiles(*adler32_tiles_plain(data, lengths), lengths)
        elif fn is DS._run:
            name, (fill, *a) = "K11", args
            if a[10] > HELD_STEPS:
                a[10] = HELD_STEPS
                head = [r[:HELD_STEPS] for r in out[0]]
                out = fn(fill, *a)
                want = k11_plain(fill, *a)
                if fill:
                    check_equal(torch, "K11 (first rows of the recorded "
                                "call)", head, want[0])
            else:
                want = k11_plain(fill, *a)
            out, want = k11_view(fill, out), k11_view(fill, want)
        else:
            raise AssertionError(f"no plain version recorded for {fn}")
        got = out if isinstance(out, tuple) else (out,)
        ref = want if isinstance(want, tuple) else (want,)
        errs[name] = max(errs.get(name, 0.0),
                         check_equal(torch, f"{name} on the path", got, ref))
        plains.append((name, want))
        seen[name] = seen.get(name, 0) + 1
    torch.cuda.synchronize()
    short = {k: n for k, n in launches.items() if n > seen.get(k, 0)}
    if short:
        raise AssertionError(f"launches not recorded: {short} of {launches}, "
                             f"recorded {seen}")
    return errs, plains


def blocked_text_blocks(torch, PD, z: bytes, leg, dev):
    """Phase 5's text6 stream staged in JAX's lane-blocked layout, one real
    block per lane (the chain of ``discovery``'s candidates, K4 decoding
    each from its symbol bits to its EOB), the rest zero: (win, pos0,
    meta, tab) on ``dev``, the chain's lanes (absolute starts, tables) for
    the direct K4 call, and the real lanes' count."""
    from fdeflate_tpu_torch.ops.inflate_records import (META_ROWS, TAB_PAIRS,
                                                        block_tables)

    lanes, wd, bounds, _c1 = leg
    _recs, bpos, eob, _nout = PD._lane_decode(lanes, 6144, wd, *bounds)
    chain, _final = PD._chain(lanes, 0, len(lanes), bpos, eob)
    words = np.frombuffer(z + bytes((-len(z)) % 4) + bytes(8), "<u4")
    starts = [lanes[i][2] for i in chain]
    wwin = max((int(bpos[i]) >> 5) - (s >> 5) for i, s in zip(chain, starts)) + 3
    words = np.concatenate([words, np.zeros(wwin, np.uint32)]).view(np.int32)
    L = len(chain)
    LB = -(-L // 1024)
    win = np.zeros((LB * 1024, wwin), np.int32)
    pos0 = np.zeros((LB * 1024, 1), np.int32)
    meta = np.zeros((LB * 1024, META_ROWS), np.int32)
    tab = np.zeros((LB * 1024, TAB_PAIRS), np.int32)
    for j, (i, s) in enumerate(zip(chain, starts)):
        win[j] = words[s >> 5:(s >> 5) + wwin]
        pos0[j] = s & 31
        meta[j], tab[j] = block_tables(lanes[i][3], lanes[i][4])

    def blocked(a):   # [LB * 1024, rows] -> [LB, rows, 8, 128]
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape(LB, 8, 128, -1).transpose(0, 3, 1, 2))).to(dev)

    staged = (blocked(win), blocked(pos0)[:, 0], blocked(meta), blocked(tab))
    direct = (wd, torch.tensor(starts, dtype=torch.int64, device=dev),
              torch.from_numpy(meta[:L]).to(dev), torch.from_numpy(tab[:L]).to(dev))
    return staged, direct, L


def mesh_phase(torch, P, dev, corpus, card, max_steps, text6):
    """Phase 15, scale-out at world size 1 (see the module docstring).
    Returns {K name: launches over the phase}."""
    from fdeflate_tpu_torch.ops.adler32 import adler32_batch
    from fdeflate_tpu_torch.ops.assign_pack import token_symbols
    from fdeflate_tpu_torch.ops.decode_symbols import EOB, decode_symbols
    from fdeflate_tpu_torch.ops.inflate import WINDOW, materialize
    from fdeflate_tpu_torch.ops.inflate_records import (NO_LIMIT,
                                                        inflate_records,
                                                        lanes_from_blocked)
    from fdeflate_tpu_torch.ops.ultrafast import encode_ultrafast_batch
    from fdeflate_tpu_torch.parallel import discovery as PD
    from fdeflate_tpu_torch.parallel import shard as S
    from fdeflate_tpu_torch.parallel.device_pipeline import trained_symbol_tables
    from fdeflate_tpu_torch.trees import STREAM_HEADER_BITS

    import torch.distributed as dist

    B, N = corpus.shape
    streams_in = [r.tobytes() for r in corpus]
    data = torch.from_numpy(corpus).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    mesh = S.make_mesh((1, 1))
    print(f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
          f"{mesh.device_type}: backend {dist.get_backend()}, world size "
          f"{dist.get_world_size()}", flush=True)
    totals = dict.fromkeys(mesh_kernels(), 0)
    # step name -> (sharded call, unsharded call, kernels it must launch)
    steps = {}

    held_errs = dict.fromkeys(totals, 0.0)
    plains = {}     # step name -> [(K name, plain output)] of its launches

    def run(name, sharded, plain, needs):
        calls = []
        out, launches = counted(torch, lambda: recorded(torch, calls, sharded))
        for k, n in launches.items():
            totals[k] += n
        missing = sorted(needs - {k for k, n in launches.items() if n})
        if missing:
            raise AssertionError(f"{name}: {missing} not launched ({launches})")
        t0 = time.perf_counter()
        errs, plains[name] = hold_calls(torch, calls, launches)
        held_s = time.perf_counter() - t0
        del calls
        for k, e in errs.items():
            held_errs[k] = max(held_errs.get(k, 0.0), e)
        print(f"{name}: kernel calls {len(plains[name])} "
              f"({sorted(set(k for k, _w in plains[name]))}), each == its "
              f"plain version on the same arguments (held in {held_s:.1f} s "
              f"by the host clock)", flush=True)
        steps[name] = (sharded, plain, launches)
        return out

    def full(x):
        return x.full_tensor()

    # the roundtrip steps against their unsharded functions
    fused = P.fused_ultrafast_roundtrip(CHUNKS, max_steps, N)
    rt = S.roundtrip_step(mesh, max_steps=max_steps, chunks=CHUNKS)
    produced, adler, total = run(
        "roundtrip_step", lambda: rt(data), lambda: fused(data, lengths),
        {"K1", "K2", "K7", "K11"})
    want = fused(data, lengths)
    if not (torch.equal(full(produced), want[1])
            and torch.equal(full(adler), adler32_batch(data, lengths))
            and float(full(total)) == B * N and bool(want[2].all())):
        raise AssertionError("roundtrip_step differs from "
                             "fused_ultrafast_roundtrip")
    verified = {
        "roundtrip_step_v2": (S.roundtrip_step_v2, P.fused_ultrafast_roundtrip_v2(
            CHUNKS, N), {"K1", "K3"}),
        "roundtrip_step_zlib": (S.roundtrip_step_zlib, P.fused_zlib_roundtrip(
            CHUNKS, N), {"K1", "K2", "K3", "K7"}),
        "roundtrip_step_adaptive": (S.roundtrip_step_adaptive,
                                    P.fused_adaptive_roundtrip(CHUNKS, N),
                                    {"K1", "K3"}),
    }
    for name, (make, plain, needs) in verified.items():
        step = make(mesh, chunks=CHUNKS)
        bpos_ok, ck_ok, total = run(
            name, lambda step=step: step(data),
            lambda plain=plain: plain(data, lengths), needs)
        want = plain(data, lengths)
        if not (torch.equal(full(bpos_ok), want[1])
                and torch.equal(full(ck_ok), want[2])
                and float(full(total)) == B * N):
            raise AssertionError(f"{name} differs from its unsharded step "
                                 f"or verified {float(full(total))} bytes")

    # the sequence-parallel checksum, the sharded encode and decode
    reduce = S.checksum_tree_reduce(mesh)
    ck = run("checksum_tree_reduce", lambda: reduce(data),
             lambda: adler32_batch(data, lengths), {"K7"})
    if full(ck).tolist() != [zlib.adler32(x) for x in streams_in]:
        raise AssertionError("checksum_tree_reduce != zlib.adler32")
    encode = S.sharded_encode_ultrafast(mesh)
    words, bits, adler = (full(x) for x in run(
        "sharded_encode_ultrafast", lambda: encode(data, lengths),
        lambda: encode_ultrafast_batch(data, lengths), {"K1", "K2", "K7"}))
    if not all(torch.equal(g, w) for g, w in zip(
            (words, bits, adler), encode_ultrafast_batch(data, lengths))):
        raise AssertionError("sharded_encode_ultrafast != encode_ultrafast_batch")
    out = P.finalize_streams(words, bits, adler)
    if [zlib.decompress(s) for s in out] != streams_in:
        raise AssertionError("sharded_encode_ultrafast's streams != input")
    tables = trained_symbol_tables(str(dev))[:4]
    i32 = dict(dtype=torch.int32, device=dev)
    lanes = (words, torch.full((B,), STREAM_HEADER_BITS, **i32), bits,
             torch.zeros(B, **i32), torch.ones(B, dtype=torch.bool, device=dev),
             torch.zeros(B, **i32), *tables)
    # every symbol takes one step at most, and the EOB one more
    k = int((token_symbols(data, lengths, N) >= 0).sum(dim=1).max()) + 1
    decode = S.sharded_decode_symbols(mesh, k)
    records, state = run(
        "sharded_decode_symbols", lambda: decode(*lanes),
        lambda: decode_symbols(*lanes, max_steps=k), {"K11"})
    records, state = [full(r) for r in records], [full(s) for s in state]
    want_r, want_s = decode_symbols(*lanes, max_steps=k)
    if not (all(torch.equal(g, w) for g, w in zip(records, want_r))
            and all(torch.equal(g, w) for g, w in zip(state, want_s))):
        raise AssertionError("sharded_decode_symbols != decode_symbols")
    got, _window = materialize(records[:5], torch.zeros(
        (B, WINDOW), dtype=torch.uint8, device=dev), state[1], N)
    if not (bool((state[2] == EOB).all()) and torch.equal(state[1], lengths)
            and torch.equal(got, data)):
        raise AssertionError("sharded_decode_symbols' records != the input")
    print(f"sharded_decode_symbols: {B} lanes at EOB within {k} steps, their "
          f"records materialize to the input", flush=True)

    # the foreign record step on phase 5's text6 blocks, JAX's blocked layout
    z_text8, leg, K = text6
    staged, direct, L = blocked_text_blocks(torch, PD, z_text8, leg, dev)
    win, pos0, meta, tab = staged
    LB, wwin = win.shape[:2]
    base = torch.arange(LB * 1024, dtype=torch.int64, device=dev) * wwin
    unlimited = torch.full_like(base, NO_LIMIT)

    def flat_k4():   # the step's body on the same lanes, unsharded
        return inflate_records(
            lanes_from_blocked(win).reshape(-1),
            base * 32 + lanes_from_blocked(pos0[:, None])[:, 0], base + wwin,
            unlimited, unlimited, lanes_from_blocked(meta),
            lanes_from_blocked(tab), K)

    foreign = S.foreign_records_step(mesh, K=K)
    bpos, done, eob_total = (full(x) for x in run(
        "foreign_records_step", lambda: foreign(win, pos0, meta, tab),
        flat_k4, {"K4"}))
    wd, starts, dmeta, dtab = direct
    nolim = torch.full_like(starts, NO_LIMIT)
    _r, dbpos, _n, ddone = inflate_records(
        wd, starts, torch.full_like(starts, wd.numel()), nolim, nolim, dmeta,
        dtab, K)
    real_bpos, real_done = bpos.reshape(-1)[:L], done.reshape(-1)[:L]
    if not (bool((real_done == 1).all()) and torch.equal(real_done, ddone)
            and torch.equal(real_bpos.to(torch.int64),
                            dbpos - (starts >> 5) * 32)
            and float(eob_total) == int((done == 1).sum())):
        raise AssertionError("foreign_records_step != K4's direct call")
    # every lane, padding included, against the plain K4 of the step's call
    (k4, (_r, pbpos, _n, pdone)), = plains["foreign_records_step"]
    if not (k4 == "K4"
            and torch.equal(bpos.reshape(-1), (pbpos - base * 32).to(torch.int32))
            and torch.equal(done.reshape(-1), pdone.clamp(max=2).to(done.dtype))):
        raise AssertionError("foreign_records_step != the plain K4")
    print(f"foreign_records_step on text6 ({L} blocks in {LB} lane-blocks, "
          f"window {wwin} words, K {K}): every block at EOB, bpos and done "
          f"== K4's direct call on the stream; all {LB * 1024} lanes' bpos "
          f"and done (codes {sorted(set(done.reshape(-1).tolist()))}) == "
          f"the plain K4 on the step's own arguments", flush=True)

    # the entry points of entry.py (__graft_entry__.py's counterparts)
    run("dryrun_multichip(1)", lambda: P.dryrun_multichip(1), None,
        {"K1", "K2", "K3", "K4", "K7", "K11"})
    fwd, (d4, l4) = P.entry()
    sums = run("entry", lambda: fwd(d4, l4), None, {"K1", "K3"})
    words4 = d4.contiguous().view(torch.int32).sum(dtype=torch.int64)
    if [int(x) for x in sums] != [int((words4 + 2**31) % 2**32 - 2**31), 4, 4]:
        raise AssertionError(f"entry: {[int(x) for x in sums]}")
    step1, (d1, l1) = P.entry_v1()
    opos, status, adler1 = run("entry_v1", lambda: step1(d1, l1), None,
                               {"K1", "K2", "K7", "K11"})
    if not ((opos == 256).all() and (status == EOB).all()
            and adler1.tolist() == [zlib.adler32(r.tobytes())
                                    for r in d1.cpu().numpy()]):
        raise AssertionError("entry_v1 did not decode its streams")
    print(f"dryrun_multichip(1), entry() {[int(x) for x in sums]} and "
          f"entry_v1() (out_pos 256, EOB, Adler-32 == zlib): ok", flush=True)
    for name, (_s, _p, launches) in steps.items():
        print(f"{name} launches: {launches}", flush=True)

    # times: each step beside its unsharded function, one call each in
    # turns (CUDA events); the dry run, which builds meshes, is not timed
    backend = dist.get_backend()
    for name, (sharded, plain, _l) in steps.items():
        if plain is None:
            if name.startswith("entry"):
                print(f"{name}: {cuda_ms(torch, sharded, 5):.4f} ms [{card}]",
                      flush=True)
            continue
        plain_ms, ms, diffs = paired_ms(torch, plain, sharded, PAIRS)
        print(f"{name}: {ms:.4f} ms on the (1, 1) {backend} mesh, unsharded "
              f"{plain_ms:.4f} ms, mesh layer {statistics.median(diffs):.4f} "
              f"ms (median of {PAIRS} pairs' differences; they range "
              f"{diffs[0]:.4f} to {diffs[-1]:.4f}) [{card}]", flush=True)

    # the mesh layer's pieces on the v2 step's input (one call each)
    local = S._local(mesh, data, S.ROWS, "data")
    count = torch.zeros((), dtype=torch.int32, device=dev)
    pieces = {
        "_local (distribute_tensor + to_local), u8[16, 1 MiB]":
            lambda: S._local(mesh, data, S.ROWS, "data"),
        "_mesh_total (2 all_reduce of one int32 + pmean)":
            lambda: S._mesh_total(mesh, count),
        "_global (DTensor.from_local) x 3":
            lambda: [S._global(mesh, x, p) for x, p in (
                (local[:, 0], S.ROWS), (local[:, 1], S.ROWS),
                (count, S.REPLICATED))],
        "full_tensor() of a [16] bool": lambda: S._global(
            mesh, local[:, 0] > 0, S.ROWS).full_tensor(),
    }
    print("mesh layer pieces: " + "; ".join(
        f"{k} {cuda_ms(torch, fn, 20):.4f} ms" for k, fn in pieces.items())
        + f" [{card}]", flush=True)
    if not all(totals.values()):
        raise AssertionError(f"a kernel of the scale-out path was not "
                             f"launched: {totals}")
    return totals, held_errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    import fdeflate_tpu_torch as P
    from fdeflate_tpu_torch import _build
    from fdeflate_tpu_torch.ops.adler32 import (adler32_batch,
                                                adler32_batch_plain)
    from fdeflate_tpu_torch.ops.adler32_pallas import adler32_tiles
    from fdeflate_tpu_torch.ops.assign_pack import assign_pack, assign_pack_plain
    from fdeflate_tpu_torch.ops.decode2 import decode2, decode2_plain
    from fdeflate_tpu_torch.ops.repack import combine, combine_plain
    from fdeflate_tpu_torch.ops.ultrafast import _encode, encode_fixed
    from fdeflate_tpu_torch.parallel.device_pipeline import (_decode_verify,
                                                             decode_verify)
    from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
    from fdeflate_tpu_torch.trees import trained_tables

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
    inputs = kernel_inputs(make_idat_corpus)
    for label, arr, lens, C in inputs:
        run_kernels(torch, t, torch.from_numpy(arr).to(dev),
                    torch.tensor(lens, dtype=torch.int32, device=dev), C)
        print(f"kernels == plain at {label}: ok", flush=True)

    # Corrupted stream: the decode kernel and its plain version still agree.
    _label, small, lens, _C = inputs[0]
    N = small.shape[1]
    sd = torch.from_numpy(small).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    words, _tb, _ad, starts, _eof = encode_fixed(sd, sl, 4)
    words[0, 100] ^= 0x5A5A5A5A
    errs = max_abs_err(torch, zip(decode2(words, starts, t.dtab, N, 4),
                                  decode2_plain(words, starts, t.dtab, N, 4)))
    if errs != 0:
        raise AssertionError("decode2 differs from plain on a corrupted stream")
    print("decode2 == plain on a corrupted stream: ok", flush=True)
    edge_errs = edge_phase(torch, dev)

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
               "decode2": decode2, "adler32_tiles": adler32_tiles}
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
    if launches["adler32_tiles"] != 2:
        raise AssertionError("K7 did not launch once per encode (2 encodes)")
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
    # K7 under the encode's Adler-32, against the plain body.
    rng = np.random.default_rng(12)
    ragged_len = torch.tensor(
        [0, 1, 1023, 1025, LENGTH]
        + rng.integers(0, LENGTH + 1, BATCH - 5).tolist(),
        dtype=torch.int32, device=dev)
    for label, ln in (("headline corpus", lengths),
                      ("ragged lengths", ragged_len)):
        if not torch.equal(adler32_batch(data, ln),
                           adler32_batch_plain(data, ln)):
            raise AssertionError(f"adler32_batch (K7) != plain on the {label}")
    print(f"adler32_batch (K7) == its plain body on the headline corpus and "
          f"on ragged lengths {ragged_len[:5].tolist()}...: ok", flush=True)

    # ---- 3. times at the main path's shapes (card: see the line above) ----
    res = run_kernels(torch, t, data, lengths, CHUNKS)
    L = BATCH * CHUNKS
    win, bits = assign_pack(data, lengths, CHUNKS, t)
    nw = used_words(torch, bits)
    syms = symbol_count(torch, data, lengths, LENGTH // CHUNKS)
    work = {
        # 4 operations per byte: classify, look up, shift, OR
        "assign_pack": (BATCH * LENGTH + 4 * BATCH + out_bytes((win, bits))
                        + 4 * (256 + 29), 4 * BATCH * LENGTH),
        # per payload word: shift, split, two ORs
        "combine": (4 * nw + 8 * L + 4 * words.numel(), 4 * nw),
        # per symbol: peek, look up, three fields, shift, count, store
        "decode2": (4 * nw + 8 * L + 4 * 4096 + BATCH * LENGTH, 8 * syms),
    }
    print(f"work at the main path: {L} lanes, {nw} payload words, {syms} "
          f"symbols", flush=True)
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
    enc = P.zlib_encode_step(CHUNKS)
    words, _tb, adler, starts, eof = enc(data, lengths)
    legs = {
        "encode": (lambda: enc(data, lengths),
                   lambda: _encode(data, lengths, CHUNKS, t,
                                   assign_pack_plain, combine_plain)),
        "decode": (lambda: decode_verify(
                       words, starts, eof, adler, lengths, LENGTH, CHUNKS, t),
                   lambda: _decode_verify(
                       words, starts, eof, adler, lengths, CHUNKS,
                       lambda w, s: decode2_plain(w, s, t.dtab, LENGTH,
                                                  CHUNKS))),
    }
    # Every kernel and leg first, the plain versions after: their large
    # temporaries would reshape the caching allocator the legs draw on.
    fns = [(k, kern) for k, (kern, _plain, _err) in res.items()]
    fns += [(f"{leg} leg", kern) for leg, (kern, _plain) in legs.items()]
    fns.append(("adler32_batch", lambda: adler32_batch(data, lengths)))
    one_call = {k: cuda_ms(torch, fn, KERNEL_REPS) for k, fn in fns}
    queued = {k: back_to_back_ms(torch, fn, KERNEL_REPS) for k, fn in fns}
    for kname, (_kern, plain, err) in res.items():
        ms = one_call[kname]
        plain_ms = cuda_ms(torch, plain, PLAIN_REPS)
        src, repl = sources[kname]
        rows.append(kernel_row(kname, src, repl, launches[kname],
                               max(err, edge_errs.get(kname, 0.0)), ms,
                               plain_ms, work[kname]))
        print(f"{kname}: kernel {ms:.4f} ms one call "
              f"({queued[kname]:.4f} ms back to back), plain {plain_ms:.4f} "
              f"ms, bound {rows[-1]['bound_ms']:.6f} ms "
              f"({rows[-1]['bound_by']}) [{card}]", flush=True)
    ad_plain = cuda_ms(torch, lambda: adler32_batch_plain(data, lengths),
                       PLAIN_REPS)
    print(f"adler32_batch (K7) at the main path: {one_call['adler32_batch']:.4f} "
          f"ms one call ({queued['adler32_batch']:.4f} ms back to back), "
          f"plain body {ad_plain:.4f} ms [{card}]", flush=True)
    for how, t_ in (("one call", one_call), ("back to back", queued)):
        parts = {k: t_[k] for k in ("assign_pack", "combine", "adler32_batch")}
        rest = t_["encode leg"] - sum(parts.values())
        print(f"encode leg split, {how}: leg {t_['encode leg']:.4f} ms = K1 "
              f"{parts['assign_pack']:.4f} + K2 {parts['combine']:.4f} + K7 "
              f"(Adler-32) {parts['adler32_batch']:.4f} + framing and the "
              f"rest {rest:.4f} [{card}]", flush=True)
    mib = BATCH * LENGTH / 2**20
    for leg, (_kern, plain) in legs.items():
        ms = one_call[f"{leg} leg"]
        plain_ms = cuda_ms(torch, plain, PLAIN_REPS)
        print(f"{leg} leg: kernels {ms:.4f} ms one call "
              f"({mib / ms * 1e3 / 1024:.3f} GiB/s; "
              f"{queued[f'{leg} leg']:.4f} ms back to back), "
              f"plain {plain_ms:.4f} ms [{card}]", flush=True)

    # ---- 4. K4 and K5 against their plain versions, bit for bit ----------
    from fdeflate_tpu_torch.ops.inflate_records import (inflate_records,
                                                        inflate_records_plain)
    from fdeflate_tpu_torch.ops.validate_headers import (
        validate_headers, validate_headers_plain)
    from fdeflate_tpu_torch.parallel import discovery as PD
    from fdeflate_tpu_torch.tools.edges import (K4_KINDS, k4_edge_case,
                                                k5_cross_stream)

    k4_args, z1m, w1m = foreign_kernel_inputs(torch, dev, make_idat_corpus)
    K = PD.lane_budget(6144)
    errs = {"inflate_records": 0.0, "validate_headers": 0.0}
    for k in (K, 64):
        got = inflate_records(*k4_args, k)
        want = inflate_records_plain(*k4_args, k)
        torch.cuda.synchronize()
        errs["inflate_records"] = max(errs["inflate_records"], check_equal(
            torch, f"inflate_records K={k}", got, want))
        codes = sorted(set(got[3].tolist()))
        print(f"inflate_records == plain on {k4_args[1].numel()} lanes, "
              f"K={k}: exit codes {codes}: ok", flush=True)
        need = {1, 3} if k == K else {0}
        if not need <= set(codes):
            raise AssertionError(f"K={k}: exit codes {codes} miss {need}")
    # The edge inputs of K4's group code (tools/edges.py), against the
    # plain version on the CPU (it loops once per record step).
    codes = set()
    for kind in K4_KINDS:
        args, k = k4_edge_case(kind)
        got = inflate_records(*(x.to(dev) for x in args), k)
        want = inflate_records_plain(*args, k)
        torch.cuda.synchronize()
        errs["inflate_records"] = max(errs["inflate_records"], check_equal(
            torch, f"inflate_records ({kind})", (g.cpu() for g in got), want))
        codes |= set(got[3].tolist())
        print(f"inflate_records == plain on the {kind} edge input "
              f"({args[1].numel()} lanes, K={k}, exit codes "
              f"{sorted(set(got[3].tolist()))}): ok", flush=True)
    if not {0, 1, 2, 3, 4, 5} <= codes:
        raise AssertionError(f"K4 edge inputs ended with codes {codes} only")
    rb = np.random.default_rng(6).bytes(1 << 20)
    for z, w in ((z1m, w1m), (rb, PD.stage_words(rb, device=dev))):
        c = torch.from_numpy(PD.scan_stage1_device(z, device=dev, words=w)).to(dev)
        got = validate_headers(w, c, len(z) * 8)
        want = validate_headers_plain(w, c, len(z) * 8)
        torch.cuda.synchronize()
        errs["validate_headers"] = max(errs["validate_headers"], check_equal(
            torch, "validate_headers", got, want))
        print(f"validate_headers == plain on {c.numel()} stage-1 survivors "
              f"({int(got[0].sum())} valid): ok", flush=True)
    # Two streams' words in one buffer, as try_foreign_batch validates a
    # batch: the first stream's last bits would read the second's words
    # but for their own word end.
    xw, xc, xe, xn, parts = (x.to(dev) if torch.is_tensor(x) else x
                             for x in k5_cross_stream(z1m, rb[:65536]))
    got = validate_headers(xw, xc, xn, wend=xe)
    errs["validate_headers"] = max(errs["validate_headers"], check_equal(
        torch, "validate_headers (two streams)", got,
        validate_headers_plain(xw, xc, xn, wend=xe)))
    for lo, hi, z, cs, b0 in parts:
        alone = validate_headers(PD.stage_words(z, device=dev),
                                 torch.from_numpy(cs).to(dev), len(z) * 8)
        if not (torch.equal(got[0][lo:hi], alone[0])
                and torch.equal(got[1][lo:hi] - b0, alone[1])):
            raise AssertionError("validate_headers: a stream of two differs "
                                 "from the stream alone")
    print(f"validate_headers == plain on {xc.numel()} candidates over two "
          f"streams' words, each stream's == the stream alone: ok", flush=True)

    # ---- 5. the foreign path at the bench's sizes, through the entry points
    text8 = word_salad(FOREIGN_MB << 20)
    idat8 = make_idat_corpus(FOREIGN_MB, 1 << 20).tobytes()
    z_text8, z_idat8 = zlib.compress(text8, 6), zlib.compress(idat8, 1)
    batch_raw = [r.tobytes() for r in make_idat_corpus(BATCH, LENGTH, seed=7)]
    batch = [zlib.compress(r, 1) for r in batch_raw]
    small = small_mixed_batch()
    foreign_kernels = {"inflate_records": inflate_records,
                       "validate_headers": validate_headers}
    torch.cuda.synchronize()
    for fn in foreign_kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    r_text = P.try_foreign(z_text8, device=dev)
    r_idat = P.try_foreign(z_idat8, device=dev)
    r_route = P.try_foreign_batch(batch, device=dev)
    r_batch = P.decompress_batch(batch, device=dev)
    r_small = P.decompress_batch([z for z, _ in small], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, fn in foreign_kernels.items():
        launches[k] = fn.launches
    print(f"foreign path: {wall:.3f} s wall; launches "
          f"{ {k: launches[k] for k in foreign_kernels} }", flush=True)
    if not all(launches[k] > 0 for k in foreign_kernels):
        raise AssertionError(f"a kernel of the foreign path was not launched: {launches}")
    if r_text is None or r_idat is None or any(r is None for r in r_route):
        raise AssertionError("a full-size stream left the block-parallel route")
    if r_text != zlib.decompress(z_text8) or r_idat != zlib.decompress(z_idat8):
        raise AssertionError("try_foreign differs from zlib.decompress")
    want_batch = [zlib.decompress(z) for z in batch]
    if r_route != want_batch or r_batch != want_batch:
        raise AssertionError("the 16 x 1 MiB batch differs from zlib.decompress")
    for (z, want), got in zip(small, r_small):
        ok = got == want if isinstance(want, bytes) else type(got).__name__ == want
        if not ok:
            raise AssertionError(f"small batch: {got!r} where {want!r}")
    print(f"try_foreign text6 ({len(z_text8)} B) and idat1 ({len(z_idat8)} B), "
          f"try_foreign_batch and decompress_batch of {BATCH} x {LENGTH} B "
          f"idat1 == zlib.decompress; small batch "
          f"{[w if isinstance(w, str) else len(w) for _, w in small]}: ok",
          flush=True)

    # ---- 6. the foreign leg's times (card: see the line above) ------------
    legs = {}
    for kind, z, raw in (("text6", z_text8, text8), ("idat1", z_idat8, idat8)):
        t, total, host, L, legs[kind] = foreign_split(torch, P, PD, z, dev)
        parts = ", ".join(f"{k} {v:.4f}" for k, v in t.items())
        print(f"foreign {kind} ({FOREIGN_MB} MiB out, {len(z)} B in, {L} "
              f"lanes): {parts} ms; try_foreign (words on device, output "
              f"kept there) {total:.4f} ms = {len(raw) / total / 1e6:.4f} GB/s "
              f"of output; host zlib.decompress {len(raw) / host / 1e9:.4f} "
              f"GB/s [{card}]", flush=True)
        lanes_k, wd_k, bounds_k, _c1 = legs[kind]
        print(f"K4 on foreign {kind}: "
              f"{k4_report(torch, PD, lanes_k, wd_k, bounds_k, K)}",
              flush=True)
    k5_batch_report(torch, P, PD, batch, dev, card)
    tb = cuda_ms(torch, lambda: P.try_foreign_batch(batch, device=dev), 3)
    host = sum(min(timed(lambda: zlib.decompress(z)) for _ in range(3))
               for z in batch)
    nbytes = BATCH * LENGTH
    print(f"foreign batch idat1 {BATCH} x {LENGTH} B: try_foreign_batch "
          f"(bytes back on the host) {tb:.4f} ms = {nbytes / tb / 1e6:.4f} "
          f"GB/s of output; host zlib.decompress {nbytes / host / 1e9:.4f} "
          f"GB/s [{card}]", flush=True)

    lanes8, wd8, bounds8, c18 = legs["text6"]
    args8 = PD.lane_inputs(lanes8, wd8, *bounds8)
    got = inflate_records(*args8, K)
    want = inflate_records_plain(*args8, K)
    torch.cuda.synchronize()
    errs["inflate_records"] = max(errs["inflate_records"], check_equal(
        torch, "inflate_records (text6 8 MiB)", got, want))
    c8 = torch.from_numpy(c18).to(dev)
    n8 = len(z_text8) * 8
    errs["validate_headers"] = max(errs["validate_headers"], check_equal(
        torch, "validate_headers (text6 8 MiB)",
        validate_headers(wd8, c8, n8), validate_headers_plain(wd8, c8, n8)))
    nrec = int((got[0] != 0).sum())
    L8, n8c = args8[1].numel(), c8.numel()
    work.update({
        # per record: two table lookups, field extracts, store (16)
        "inflate_records": (4 * wd8.numel() + 4 * L8 * (64 + 160) + 32 * L8
                            + out_bytes(got), 16 * nrec),
        # per candidate: ~20 code-length reads and checks of 4 operations
        "validate_headers": (4 * wd8.numel() + 8 * n8c + 9 * n8c, 80 * n8c),
    })
    foreign_fns = {
        "inflate_records": (lambda: inflate_records(*args8, K),
                            lambda: inflate_records_plain(*args8, K), 1,
                            f"{args8[1].numel()} lanes, K={K}"),
        "validate_headers": (lambda: validate_headers(wd8, c8, n8),
                             lambda: validate_headers_plain(wd8, c8, n8),
                             PLAIN_REPS, f"{c8.numel()} candidates"),
    }
    sources.update({
        "inflate_records": ("fdeflate_tpu_torch/csrc/inflate_records.cu",
                            "fdeflate_tpu/ops/pallas_inflate.py:277 (_kernel)"),
        "validate_headers": ("fdeflate_tpu_torch/csrc/validate_headers.cu",
                             "fdeflate_tpu/ops/pallas_inflate.py:604 "
                             "(_validate_kernel)"),
    })
    for kname, (kern, plain, reps, shape) in foreign_fns.items():
        ms = cuda_ms(torch, kern, KERNEL_REPS)
        plain_ms = cuda_ms(torch, plain, reps, warm=False)
        src, repl = sources[kname]
        rows.append(kernel_row(kname, src, repl, launches[kname], errs[kname],
                               ms, plain_ms, work[kname]))
        print(f"{kname} (text6 {FOREIGN_MB} MiB, {shape}): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (one run) [{card}]"
              if reps == 1 else f"{kname} (text6 {FOREIGN_MB} MiB, {shape}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]",
              flush=True)

    # ---- 7-9. runtime trees and the checksum entry point ------------------
    rows.append(sep_phase(torch, P, dev, data, lengths, streams_in, streams,
                          inputs, card))
    adaptive_errs = adaptive_phase(torch, P, dev, data, lengths, card)
    for row in rows:
        if row["name"] in adaptive_errs:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     adaptive_errs[row["name"]])
    rows.append(checksum_phase(torch, P, dev, card,
                               launches["adler32_tiles"]))

    # ---- 10-12. the blocked layout: v2 roundtrip, A/B chain, K10 ---------
    v2_phase(torch, P, dev, data, lengths, card)
    rows += ab_phase(torch, P, dev, data, lengths, card)
    rows.append(grouped_phase(torch, P, dev, data, lengths, streams_in, card))

    # ---- 13. the indexed chunk-parallel decode: K11 ----------------------
    row, k11_steps = indexed_phase(torch, P, dev, corpus, card)
    rows.append(row)

    # ---- 14. the matched encoder, levels 1-3: K7 -------------------------
    matched_launches, matched_k7_ms = matched_phase(torch, P, dev, card)
    for row in rows:
        if row["name"] == "adler32_tiles":
            row["matched_launches"] = matched_launches
            row["matched_ms"] = matched_k7_ms

    # ---- 15. scale-out: the ("streams", "seq") mesh at world size 1 -------
    t0 = time.perf_counter()
    mesh_launches, mesh_errs = mesh_phase(torch, P, dev, corpus, card,
                                          k11_steps, (z_text8, legs["text6"], K))
    print(f"phase 15: {time.perf_counter() - t0:.1f} s by the host clock",
          flush=True)
    names = {fn.__name__: k for k, fn in mesh_kernels().items()}
    for row in rows:
        if row["name"] in names:
            row["mesh_launches"] = mesh_launches[names[row["name"]]]
            row["mesh_max_abs_err"] = mesh_errs[names[row["name"]]]

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
