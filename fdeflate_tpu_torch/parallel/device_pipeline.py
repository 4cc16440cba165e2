"""Standard-zlib encode and decode legs, their fused roundtrip, the
blocked-layout roundtrip, the adaptive-tree roundtrip and the indexed
chunk-parallel decode.

JAX counterpart: ``fdeflate_tpu/parallel/device_pipeline.py``
``zlib_encode_step``, ``zlib_decode_step``, ``fused_zlib_roundtrip``,
``fused_ultrafast_roundtrip_v2`` and ``fused_adaptive_roundtrip``, with the
same signatures and returns except
the decoded output: here it is u8[B, N] in standard byte order, where JAX
returns the TPU kernel's step-major ``out_sm i32[LB, T, 8, 128]``; and
the indexed decode (``_trained_tables``, ``stitch_and_materialize``,
``indexed_materialize``, ``indexed_decode_step``,
``decompress_batch_indexed``, ``fused_ultrafast_roundtrip``) with the same
signatures and returns, ``device=`` added to the entry points.  Its lanes
start at the encoder's exact chunk index (symbol-boundary bits) and run
K11 decode_symbols (``ops/decode_symbols.py``) from the stream words in
its live form (each lane's rows up to its step count); ``_place`` reads
those rows straight from the [K, B * C] records as one flat list in
JAX's stream order and ``ops/inflate.materialize_flat`` (plain torch, as
the JAX package's XLA) expands them.

The decode leg runs K3 (ops/decode2.py) straight from the linear words —
or, for a ``tree=`` profile, K6 (ops/decode_sep.py) with that tree's own
(meta, vals) rows — then checks, as the JAX leg does:
  * ``bpos_ok[b]``: every full lane's exit bit equals its index difference
    ``diff(chunk_starts ++ eof_pos)`` (lanes the stream's length does not
    cover are not checked);
  * ``ck_ok[b]``: the decode-side Adler-32 (ops/adler32.adler_lanes) equals
    the encoder's.

``tree``: an ``ops/septree.TreeProfile`` (or any object with its
``lens``, ``codes``, ``header_bytes`` and ``header_bits``).  The encode
takes any tree of codes up to 12 bits; the decode needs a class-separated one
(``sep_profile()``) and raises ValueError for another at step
construction.  (The JAX decode leg decodes every profile with the
canonical kernel tree's rows; the port decodes with the tree it is given.)

``wwin``, ``U`` and ``R`` size the TPU kernels' windows and grid; the port
reads every lane straight from the words, so it accepts and ignores them.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from .. import errors as E
from ..huffman import build_table
from ..ops import decode_symbols as DS
from ..ops.adaptive import encode_adaptive_blocked
from ..ops.adler32 import adler32_batch, adler_lanes
from ..ops.decode2 import decode2, decode_blocked
from ..ops.decode_sep import decode_sep
from ..ops.inflate import WINDOW, materialize_flat
from ..ops.ultrafast import (
    device_of,
    encode_fixed,
    encode_ultrafast_batch,
    encode_ultrafast_blocked,
)
from ..tables import (
    DEFAULT_DIST_TABLE_SIZE,
    DEFAULT_LITLEN_TABLE_SIZE,
    DISTANCE_TABLE_ENTRIES,
    HUFFMAN_LENGTHS,
    LITLEN_TABLE_ENTRIES,
)
from ..trees import TreeTables, sep_tables, trained_tables
from ..utils.profiling import count, span
from .discovery import decompress_batch


def zlib_encode_step(C: int, tree=None):
    """fn(data u8[B, N], lengths i32[B]) -> (words int32[B, W], total_bits
    int32[B], adler int64[B], chunk_starts int32[B, C], eof_pos int32[B])."""

    def step(data, lengths):
        return encode_fixed(data, lengths, C, tree=tree)

    return step


def _checks(out, bp, lane_bits, lengths, adler, C: int):
    """(bpos_ok bool[B], ck_ok bool[B]) of a decode: full lanes' exit bits
    against ``lane_bits`` [B, C], the decode-side Adler-32 against the
    encoder's."""
    B, N = out.shape
    S = N // C
    offs = torch.arange(C, device=out.device) * S
    full = offs[None, :] + S <= lengths.to(torch.int64)[:, None]
    bpos_ok = ((bp == lane_bits) | ~full).all(dim=1)
    return bpos_ok, adler_lanes(out, lengths, C) == adler


def decode_verify(words, chunk_starts, eof_pos, adler, lengths, N: int,
                  C: int, t: TreeTables):
    """The trained-tree decode leg on ``words``' device: K3, then the two
    checks.  Returns (out u8[B, N], bpos_ok bool[B], ck_ok bool[B])."""
    return _decode_verify(words, chunk_starts, eof_pos, adler, lengths, C,
                          lambda w, s: decode2(w, s, t.dtab, N, C))


def _decode_verify(words, chunk_starts, eof_pos, adler, lengths, C: int,
                   decode):
    """A decode leg with its lane decoder given: ``decode(words,
    chunk_starts) -> (out, bpos)``, a kernel wrapper or, to time it on the
    card, its plain version."""
    out, bp = decode(words, chunk_starts)
    ends = torch.cat([chunk_starts[:, 1:], eof_pos[:, None]], dim=1)
    return (out, *_checks(out, bp, ends - chunk_starts, lengths, adler, C))


def zlib_decode_step(C: int, N: int, wwin: int | None = None, U: int = 32,
                     R: int | None = None, tree=None):
    """fn(words, chunk_starts, eof_pos, adler, lengths) ->
    (out u8[B, N], bpos_ok bool[B], ck_ok bool[B])."""
    if N % C:
        raise ValueError("N must divide into C chunks")
    sep = None if tree is None else sep_tables(tree.lens)

    def step(words, chunk_starts, eof_pos, adler, lengths):
        if sep is None:
            return decode_verify(words, chunk_starts, eof_pos, adler,
                                 lengths, N, C,
                                 trained_tables(str(words.device)))
        meta, vals = (x.to(words.device) for x in sep)
        return _decode_verify(
            words, chunk_starts, eof_pos, adler, lengths, C,
            lambda w, s: decode_sep(w, s, meta, vals, N, C))

    return step


def fused_zlib_roundtrip(C: int, N: int, wwin: int | None = None, U: int = 32,
                         R: int | None = None, tree=None, *, device="cuda"):
    """Encode -> decode -> verify on ``device``, through a standard zlib
    artifact.  fn(data u8[B, N], lengths i32[B]) -> (out, bpos_ok, ck_ok);
    numpy or tensor inputs are moved to ``device``."""
    dev = device_of(device)
    enc = zlib_encode_step(C, tree=tree)
    dec = zlib_decode_step(C, N, wwin, U=U, R=R, tree=tree)

    def step(data, lengths):
        data = torch.as_tensor(data).to(dev)
        lengths = torch.as_tensor(lengths).to(dev, torch.int32)
        words, _total_bits, adler, starts, eof = enc(data, lengths)
        return dec(words, starts, eof, adler, lengths)

    return step


def _blocked_roundtrip(C: int, N: int, encode, device, name: str):
    """The blocked-layout roundtrip step on ``device``: ``encode(data,
    lengths) -> (win, chunk_bits, adler, tables)`` into lane windows,
    ``decode_blocked`` (K3 on each window from bit 0, with ``tables``, or
    the trained tree's when None), then both checks, exit bits against
    ``chunk_bits``.  fn(data, lengths) -> (out u8[B, N], bpos_ok bool[B],
    ck_ok bool[B], chunk_bits int32[B, C])."""
    dev = device_of(device)
    if N % C or (N // C) % 8:
        raise ValueError(f"{name} needs (N / C) % 8 == 0")
    S = N // C

    def step(data, lengths):
        data = torch.as_tensor(data).to(dev)
        lengths = torch.as_tensor(lengths).to(dev, torch.int32)
        B = data.shape[0]
        win, chunk_bits, adler, tables = encode(data, lengths)
        out, bp = decode_blocked(win, S // 4, tables=tables)
        out = out.reshape(B, N)
        bpos_ok, ck_ok = _checks(out, bp.reshape(B, C), chunk_bits, lengths,
                                 adler, C)
        return out, bpos_ok, ck_ok, chunk_bits

    return step


def fused_ultrafast_roundtrip_v2(C: int, N: int, U: int = 32,
                                 R: int | None = None, *, device="cuda"):
    """Blocked-layout roundtrip on ``device``: ``encode_ultrafast_blocked``
    (K1 into lane windows), ``decode_blocked`` (K3 on each window from bit
    0), then both checks, exit bits against ``chunk_bits``.

    fn(data u8[B, N], lengths i32[B]) -> (out u8[B, N], bpos_ok bool[B],
    ck_ok bool[B]); JAX returns the kernel's step-major ``out_sm`` where
    ``out`` is in standard byte order.  A ragged stream's last lane decodes
    its zero-padded window to zero bytes (the trained tree's zero literal
    is the all-zero 2-bit code), so the checksum covers it exactly.
    """
    step = _blocked_roundtrip(
        C, N, lambda d, ln: (*encode_ultrafast_blocked(d, ln, C), None),
        device, "fused_ultrafast_roundtrip_v2")
    return lambda data, lengths: step(data, lengths)[:3]


def fused_adaptive_roundtrip(C: int, N: int, U: int = 8, *, device="cuda"):
    """Adaptive-tree roundtrip on ``device``: the batch's own tree built on
    the device, K1 into lane windows with its tokens, K3 on each window
    with its decode table, both checks.

    fn(data u8[B, N], lengths i32[B]) -> (out u8[B, N], bpos_ok bool[B],
    ck_ok bool[B], total_bits: the 0-d sum of the lanes' payload bits).
    Exit bits are held to ``chunk_bits``.  Bytes past a stream's length
    decode from zero bits, whose symbol in this tree need not be a zero
    byte, so ``ck_ok`` (unmasked, as in JAX) may fail for ragged streams.
    """

    def encode(data, lengths):
        win, chunk_bits, adler, _lens, t = encode_adaptive_blocked(
            data, lengths, C)
        return win, chunk_bits, adler, t

    step = _blocked_roundtrip(C, N, encode, device, "fused_adaptive_roundtrip")

    def roundtrip(data, lengths):
        out, bpos_ok, ck_ok, chunk_bits = step(data, lengths)
        return out, bpos_ok, ck_ok, chunk_bits.sum()

    return roundtrip


# ---- the indexed chunk-parallel decode ------------------------------------


@functools.lru_cache(maxsize=1)
def _trained_tables():
    """The trained tree's reference decode tables as ``decode_symbols``
    reads them (JAX ``_trained_tables`` :40): (litlen u32[1, 4096],
    litlen_sec u32[1, 1] zeros, dist u32[1, 512] of the one distance code,
    dist_sec u32[1, 1] zeros, litlen_first i32[1, 4096])."""
    litlen = build_table(
        HUFFMAN_LENGTHS, LITLEN_TABLE_ENTRIES, DEFAULT_LITLEN_TABLE_SIZE,
        is_distance_table=False, double_literal=True,
    )
    dl = np.zeros(32, np.int64)
    dl[0] = 1
    dist = build_table(
        dl, DISTANCE_TABLE_ENTRIES, DEFAULT_DIST_TABLE_SIZE,
        is_distance_table=True, double_literal=False,
    )
    return (
        litlen.primary[None].astype(np.uint32),
        np.zeros((1, 1), np.uint32),
        dist.primary[None].astype(np.uint32),
        np.zeros((1, 1), np.uint32),
        litlen.first_len[None].astype(np.int32),
    )


@functools.lru_cache(maxsize=8)
def trained_symbol_tables(device: str) -> tuple[torch.Tensor, ...]:
    """``_trained_tables`` as int32 tensors on ``device``, made once."""
    return tuple(torch.from_numpy(x.view(np.int32).copy()).to(device)
                 for x in _trained_tables())


def chunk_lanes(total_bits: torch.Tensor, chunk_starts: torch.Tensor):
    """Per-lane inputs of the chunk-parallel decode, lanes stream-major
    (JAX :212-221): (starts, bit_end = the stream's bits, stops = the next
    lane's start or the stream's end, stream_row, active = start < stop),
    int32 (active bool) [B * C]."""
    B, C = chunk_starts.shape
    dev = chunk_starts.device
    cs = chunk_starts.to(torch.int32)
    starts = cs.reshape(-1)
    nxt = torch.cat([cs[:, 1:], torch.full((B, 1), 1 << 30, dtype=torch.int32,
                                          device=dev)], dim=1).reshape(-1)
    bits_l = total_bits.to(torch.int32).repeat_interleave(C)
    stops = torch.minimum(nxt, bits_l)
    srow = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(C)
    return starts, bits_l, stops, srow, starts < stops


def _place(records, first, steps, ok, C: int, out_capacity: int):
    """Materialize each lane's rows [first, steps) of ``decode_symbols``'
    records ([K, B * C], lanes stream-major; full or live form), stream by
    stream, with no rearrangement: the rows become one flat list in
    (stream, lane, step) order, which is JAX's [C * K, B] order within a
    stream (exclusive offsets of the lanes' row counts, each record's lane
    by a binary search of them, one gather per record array).  Every
    distance is checked against its record's position in its stream, and
    ``produced`` summed, by flat scans over the records.  Returns (out
    u8[B, out_capacity], produced int32[B], ok bool[B])."""
    rl, rlh, rc, rn, rd = records[:5]
    K, L = rl.shape
    B = L // C
    dev = rl.device
    i64 = torch.int64
    first = first.to(i64)
    n = (steps.to(i64) - first).clamp(min=0)
    ends = n.cumsum(0)
    total = int(ends[-1]) if L else 0
    idx = torch.arange(total, dtype=i64, device=dev)
    lane = torch.searchsorted(ends, idx, right=True)
    at = (idx - (ends - n)[lane] + first[lane]) * L + lane    # into [K, L]
    cnt, length, dist = (a.reshape(-1)[at] for a in (rc, rn, rd))
    adv = cnt.to(i64) + length.to(i64)
    csum = torch.cat([adv.new_zeros(1), adv.cumsum(0)])
    bounds = torch.cat([ends.new_zeros(1), ends[C - 1::C]])  # [B + 1]
    produced = csum[bounds[1:]] - csum[bounds[:-1]]
    stream = lane // C
    pos = csum[:-1] - csum[bounds[:-1]][stream]
    ok = ok.clone()
    ok[stream[(dist > 0) & (dist > pos)]] = False
    make = ((cnt > 0) | (adv > 0)).nonzero().squeeze(1)
    at_m = at[make]
    window = torch.zeros((B, WINDOW), dtype=torch.uint8, device=dev)
    out, _ = materialize_flat(stream[make], WINDOW + pos[make],
                              rl.reshape(-1)[at_m], rlh.reshape(-1)[at_m],
                              cnt[make], length[make], dist[make], window,
                              produced, out_capacity, want_window=False)
    return out, produced.to(torch.int32), ok


def _steps(records) -> torch.Tensor:
    """Each lane's step count from full-form records: its rows with a
    position."""
    return (records[5] >= 0).sum(0, dtype=torch.int32)


def stitch_and_materialize(records, bpos, status, starts, payload_start,
                           C: int, out_capacity: int,
                           ptr_rounds: int | None = None):
    """Stitch speculative chunk lanes' records and materialize (JAX
    ``stitch_and_materialize`` :60).

    ``records``: ``decode_symbols``' six records, each [K, B * C]
    (stream-major lanes, chain 1); ``bpos``/``status`` [B * C] the lanes'
    exits; ``starts`` [B * C] their start bits; ``payload_start`` [B] each
    stream's first payload bit.  Lane k's true entry is lane k-1's exit (the
    payload start for lane 0); a lane is synced where a step began at its
    entry, and its records before that step are dropped, as are lanes past
    the stream's first EOB lane.  A stream is ok when every used lane
    synced without an error status, an EOB was found and no distance
    reaches before the stream.  Returns (out u8[B, out_capacity], produced
    int32[B], ok bool[B]); ``ptr_rounds`` is accepted and ignored
    (``materialize``).
    """
    del starts, ptr_rounds
    rp = records[5]
    K, L = rp.shape
    B = L // C
    dev = rp.device
    k = torch.arange(C, device=dev).repeat(B)
    prev_exit = torch.cat([bpos[:1] * 0, bpos[:-1]])
    entries = torch.where(k == 0, payload_start.to(bpos.dtype)
                          .repeat_interleave(C), prev_exit)
    hit = rp == entries[None, :]
    synced = hit.any(dim=0)
    step = torch.arange(K, device=dev)[:, None]
    first = torch.where(hit, step, K).amin(dim=0)
    is_eob = status.reshape(B, C) == DS.EOB
    eob_k = torch.where(is_eob, torch.arange(C, device=dev)[None, :],
                        C).amin(dim=1)
    lane_used = k <= eob_k.repeat_interleave(C)
    lane_err = (status != DS.EOB) & (status != DS.STOPPED)
    ok = ((eob_k < C)
          & (synced | ~lane_used).reshape(B, C).all(dim=1)
          & (~lane_err | ~lane_used).reshape(B, C).all(dim=1))
    start = torch.where(lane_used, first, K)
    return _place(records, start, _steps(records), ok, C, out_capacity)


def indexed_materialize(records, status, starts_mat, C: int,
                        out_capacity: int, ptr_rounds: int | None = None,
                        steps=None):
    """Output of exactly indexed chunk lanes, no stitching (JAX
    ``indexed_materialize`` :150): every lane started at a symbol boundary,
    so all its records count.  A stream is ok when no lane has an error
    status (EOB and STOPPED are not errors), one reached EOB and no
    distance reaches before the stream.  Returns (out u8[B, out_capacity],
    produced int32[B], ok bool[B]); ``starts_mat`` and ``ptr_rounds`` are
    accepted and ignored, as ``starts_mat`` is in JAX.

    ``steps`` int32[L]: each lane's step count, for K11's live form
    (``_decode_symbols_live``: rows past it unwritten); None reads it from
    JAX's full records."""
    del starts_mat, ptr_rounds
    L = records[0].shape[1]
    B = L // C
    st2 = status.reshape(B, C)
    lane_err = (st2 != DS.EOB) & (st2 != DS.STOPPED)
    ok = ~lane_err.any(dim=1) & (st2 == DS.EOB).any(dim=1)
    if steps is None:
        steps = _steps(records)
    return _place(records, torch.zeros(L, dtype=torch.int64,
                                       device=status.device),
                  steps, ok, C, out_capacity)


def _indexed_symbols(words, total_bits, chunk_starts, max_steps: int,
                     chain: int):
    """K11's live form over the chunk lanes with the trained tables:
    (records, status with inactive lanes STOPPED, starts, steps).
    Distances are checked later, against the stitched positions, so
    ``out_pos`` is 1 << 30."""
    t = trained_symbol_tables(str(words.device))
    starts, bits_l, stops, srow, active = chunk_lanes(total_bits, chunk_starts)
    records, (_bpos, _opos, status), steps = DS._decode_symbols_live(
        words, starts, bits_l, torch.full_like(starts, 1 << 30), active,
        torch.zeros_like(starts), t[0], t[1], t[2], t[3],
        max_steps=max_steps, bit_stop=stops, chain=chain, stream_row=srow,
        litlen_first=t[4])
    return records, torch.where(active, status, DS.STOPPED), starts, steps


def indexed_decode_step(C: int, max_steps: int, out_capacity: int,
                        chain: int = 4, ptr_rounds: int | None = None):
    """Chunk-parallel decoder of indexed ultra-fast streams (JAX
    ``indexed_decode_step`` :197).

    fn(words int32[B, W], total_bits int32[B], chunk_starts int32[B, C]) ->
    (out u8[B, out_capacity], produced int32[B], ok bool[B]) on the words'
    device: K11 (one launch, the live form), then ``indexed_materialize``
    on its live records.
    """

    def step(words, total_bits, chunk_starts):
        records, status, starts, steps = _indexed_symbols(
            words, total_bits, chunk_starts, max_steps, chain)
        return indexed_materialize(records, status, starts, C, out_capacity,
                                   ptr_rounds, steps=steps)

    return step


def stage_indexed(streams: list[bytes], index: np.ndarray, device):
    """The inputs of ``decompress_batch_indexed``'s decode on ``device``, as
    JAX stages them: (words int32[B, W] with W a power of two, total_bits
    int32[B] of each stream but its Adler-32, chunk_starts int32[B, C],
    cap: the first output capacity, a power of two at or above half the
    largest stream's bits plus 256)."""
    B = len(streams)
    Wmax = 1 << int(np.ceil(np.log2(max(len(s) for s in streams) // 4 + 2)))
    words_np = np.zeros((B, Wmax), np.uint32)
    bits = np.zeros(B, np.int32)
    for i, s in enumerate(streams):
        body = s[:-4]  # the trailing Adler-32 is framing, not bitstream
        padded = body + bytes((-len(body)) % 4) + bytes(8)
        words_np[i, : len(padded) // 4] = np.frombuffer(padded, "<u4")
        bits[i] = len(body) * 8
    cap = 1 << int(np.ceil(np.log2(max(int(b) for b in bits) // 2 + 256)))
    words = torch.from_numpy(words_np.view(np.int32)).to(device)
    total_bits = torch.from_numpy(bits).to(device)
    chunk_starts = torch.from_numpy(np.array(index, np.int32)).to(device)
    return words, total_bits, chunk_starts, cap


def _active_lanes(streams: list[bytes], index: np.ndarray) -> int:
    """How many of ``chunk_lanes``' lanes are active (start < stop), from
    the index and the streams' lengths on the host."""
    cs = np.asarray(index, np.int64)
    bits = np.array([(len(s) - 4) * 8 for s in streams], np.int64)[:, None]
    nxt = np.concatenate([cs[:, 1:], np.full((len(cs), 1), 1 << 30)], axis=1)
    return int((cs < np.minimum(nxt, bits)).sum())


def decompress_batch_indexed(streams: list[bytes], index: np.ndarray,
                             max_steps: int | None = None, *,
                             device="cuda") -> list[bytes]:
    """Decode indexed ultra-fast streams with chunk-parallel lanes on
    ``device`` (JAX ``decompress_batch_indexed`` :240).

    ``index`` comes from ``compress_batch_ultra_fast(..., with_index=C)``.
    The output capacity starts at the JAX guess and grows (a power of two
    at or above the largest ``produced``) until every stream fits; the
    records are decoded once (K11) and only materialized again.  A stream
    the pipeline rejects (``ok`` False) is decoded by ``decompress_batch``
    instead (its error raised; counted in the counter
    ``indexed.fallback``), and every stream's Adler-32 is
    checked on the host (``WrongChecksum``); the first stream in order
    that fails raises.

    Spans (``utils/profiling.span``), inside the routing span
    ``indexed.batch`` and not nested in each other, each through its
    results on the host: ``indexed.stage`` (``stage_indexed``),
    ``indexed.decode`` (K11 and every ``indexed_materialize`` round),
    ``indexed.readback`` (the bytes and flags to the host) and
    ``indexed.verify`` (each stream's bytes and Adler-32 compare); the
    fallback runs in ``decompress_batch``'s own spans.  Counters, once
    each per call: ``indexed.calls``, ``indexed.streams``,
    ``indexed.lanes`` (active chunk lanes) and ``indexed.regrow``
    (materialize rounds after the first).
    """
    count("indexed.calls")
    count("indexed.streams", len(streams))
    with span("indexed.batch"):
        dev = device_of(device)
        C = index.shape[1]
        with span("indexed.stage"):
            words, total_bits, chunk_starts, cap = stage_indexed(streams,
                                                                 index, dev)
        count("indexed.lanes", _active_lanes(streams, index))
        if max_steps is None:
            max_steps = max(2048, cap // C)
        with span("indexed.decode"):
            records, status, starts, steps = _indexed_symbols(
                words, total_bits, chunk_starts, max_steps, 4)
            for rounds in range(1, 9):
                out, produced, ok = indexed_materialize(
                    records, status, starts, C, cap, steps=steps)
                produced = produced.cpu().numpy()
                if int(produced.max(initial=0)) <= cap:
                    break
                cap = 1 << int(np.ceil(np.log2(int(produced.max()))))
        count("indexed.regrow", rounds - 1)
        with span("indexed.readback"):
            out = out.cpu().numpy()
            ok = ok.cpu().numpy()
        with span("indexed.verify"):
            # Each stream's checksum right after its copy, while its bytes
            # are still in the cache.
            checked = []
            for i, s in enumerate(streams):
                data = out[i, : produced[i]].tobytes() if ok[i] else None
                checked.append((data, data is not None and zlib.adler32(data)
                                == int.from_bytes(s[-4:], "big")))

        results: list[bytes] = []
        for s, (data, good) in zip(streams, checked):
            if data is None:
                count("indexed.fallback")
                r = decompress_batch([s], device=dev)[0]
                if isinstance(r, E.DecompressionError):
                    raise r
                results.append(r)
            elif not good:
                raise E.WrongChecksum()
            else:
                results.append(data)
    return results


def fused_ultrafast_roundtrip(C: int, max_steps: int, N: int, chain: int = 4,
                              ptr_rounds: int | None = None,
                              lut_matmul: bool = False, *, device="cuda"):
    """Encode -> chunk-parallel decode -> verify on ``device`` (JAX
    ``fused_ultrafast_roundtrip`` :489).

    The encoder's exact chunk index starts every lane at a true symbol
    boundary (``encode_ultrafast_batch(num_chunks=C)``); the decode is ``indexed_decode_step``
    with ``out_capacity = N``, and each stream's Adler-32 of its ``produced``
    bytes (``adler32_batch``: K7 on the card) is compared with the
    encoder's.  fn(data u8[B, N], lengths i32[B]) -> (out u8[B, N],
    produced int32[B], ok bool[B], checksum_ok bool[B]); numpy or tensor
    inputs are moved to ``device``.  ``lut_matmul`` (a TPU lookup
    strategy) is accepted and ignored.
    """
    del lut_matmul
    dev = device_of(device)
    decode = indexed_decode_step(C, max_steps, N, chain, ptr_rounds)

    def step(data, lengths):
        data = torch.as_tensor(data).to(dev)
        lengths = torch.as_tensor(lengths).to(dev, torch.int32)
        words, total_bits, adler, chunk_starts = encode_ultrafast_batch(
            data, lengths, num_chunks=C)
        out, produced, ok = decode(words, total_bits, chunk_starts)
        return out, produced, ok, adler32_batch(out, produced) == adler

    return step
