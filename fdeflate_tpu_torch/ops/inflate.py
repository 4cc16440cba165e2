"""Batched decode of standard zlib streams: materialize and the sequential
per-block path.

JAX counterpart: ``fdeflate_tpu/ops/inflate.py`` — ``materialize``,
``_seq_pallas_launch`` and ``_decompress_batch_sequential`` with the
record-kernel engine (``decompress_batch``, which routes big streams to
block discovery first, is in ``parallel/discovery.py``).  The symbol phase is K4
(``ops/inflate_records.py``).  Between launches the host reads the framing,
stored and fixed blocks (``_frame``, after the port's copy of the JAX
package's ``_advance_headers`` in ``ops/inflate_host.py``); the dynamic
headers the streams reached are parsed, and their K4 tables built, by K12
(``ops/header_tables.py``), one launch a round, into a bank of tables that
stays on the device; K13 (``ops/materialize_records.py``) expands each
round's records into bytes, where JAX calls ``materialize``.  A header K12
does not make a lane of, or whose trees the host's rule refuses, is an
error: the host's parse of it (``_header_error``) gives only its class.

Where the JAX sequential path re-decodes a stream on its XLA engine
(``decode_symbols``) after any record-kernel anomaly, the port has no
second engine: K4 reads every block straight from the stream words (no
staged window to overrun) and classifies errors itself, checking
truncation against the stream's last bit and each distance against the
bytes produced so far, with ``decode_symbols``' precedence.  The error
class of every stream is the JAX path's.  For the same reason the fixed
code's symbols 286 and 287 end the block, as they do in the reference
decode tables (``tables.LITLEN_TABLE_ENTRIES``) that ``decode_symbols``
reads.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from .. import errors as E
from ..tables import FIXED_CODE_LENGTHS
from ..utils.profiling import count, span
from . import inflate_host as host
from .header_tables import LANE, header_tables
from .inflate_host import _CLS_EOB, _LIT_BASE, _canonical_order
from .inflate_records import (
    DONE_BAD_DIST,
    DONE_BAD_LITLEN,
    DONE_EOB,
    DONE_SLOTS,
    DONE_TOO_FAR,
    DONE_TRUNCATED,
    META_ROWS,
    TAB_PAIRS,
    inflate_records,
)
from .materialize_records import materialize_records
from .ultrafast import device_of, row_cumsum

WINDOW = host.WINDOW
_M32 = 0xFFFFFFFF
_STATUS = {
    DONE_BAD_LITLEN: E.Status.INVALID_LITERAL_LENGTH_CODE,
    DONE_BAD_DIST: E.Status.INVALID_DISTANCE_CODE,
    DONE_TRUNCATED: E.Status.INSUFFICIENT_INPUT,
    DONE_TOO_FAR: E.Status.DISTANCE_TOO_FAR_BACK,
}


def _literals(lo, hi, start, row, B: int, ext: int) -> torch.Tensor:
    """Literal bytes of records of up to eight literals, int64[B * ext]:
    each record (``row``, ``start``: its stream and first byte) adds its
    two words, shifted to its byte offset, into three output words (JAX's
    word-granular scatter; sums wrap at 32 bits)."""
    if ext % 4:
        raise ValueError("materialize: out_capacity must be a multiple of 4")
    extw = ext // 4
    lo = lo.to(torch.int64) & _M32
    hi = hi.to(torch.int64) & _M32
    s = (start & 3) * 8
    rsh = lambda x: torch.where(s == 0, 0, x >> (32 - s))  # noqa: E731
    parts = ((lo << s) & _M32, rsh(lo) | ((hi << s) & _M32), rsh(hi))
    wi = start >> 2
    words = torch.zeros(B * extw, dtype=torch.int64, device=lo.device)
    for off, wc in enumerate(parts):
        m = wi + off < extw
        words.index_add_(0, (row * extw + wi + off)[m], wc[m])
    words = (words & _M32).reshape(-1, 1)
    shifts = torch.tensor([0, 8, 16, 24], device=lo.device)
    return ((words >> shifts) & 0xFF).reshape(-1)


def _last_index(mask: torch.Tensor) -> torch.Tensor:
    """For each flat position, the index of the last True of ``mask`` at
    or before it (0 where there is none): a flat count and a gather."""
    where_true = mask.nonzero().squeeze(1)
    k = mask.to(torch.int64).cumsum(0) - 1
    if where_true.numel() == 0:
        return torch.zeros_like(k)
    return torch.where(k >= 0, where_true[k.clamp(min=0)], 0)


def materialize(records, window, produced, out_capacity: int,
                want_window: bool = True, ptr_rounds: int | None = None):
    """Expand decode records into output bytes (JAX ``materialize``).

    ``records`` = (lit, cnt, len, dist), each [K, B]: K4's records of at
    most two literals (``recs_to_records``; JAX ``max_lit_bytes=2``), or
    (lit_lo, lit_hi, cnt, len, dist): ``decode_symbols``' records of up to
    eight literals packed LSB first into two words (JAX
    ``max_lit_bytes=8``).  ``window`` u8[B, 32768] prior output,
    right-aligned; ``produced`` int[B] bytes the records make (used for
    masking); ``out_capacity`` a bound on ``produced``.  Returns
    (u8[B, out_capacity], new window).

    The front is ``flat_records`` on the transposed records;
    ``materialize_flat`` places them.  ``ptr_rounds`` is accepted and
    ignored: pointer doubling runs to its fixed point, which is JAX's
    result with ``ptr_rounds=None`` (its default).
    """
    del ptr_rounds
    _, flat = flat_records([a.T for a in records])
    return materialize_flat(*flat, window, produced, out_capacity,
                            want_window)


def flat_records(records):
    """``materialize``'s front on row-major records: ``records`` as
    ``materialize`` takes them, but each [B, K] (row b holds stream b's
    records in step order; any strides).

    Returns (pos, flat): ``pos`` int64[B, K], the bytes row b makes before
    each of its records (one flat scan of the records' lengths:
    ``row_cumsum``), and ``flat`` = (row, start, lo, hi, cnt, length,
    dist), the records that make bytes (most slots of a chunk-parallel
    decode are empty) as flat lists in (row, step) order, ``start``
    absolute (the 32 KiB window first): ``materialize_flat``'s first seven
    arguments.
    """
    if len(records) == 5:
        rl, rlh, rc, rn, rd = records
    else:
        (rl, rc, rn, rd), rlh = records, None
    K = rl.shape[1]
    i64 = torch.int64
    adv = (rc.to(i64) + rn.to(i64)).contiguous()
    pos = row_cumsum(adv) - adv
    sel = ((rc > 0) | (adv > 0)).reshape(-1).nonzero().squeeze(1)
    row, col = sel // K, sel % K
    hi = torch.zeros_like(sel) if rlh is None else rlh[row, col]
    return pos, (row, WINDOW + pos.reshape(-1)[sel], rl[row, col], hi,
                 rc[row, col], rn[row, col], rd[row, col])


def materialize_flat(row, start, lo, hi, cnt, length, dist, window, produced,
                     out_capacity: int, want_window: bool = True):
    """The position side of ``materialize``, from flat lists of records in
    (row, start) order: each record's row, first byte ``start`` (absolute,
    the 32 KiB window first), literal words ``lo``/``hi``, literal count,
    match length and distance.  Returns (u8[B, out_capacity], new window).

    Literals land word by word, as JAX scatters them, each record's literal
    words added at its byte offset (K4's records with a zero second word);
    each position finds the record that contains it by a flat count of
    record starts, and so its (start, dist); a back-reference position
    points to start - dist + (i - start) mod dist; dist-1 spans point to
    the byte before the span; pointer doubling runs to a fixed point; one
    gather reads the bytes.  Records that start past ``out_capacity`` are
    dropped.
    """
    B = window.shape[0]
    dev = window.device
    i64 = torch.int64
    row, start = row.to(i64), start.to(i64)
    produced = torch.as_tensor(produced, device=dev).to(i64).reshape(B)
    ext = WINDOW + out_capacity

    lits = (cnt > 0).nonzero().squeeze(1)
    vals = _literals(lo[lits], hi[lits], start[lits], row[lits], B,
                     ext).reshape(B, ext)

    # The record containing each position: starts of the records that
    # make bytes, in (row, start) order, counted along the flat positions.
    adv = cnt.to(i64) + length.to(i64)
    recs = ((adv > 0) & (start < ext)).nonzero().squeeze(1)
    r_start = start[recs]
    r_len = length[recs].to(i64)
    r_dist = torch.where(r_len > 0, (dist[recs].to(i64) - 1).clamp(min=0) + 1,
                         0)
    marks = torch.zeros(B * ext, dtype=torch.bool, device=dev)
    marks[row[recs] * ext + r_start] = True
    k = marks.to(i64).cumsum(0) - 1
    found = k >= 0
    k = k.clamp(min=0)
    if recs.numel():
        rec_start = torch.where(found, r_start[k], 0).reshape(B, ext)
        pos_dist = torch.where(found, r_dist[k], 0).reshape(B, ext)
    else:
        rec_start = pos_dist = torch.zeros((B, ext), dtype=i64, device=dev)

    posi = torch.arange(ext, device=dev, dtype=i64)[None, :]
    in_new = (posi >= WINDOW) & (posi < WINDOW + produced[:, None])
    is_copy = in_new & (pos_dist > 0)
    # Single hop: a copy of distance d repeats the d bytes before its
    # record, so position i maps to start - d + (i - start) mod d.
    d_safe = pos_dist.clamp(min=1)
    hop = rec_start - d_safe + torch.remainder(posi - rec_start, d_safe)
    ptr = torch.where(is_copy, hop, posi.expand(B, ext))
    # A dist-1 span copies the byte before it: the last position at or
    # before i that is not in such a span (every row's window is not).
    is_d1 = is_copy & (pos_dist == 1)
    row0 = torch.arange(B, device=dev, dtype=i64)[:, None] * ext
    left = _last_index(~is_d1.reshape(-1)).reshape(B, ext) - row0
    ptr = torch.where(is_d1, left, ptr)
    for _ in range(max(1, (ext - 1).bit_length())):   # chains halve each round
        nxt = ptr.gather(1, ptr)
        changed = bool((nxt != ptr).any())
        ptr = nxt
        if not changed:
            break

    base = torch.cat([window.to(i64), vals[:, WINDOW:]], dim=1)
    out = base.gather(1, ptr)[:, WINDOW:]
    out = torch.where(in_new[:, WINDOW:], out, 0).to(torch.uint8)
    if not want_window:
        return out, window
    full = torch.cat([window, out], dim=1)
    idx = (torch.arange(WINDOW, device=dev)[None, :]
           + produced[:, None]).clamp(0, full.shape[1] - 1)
    return out, full.gather(1, idx)


@functools.lru_cache(maxsize=1)
def fixed_meta_tab():
    """``foreign_meta`` of the fixed code with symbols 286/287 as end of
    block (their entries in the reference decode tables)."""
    meta, tab = host._fixed_foreign_meta()
    tab = tab.copy()
    order = _canonical_order(np.asarray(FIXED_CODE_LENGTHS, np.int64)[:288])
    pairs = tab.view(np.uint32)
    for sym in (286, 287):
        i = _LIT_BASE + int(np.flatnonzero(order == sym)[0])
        sh = (i & 1) * 16
        pairs[i >> 1] = (int(pairs[i >> 1]) & ~(0xFFFF << sh) & 0xFFFFFFFF) | (
            (_CLS_EOB << 13) << sh)
    return meta, tab


def pad_words(streams: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Little-endian words of the streams, each padded to a word and by 8
    zero bytes (``discovery.stage_words``), concatenated.  Returns (words
    int32[W], word_base int64[S + 1]); the words are one copy of the
    streams' bytes, writable."""
    pads = [bytes((-len(s)) % 4 + 8) for s in streams]
    base = np.zeros(len(streams) + 1, np.int64)
    base[1:] = np.cumsum([(len(s) + len(p)) // 4
                          for s, p in zip(streams, pads)])
    buf = bytearray().join(x for pair in zip(streams, pads) for x in pair)
    return np.frombuffer(buf, "<i4").astype(np.int32, copy=False), base


def record_budget(max_steps: int) -> int:
    """Record slots per lane of the sequential path's launches (JAX
    ``_seq_pallas_launch``: 4 * max_steps to a power of two, <= 8192)."""
    return min(8192, 1 << max(4, (4 * max_steps - 1).bit_length()))


@functools.lru_cache(maxsize=8)
def _fixed_rows(dev: torch.device):
    """``fixed_meta_tab()`` as (meta int32[1, 64], tab int32[1, 160]) on
    ``dev``, uploaded once per device."""
    meta, tab = fixed_meta_tab()
    return (torch.from_numpy(meta).reshape(1, -1).to(dev),
            torch.from_numpy(tab).reshape(1, -1).to(dev))


def _frame(st) -> int | None:
    """``_advance_headers`` up to a dynamic header, which it does not parse:
    the zlib header at bit 0, stored blocks (copied), a fixed block
    entered, the Adler-32 after the last block, with the original's errors.
    Returns the stream bit of the dynamic header it stopped at (the stream
    left there, ``last_block`` as before the header), else None."""
    r = host._HostBitReader(st.data, st.bitpos)
    try:
        if st.bitpos == 0:
            cmf = r.take(8)
            flg = r.take(8)
            if (cmf & 0x0F != 0x08 or (cmf & 0xF0) > 0x70 or flg & 0x20 != 0
                    or ((cmf << 8) | flg) % 31 != 0):
                raise E.BadZlibHeader()
        while not st.done and not st.in_block:
            if st.last_block:
                r.pos = (r.pos + 7) & ~7
                stored = int.from_bytes(r.take(32).to_bytes(4, "little"),
                                        "big")
                if stored != zlib.adler32(st.out):
                    raise E.WrongChecksum()
                st.done = True
                break
            header = r.take(3)
            btype = header >> 1
            if btype == 0b10:
                st.bitpos = r.pos - 3
                return st.bitpos
            st.last_block = bool(header & 1)
            if btype == 0b00:
                r.pos = (r.pos + 7) & ~7
                length = r.take(16)
                nlen = r.take(16)
                if nlen != (~length & 0xFFFF):
                    raise E.InvalidUncompressedBlockLength()
                byte0 = r.pos >> 3
                if len(st.data) - byte0 < length:
                    raise E.InsufficientInput()
                chunk = st.data[byte0: byte0 + length]
                st.out += chunk
                host._update_window(st, np.frombuffer(chunk, np.uint8))
                r.pos += length * 8
            elif btype == 0b01:
                st.in_block = True
            else:
                raise E.InvalidBlockType()
    except E.DecompressionError as err:
        st.error = err
        st.done = True
    st.bitpos = r.pos
    return None


class _Bank:
    """The K4 tables of each stream's current block, on the device for the
    call: meta int32[S, 64], tab int32[S, 160], row i stream i's.  K12's
    rows and the fixed code's are written in stream order, with no wait on
    the device."""

    def __init__(self, S: int, dev: torch.device):
        self.dev = dev
        self.meta = torch.zeros(S, META_ROWS, dtype=torch.int32, device=dev)
        self.tab = torch.zeros(S, TAB_PAIRS, dtype=torch.int32, device=dev)

    def put(self, slots: torch.Tensor, meta, tab) -> None:
        self.meta.index_copy_(0, slots, meta)
        self.tab.index_copy_(0, slots, tab)

    def put_fixed(self, streams: list[int]) -> None:
        meta, tab = _fixed_rows(self.dev)
        n = len(streams)
        self.put(torch.tensor(streams, dtype=torch.int64, device=self.dev),
                 meta.expand(n, -1), tab.expand(n, -1))

    def take(self, lanes: torch.Tensor):
        return (self.meta.index_select(0, lanes),
                self.tab.index_select(0, lanes))


def _bit_rows(states, si: np.ndarray, bits, word_base):
    """(rows int64[3, n], base): the streams ``si`` at their stream bits
    ``bits`` over the concatenated words, as the kernels take them (the
    absolute bit, the stream's word end, its payload's end bit), and each
    stream's first bit."""
    base = word_base[si] * 32
    ends = np.array([len(states[i].data) * 8 for i in si.tolist()], np.int64)
    return np.stack([base + np.asarray(bits, np.int64), word_base[si + 1],
                     base + ends]), base


def _header_error(st, bit: int) -> None:
    """End the stream with the error class of its dynamic header at stream
    bit ``bit``, one that K12 made no lane of or whose trees the host's rule
    refuses: the host's parse (``_parse_dynamic_lengths``, ``_check_trees``)
    from there raises it, as in ``_advance_headers``.  A header the host
    takes here is one K12 refused wrongly, and raises RuntimeError."""
    r = host._HostBitReader(st.data, bit + 3)
    try:
        host._check_trees(*host._parse_dynamic_lengths(r))
    except E.DecompressionError as err:
        st.error = err
        st.done = True
        st.bitpos = r.pos
        return
    raise RuntimeError(f"K12 refused a dynamic header at bit {bit} that "
                       "the host's parse takes")


def _enter(states, idx, words, word_base, bank: _Bank) -> int:
    """Move the streams ``idx`` to their next compressed block or their
    end; returns the bytes their stored blocks appended.

    The host frames each stream (``_frame``); one K12 launch takes the
    dynamic headers they reached and writes its rows into their slots of
    ``bank``; one read-back of its ``info`` routes them.  A lane whose trees
    the host's rule takes enters its block at K12's symbol start; any other
    header ends its stream with the host's error class (``_header_error``,
    ``sequential.headers.host``).  Counts the blocks entered, by kind."""
    stored, heads, fixed = 0, [], []
    for i in idx:
        st = states[i]
        n = len(st.out)
        bit = _frame(st)
        stored += len(st.out) - n
        if bit is not None:
            heads.append((i, bit))
        elif st.in_block:
            fixed.append(i)
    if fixed:
        bank.put_fixed(fixed)
    count("sequential.blocks.fixed", len(fixed))
    if not heads:
        return stored
    si = np.array([i for i, _ in heads], np.int64)
    rows, base = _bit_rows(states, si, [bit for _, bit in heads], word_base)
    cols = torch.from_numpy(np.vstack([rows, si])).to(bank.dev)
    info, meta, tab = header_tables(words, cols[0], cols[1], cols[2])
    bank.put(cols[3], meta, tab)
    status, bfinal, start, host_ok = info.cpu().numpy()
    entered = 0
    for j, (i, bit) in enumerate(heads):
        st = states[i]
        if status[j] == LANE and host_ok[j]:
            st.bitpos = int(start[j] - base[j])
            st.last_block = bool(bfinal[j])
            st.in_block = True
            entered += 1
        else:
            _header_error(st, bit)
    count("sequential.headers.device", entered)
    count("sequential.headers.host", len(heads) - entered)
    count("sequential.blocks.dynamic", entered)
    return stored


def _seq_launch(states, lanes, words, word_base, bank: _Bank, K: int):
    """One K4 launch over the current block of the streams in ``lanes``,
    each with its bank row.

    The per-lane uploads and the rows' gather run in the span
    ``sequential.parse``; the launch runs through the read-back of its
    exits in ``sequential.records``.  Returns (records [K, len(lanes)],
    bpos int64 (stream bits), done, nout) with bpos, done and nout on the
    host."""
    with span("sequential.parse"):
        si = np.asarray(lanes, np.int64)
        rows, base = _bit_rows(states, si, [states[i].bitpos for i in lanes],
                               word_base)
        out0 = np.array([len(states[i].out) for i in lanes], np.int64)
        cols = torch.from_numpy(np.vstack([rows, out0, si])).to(bank.dev)
        meta, tab = bank.take(cols[4])
    count("sequential.launches")
    count("sequential.lanes", len(lanes))
    with span("sequential.records"):
        recs, bpos, nout, done = inflate_records(words, *cols[:4], meta, tab,
                                                 K)
        return (recs, bpos.cpu().numpy() - base, done.cpu().numpy(),
                nout.cpu().numpy())


def decompress_sequential(streams: list[bytes], max_steps: int = 8192, *,
                          device):
    """Per-block decode with one K4 lane per stream (JAX
    ``_decompress_batch_sequential``, record-kernel engine).

    Between launches the host frames the streams and copies stored blocks,
    and one K12 launch parses the dynamic headers they reached
    (``_enter``); each launch decodes the current dynamic or fixed block of
    every active stream until EOB, an error or K records, with its tables
    from the bank on the device; one K13 launch (``materialize_records``)
    expands its records into bytes and the next windows.  The 32 KiB
    window of prior output stays on the device across launches in which no
    stream left its block.
    Returns per stream the bytes or the error.

    Runs in the span ``inflate.sequential``, and inside it, one after
    another and not nested, ``sequential.parse`` (the streams' words
    staged; the framing, K12 through the read-back of its ``info``, the
    host's parse of the headers it refused; each launch's per-lane uploads
    and tables), ``sequential.records`` (K4 through the read-back of its
    exits) and ``sequential.materialize`` (K13, the bytes read back, the
    windows kept, uploaded or read back, each stream's bytes appended).
    Counts ``sequential.streams``, ``sequential.launches``,
    ``sequential.lanes`` (each launch's lanes: its warps),
    ``sequential.blocks.dynamic`` / ``.fixed`` (blocks entered),
    ``sequential.headers.device`` / ``.host`` (dynamic headers K12 turned
    into blocks; headers it refused, each its stream's error),
    ``sequential.stored_bytes`` (bytes the host copied from stored blocks)
    and ``sequential.window_host`` (launches whose windows were uploaded
    from the host).
    """
    with span("inflate.sequential"):
        dev = device_of(device)
        count("sequential.streams", len(streams))
        if not streams:
            return []
        states = [host._StreamState(s) for s in streams]
        with span("sequential.parse"):
            words_np, word_base = pad_words(streams)
            words = torch.from_numpy(words_np).to(dev)
            bank = _Bank(len(streams), dev)
            stored = _enter(states, range(len(streams)), words, word_base,
                            bank)
        K = record_budget(max_steps)
        win_dev, win_lanes = None, None   # device windows of the last launch

        while True:
            lanes = [i for i, st in enumerate(states)
                     if not st.done and st.in_block]
            if not lanes:
                break
            recs, bpos, done, nout = _seq_launch(states, lanes, words,
                                                 word_base, bank, K)
            failed = done > DONE_EOB
            produced = np.where(failed, 0, nout)
            cap = max(256, 1 << int(np.ceil(np.log2(
                max(int(produced.max()), 1)))))
            ended = []                    # lanes that reached their EOB
            with span("sequential.materialize"):
                if win_lanes == lanes:
                    window = win_dev
                else:
                    count("sequential.window_host")
                    window = torch.from_numpy(
                        np.stack([states[i].window for i in lanes])).to(dev)
                out, new_window = materialize_records(
                    recs, window, torch.from_numpy(produced).to(dev), cap)
                out_np = out.cpu().numpy()
                if (done == DONE_SLOTS).all():
                    # No stream leaves its block: the windows stay on the
                    # device.
                    win_dev, win_lanes = new_window, lanes
                    new_window_np = None
                else:
                    win_dev, win_lanes = None, None
                    new_window_np = new_window.cpu().numpy()
                for j, i in enumerate(lanes):
                    st = states[i]
                    if failed[j]:
                        st.error = E.error_for_status(_STATUS[int(done[j])])
                        st.done = True
                        continue
                    st.out += out_np[j, : produced[j]].tobytes()
                    if new_window_np is not None:
                        st.window = new_window_np[j]
                    st.bitpos = int(bpos[j])
                    if done[j] == DONE_EOB:
                        st.in_block = False
                        ended.append(i)
            if ended:
                with span("sequential.parse"):
                    stored += _enter(states, ended, words, word_base, bank)
        count("sequential.stored_bytes", stored)

        results: list[bytes | E.DecompressionError] = []
        for st in states:
            if st.error is not None:
                results.append(st.error)
            elif not st.done:
                results.append(E.InsufficientInput())
            else:
                results.append(bytes(st.out))
        return results
