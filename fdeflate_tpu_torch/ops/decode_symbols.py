"""K11 decode_symbols: the table-gather symbol engine, one lane per stream
or chunk.

JAX counterpart: ``fdeflate_tpu/ops/inflate.py:64 decode_symbols``, an XLA
``while_loop`` (no Pallas kernel) that advances every active lane one
decode step per iteration and records each step's output.  The CUDA kernel
is ``csrc/decode_symbols.cu`` (its lane code in ``csrc/symbols_lanes.cuh``);
``decode_symbols_plain`` is its plain version, the JAX loop step for step
over all lanes at once.  ``_decode_symbols_live`` is the same engine in
the live form the indexed decode reads: each lane's records up to its
step count, nothing written past it.

A step reads up to 32 bits at the lane's bit position and looks them up in
the reference's 4096-entry literal/length table (``huffman.build_table``
format): a literal entry resolves one or two literals, and ``chain`` (1, 2
or 4) entries may chain in one step, so a step emits up to ``2 * chain``
literals; otherwise the step decodes one length/distance pair (through the
secondary tables for codes longer than 12 bits), the end of the block, or
an error.  Records, each ``[max_steps, L]``, are ``(lit_lo, lit_hi, cnt,
len, dist, bit_pos_at_step)``: the step's literals packed LSB first into
two 32-bit words (int32 bit patterns), their count (int8), the match
length and distance, and the bit position where the step began (-1 where
the lane was not running).  A lane that is not running writes zeros and
-1, its records' initial values.  The state is ``(bit_pos, out_pos,
status)``, status ``OK`` (ran out of steps), ``EOB``, ``STOPPED`` (reached
``bit_stop``) or an ``errors.Status`` code.

Semantics kept exactly (the tests hold each to JAX): a word read past a
row's last word reads the last word again; a double-literal entry whose
second symbol would cross ``bit_stop`` is split (``litlen_first``); a
chained level is taken only while the lane is short of ``bit_stop``;
secondary indices are clipped to the secondary table's width; truncation
beats an invalid code, which beats a distance too far back; an end of
block that is not truncated advances the position; shifts by 32 or more
give 0, as XLA's do.

``lut_matmul`` picks a TPU lookup strategy (one-hot matmuls on the MXU)
that gives the same entries; the port accepts and ignores it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .. import errors as E
from ..huffman import build_table
from ..tables import (
    DEFAULT_DIST_TABLE_SIZE,
    DEFAULT_LITLEN_TABLE_SIZE,
    DISTANCE_TABLE_ENTRIES,
    LITLEN_TABLE_ENTRIES,
)

# Per-lane status codes (JAX ops/inflate.py:50-56).
OK = 0
EOB = 1
STOPPED = 2
ERR_LITLEN = int(E.Status.INVALID_LITERAL_LENGTH_CODE)
ERR_DIST = int(E.Status.INVALID_DISTANCE_CODE)
ERR_TOO_FAR = int(E.Status.DISTANCE_TOO_FAR_BACK)
ERR_TRUNC = int(E.Status.INSUFFICIENT_INPUT)

NO_STOP = 0x7FFFFFFF      # bit_stop when none is given
_M32 = 0xFFFFFFFF


def tables_from_lengths(lengths: np.ndarray, hlit: int):
    """A dynamic block's reference decode tables from its parsed code
    lengths (litlen at [0:hlit], distance at [288:320]): (litlen u32[4096],
    litlen_sec u16[S], dist u32[512], dist_sec u16[S2]).  Copy of
    ``fdeflate_tpu/ops/inflate.py:691 _tables_from_lengths``."""
    litlen = build_table(
        lengths[:hlit], LITLEN_TABLE_ENTRIES, DEFAULT_LITLEN_TABLE_SIZE,
        is_distance_table=False, double_literal=True,
    )
    if not litlen.ok:
        raise E.BadCodeLengthHuffmanTree()
    dist_lengths = lengths[288:320]
    if not dist_lengths.any():
        dist_primary = np.zeros(DEFAULT_DIST_TABLE_SIZE, np.uint32)
        dist_secondary = np.zeros(0, np.uint16)
    else:
        dist = build_table(
            dist_lengths, DISTANCE_TABLE_ENTRIES, DEFAULT_DIST_TABLE_SIZE,
            is_distance_table=True, double_literal=False,
        )
        if not dist.ok:
            raise E.BadDistanceHuffmanTree()
        dist_primary = dist.primary
        dist_secondary = dist.secondary
    return litlen.primary, litlen.secondary, dist_primary, dist_secondary


def stack_tables(tables) -> tuple[np.ndarray, ...]:
    """Stack blocks' ``tables_from_lengths`` results as ``decode_symbols``
    reads them: (litlen u32[T, 4096], litlen_sec u32[T, S], dist
    u32[T, 512], dist_sec u32[T, S2]), secondaries zero-padded to the
    widest (at least 1), as ``fdeflate_tpu/ops/inflate.py:1266-1278``."""
    T = max(len(tables), 1)
    sec_max = max([len(t[1]) for t in tables] + [1])
    dsec_max = max([len(t[3]) for t in tables] + [1])
    litlen = np.zeros((T, DEFAULT_LITLEN_TABLE_SIZE), np.uint32)
    sec = np.zeros((T, sec_max), np.uint32)
    dist = np.zeros((T, DEFAULT_DIST_TABLE_SIZE), np.uint32)
    dsec = np.zeros((T, dsec_max), np.uint32)
    for t, (ll, ls, dd, ds) in enumerate(tables):
        litlen[t] = ll
        sec[t, : len(ls)] = ls
        dist[t] = dd
        dsec[t, : len(ds)] = ds
    return litlen, sec, dist, dsec


def _i32(x, device) -> torch.Tensor:
    """A table or lane vector as a contiguous int32 tensor on ``device``
    (uint32 numpy arrays keep their bit patterns)."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = torch.as_tensor(x)
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return _build.i32(x.to(device))


def _check(words, L: int, litlen, litlen_sec, dist, dist_sec, first,
           lanes, chain: int) -> int:
    """Raise on shapes the engine does not take; returns T."""
    if words.dim() != 2 or words.shape[1] < 1:
        raise ValueError("decode_symbols: words must be [rows, W >= 1]")
    T = litlen.shape[0]
    if (litlen.shape != (T, DEFAULT_LITLEN_TABLE_SIZE)
            or dist.shape != (T, DEFAULT_DIST_TABLE_SIZE)
            or litlen_sec.dim() != 2 or dist_sec.dim() != 2
            or litlen_sec.shape[0] != T or dist_sec.shape[0] != T
            or litlen_sec.shape[1] < 1 or dist_sec.shape[1] < 1
            or (first is not None and first.shape != litlen.shape)):
        raise ValueError("decode_symbols: tables must be litlen[T, 4096], "
                         "litlen_sec[T, S >= 1], dist[T, 512], "
                         "dist_sec[T, S2 >= 1], litlen_first[T, 4096]")
    if any(x.numel() != L for x in lanes):
        raise ValueError("decode_symbols: every lane vector needs L entries")
    if chain not in (1, 2, 4):
        raise ValueError("decode_symbols: chain must be 1, 2 or 4")
    return T


def engine_inputs(words, bit_pos, bit_end, out_pos, active, table_id,
                  litlen, litlen_sec, dist, dist_sec, bit_stop=None,
                  chain: int = 4, stream_row=None, litlen_first=None):
    """``decode_symbols``' arguments as the engine reads them, on the
    words' device: (words int32[rows, W], lanes = [bit_pos, bit_end,
    out_pos, active, table_id, bit_stop] int32[L], stream_row int32[L],
    tables = [litlen, litlen_sec, dist, dist_sec] int32, litlen_first
    int32 or None, T); raises on shapes the engine does not take."""
    dev = words.device
    L = int(torch.as_tensor(bit_pos).numel())
    lanes = [_i32(x, dev).reshape(-1) for x in
             (bit_pos, bit_end, out_pos, active, table_id)]
    lanes.append(torch.full((L,), NO_STOP, dtype=torch.int32, device=dev)
                 if bit_stop is None else _i32(bit_stop, dev).reshape(-1))
    rows = (torch.arange(L, dtype=torch.int32, device=dev) if stream_row
            is None else _i32(stream_row, dev).reshape(-1))
    tabs = [_i32(x, dev) for x in (litlen, litlen_sec, dist, dist_sec)]
    first = None if litlen_first is None else _i32(litlen_first, dev)
    words = _build.i32(words)
    T = _check(words, L, *tabs, first, lanes + [rows], chain)
    return words, lanes, rows, tabs, first, T


def decode_symbols(words, bit_pos, bit_end, out_pos, active, table_id,
                   litlen, litlen_sec, dist, dist_sec, max_steps: int,
                   bit_stop=None, chain: int = 4, stream_row=None,
                   litlen_first=None, lut_matmul: bool = False):
    """Run up to ``max_steps`` decode steps on every active lane.

    ``words`` int32[rows, W] (u32 patterns); per lane ``bit_pos``,
    ``bit_end``, ``out_pos``, ``table_id`` int32[L] (in [0, T)),
    ``active`` bool[L], optional ``bit_stop`` and ``stream_row`` (the row
    of ``words`` a lane reads; lane i reads row i when None); tables
    ``litlen`` u32/int32[T, 4096], ``litlen_sec`` [T, S], ``dist``
    [T, 512], ``dist_sec`` [T, S2] and optional ``litlen_first``
    [T, 4096].  Numpy tables are moved to the words' device.  Returns
    (records, (bit_pos, out_pos, status)) as the module docstring
    describes: JAX's full [max_steps, L] records.  CPU tensors take
    ``decode_symbols_plain``; CUDA tensors launch K11, one launch per call.
    """
    del lut_matmul  # a TPU lookup strategy with the same entries
    return _run(True, words, bit_pos, bit_end, out_pos, active, table_id,
                litlen, litlen_sec, dist, dist_sec, max_steps, bit_stop,
                chain, stream_row, litlen_first)[:2]


def _decode_symbols_live(words, bit_pos, bit_end, out_pos, active, table_id,
                         litlen, litlen_sec, dist, dist_sec, max_steps: int,
                         bit_stop=None, chain: int = 4, stream_row=None,
                         litlen_first=None):
    """``decode_symbols``' live form: (records, state, steps int32[L]).

    Lane i's records are rows [0, steps[i]) (the steps it ran, ``(pos >=
    0).sum(0)`` of the full form); K11 leaves the rows past them unwritten,
    so a reader takes each lane's count.  CPU tensors take
    ``decode_symbols_plain`` (every row written) and count its steps; CUDA
    tensors launch K11 once (counter ``launch.decode_symbols``)."""
    return _run(False, words, bit_pos, bit_end, out_pos, active, table_id,
                litlen, litlen_sec, dist, dist_sec, max_steps, bit_stop,
                chain, stream_row, litlen_first)


def _run(fill: bool, words, bit_pos, bit_end, out_pos, active, table_id,
         litlen, litlen_sec, dist, dist_sec, max_steps, bit_stop, chain,
         stream_row, litlen_first):
    """K11 or its plain version: (records, state, steps); ``fill`` writes
    the initial values at every row a lane does not run (the full form)."""
    words, lanes, rows, tabs, first, T = engine_inputs(
        words, bit_pos, bit_end, out_pos, active, table_id, litlen,
        litlen_sec, dist, dist_sec, bit_stop, chain, stream_row,
        litlen_first)
    dev = words.device
    L = rows.numel()
    if dev.type == "cpu":
        records, state = decode_symbols_plain(words, *lanes, rows, *tabs,
                                              first, max_steps, chain)
        return records, state, (records[5] >= 0).sum(0, dtype=torch.int32)
    _build.require_cuda(words, *lanes, rows, *tabs)
    i32 = torch.int32
    rl = torch.empty((max_steps, L), dtype=i32, device=dev)
    rlh, rn, rd, rp = (torch.empty_like(rl) for _ in range(4))
    rc = torch.empty((max_steps, L), dtype=torch.int8, device=dev)
    steps, bpos, opos = (torch.empty(L, dtype=i32, device=dev)
                         for _ in range(3))
    status = torch.empty(L, dtype=torch.int8, device=dev)
    records, state = (rl, rlh, rc, rn, rd, rp), (bpos, opos, status)
    if L == 0:
        return records, state, steps
    bp, be, op, act, tid, stop = lanes
    _build.launch(
        "decode_symbols", dev, words.data_ptr(), words.shape[0],
        words.shape[1], rows.data_ptr(), bp.data_ptr(), be.data_ptr(),
        op.data_ptr(), act.data_ptr(), tid.data_ptr(), stop.data_ptr(),
        tabs[0].data_ptr(), tabs[1].data_ptr(), tabs[1].shape[1],
        tabs[2].data_ptr(), tabs[3].data_ptr(), tabs[3].shape[1],
        None if first is None else first.data_ptr(), T, chain, L,
        max_steps, int(fill), *(x.data_ptr() for x in records),
        steps.data_ptr(), bpos.data_ptr(), opos.data_ptr(), status.data_ptr())
    return records, state, steps


def _shr(x, s):
    """u32 ``x >> s`` for a shift taken as u32: 0 for s >= 32 (or < 0)."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, x >> s.clamp(0, 31), 0)


def _shl(x, s):
    """u32 ``x << s``, 0 for s >= 32 (or < 0)."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, (x << s.clamp(0, 31)) & _M32, 0)


def _as_i32(x):
    """int64 ``x`` read as the int32 of its low 32 bits."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _len_sym(li):
    """Base and extra bits of length symbol 257 + li (JAX :196)."""
    extra = torch.where(li < 8, 0, torch.clamp((li - 4) >> 2, max=5))
    extra = torch.where(li >= 28, 0, extra)
    base = torch.where(li < 8, li + 3,
                       ((4 + (li & 3)) << torch.clamp((li - 4) >> 2, min=0)) + 3)
    return torch.where(li >= 28, 258, base), extra


def _dist_sym(s):
    """Base and extra bits of distance symbol s (JAX :207)."""
    extra = torch.clamp(torch.div(s, 2, rounding_mode="floor") - 1, min=0)
    base = torch.where(s < 2, s + 1, ((2 + (s & 1)) << extra) + 1)
    return base, extra


def decode_symbols_plain(words, bit_pos, bit_end, out_pos, active, table_id,
                         bit_stop, rows, litlen, litlen_sec, dist, dist_sec,
                         litlen_first, max_steps: int, chain: int):
    """Plain PyTorch ``decode_symbols``: the JAX loop body over all lanes,
    step by step, until no lane runs or ``max_steps``.  Values are held in
    int64 (u32 patterns masked to 32 bits); arguments as ``decode_symbols``
    passes them (int32 lane vectors, ``active`` as int32)."""
    dev = words.device
    i64 = torch.int64
    L = bit_pos.numel()
    W = words.shape[1]
    wflat = words.reshape(-1).to(i64) & _M32
    row_base = rows.to(i64).clamp(0, words.shape[0] - 1) * W
    tid = table_id.to(i64).clamp(0, litlen.shape[0] - 1)
    ll = litlen.reshape(-1).to(i64) & _M32
    ls = litlen_sec.to(i64) & _M32
    dd = dist.reshape(-1).to(i64) & _M32
    ds = dist_sec.to(i64) & _M32
    fl_t = None if litlen_first is None else litlen_first.reshape(-1).to(i64)
    S, S2 = ls.shape[1], ds.shape[1]
    ls, ds = ls.reshape(-1), ds.reshape(-1)
    has_first = fl_t is not None

    def load(widx):
        return wflat[row_base + widx.clamp(0, W - 1)]

    def lit_lookup(idx):
        k = tid * DEFAULT_LITLEN_TABLE_SIZE + idx
        return ll[k], (fl_t[k] if has_first else None)

    bpos = bit_pos.to(i64)
    opos = out_pos.to(i64)
    end = bit_end.to(i64)
    stop = bit_stop.to(i64)
    status = torch.where(active != 0, OK, EOB).to(i64)
    base = bpos >> 5
    w0, w1, w2 = load(base), load(base + 1), load(base + 2)

    rec = [torch.zeros((max_steps, L), dtype=i64, device=dev)
           for _ in range(5)]
    rp = torch.full((max_steps, L), -1, dtype=i64, device=dev)

    def peek(off):
        o = (bpos - (base << 5)) + off
        sel = o >= 32
        a = torch.where(sel, w1, w0)
        b = torch.where(sel, w2, w1)
        oo = o & 31
        return (a >> oo) | torch.where(oo == 0, 0, (b << (32 - oo)) & _M32)

    def place(lo, hi, lit, byte_off, mask):
        sh = 8 * byte_off
        sh_a = sh.clamp(max=31)
        sh_b = (sh - 32).clamp(0, 31)
        lo_c = torch.where(sh < 32, (lit << sh_a) & _M32, 0)
        hi_c = torch.where(sh < 32, (lit >> 1) >> (31 - sh_a),
                           (lit << sh_b) & _M32)
        return (torch.where(mask, lo | lo_c, lo),
                torch.where(mask, hi | hi_c, hi))

    def chain_level(idx_bits, chained, lo, hi, count, nbits):
        e_n, fl_n = lit_lookup(idx_bits & 4095)
        ok_n = chained & ((e_n & 0x8000) != 0) & (bpos + nbits < stop)
        bits_n = e_n & 0xFF
        cnt_n = (e_n >> 8) & 0xF
        lit_n = (e_n >> 16) & 0xFFFF
        if has_first:
            cross_n = ok_n & (bpos + nbits + bits_n > stop)
            bits_n = torch.where(cross_n, fl_n, bits_n)
            cnt_n = torch.where(cross_n, 1, cnt_n)
            lit_n = torch.where(cross_n, lit_n & 0xFF, lit_n)
        else:
            cross_n = torch.zeros_like(ok_n)
        lo, hi = place(lo, hi, lit_n, count, ok_n)
        count = torch.where(ok_n, count + cnt_n, count)
        nbits = torch.where(ok_n, nbits + bits_n, nbits)
        return ok_n & ~cross_n, lo, hi, count, nbits

    zero = torch.zeros(L, dtype=i64, device=dev)
    i = 0
    while i < max_steps and bool((status == OK).any()):
        running = status == OK
        ubits = peek(0)
        e, fl = lit_lookup(ubits & 4095)
        ecode_bits = e & 0xFF
        is_lit = (e & 0x8000) != 0
        cnt1 = (e >> 8) & 0xF
        lit1 = (e >> 16) & 0xFFFF
        if has_first:
            cross = is_lit & (bpos + ecode_bits > stop)
            ecode_bits = torch.where(cross, fl, ecode_bits)
            cnt1 = torch.where(cross, 1, cnt1)
            lit1 = torch.where(cross, lit1 & 0xFF, lit1)
        lit_lo, lit_hi = place(zero, zero, lit1, zero, is_lit)
        lit_count = torch.where(is_lit, cnt1, 0)
        lit_bits = torch.where(is_lit, ecode_bits, 0)
        chained = is_lit & ~cross if has_first else is_lit
        if chain >= 2:
            chained, lit_lo, lit_hi, lit_count, lit_bits = chain_level(
                _shr(ubits, ecode_bits), chained, lit_lo, lit_hi, lit_count,
                lit_bits)
        if chain >= 4:
            before3 = lit_bits
            bits3 = peek(lit_bits)
            chained, lit_lo, lit_hi, lit_count, lit_bits = chain_level(
                bits3, chained, lit_lo, lit_hi, lit_count, lit_bits)
            chained, lit_lo, lit_hi, lit_count, lit_bits = chain_level(
                _shr(bits3, lit_bits - before3), chained, lit_lo, lit_hi,
                lit_count, lit_bits)

        # Non-literal: secondary table, length entry, EOF or invalid.
        exceptional = (e & 0x4000) != 0
        has_sec = (e & 0x2000) != 0
        sec_idx = (e >> 16) + ((ubits >> 12) & (e & 0xFF))
        se = ls[tid * S + sec_idx.clamp(0, S - 1)]
        se = _as_i32(se)
        sec_sym = se >> 4
        sec_bits = se & 0xF
        sec_is_lit = has_sec & (sec_sym < 256)
        sec_is_eof = has_sec & (sec_sym == 256)
        sec_is_len = has_sec & (sec_sym > 256)
        plain_len = ~is_lit & ~exceptional
        plain_eof = ~is_lit & exceptional & ~has_sec & (ecode_bits != 0)
        invalid_ll = ~is_lit & exceptional & ~has_sec & (ecode_bits == 0)

        lb_f, le_f = _len_sym((sec_sym - 257).clamp(0, 30))
        length_base = torch.where(plain_len, e >> 16, lb_f)
        length_extra = torch.where(plain_len, (e >> 8) & 0xFF, le_f)
        ll_bits = torch.where(plain_len, ecode_bits, sec_bits)
        is_len = plain_len | sec_is_len
        rem = _shr(ubits, ll_bits)
        length = _as_i32(length_base + _as_i32(
            rem & ((_shl(torch.ones_like(rem), length_extra) - 1) & _M32)))

        dbits = peek(ll_bits + length_extra)
        de = dd[tid * DEFAULT_DIST_TABLE_SIZE + (dbits & 511)]
        d_prim = (de & 0x8000) != 0
        d_sec_idx = (de >> 16) + ((dbits >> 9) & (de & 0xFF))
        dse = ds[tid * S2 + d_sec_idx.clamp(0, S2 - 1)]
        dse = _as_i32(dse)
        d_sec_sym = dse >> 4
        d_invalid = ~d_prim & (((de >> 8) == 0) | (d_sec_sym >= 30))
        db_f, de_f = _dist_sym(d_sec_sym.clamp(0, 29))
        dist_base = torch.where(d_prim, de >> 16, db_f)
        dist_extra = torch.where(d_prim, (de >> 8) & 0xF, de_f)
        d_code_bits = torch.where(d_prim, de & 0xFF, dse & 0xF)
        drem = _shr(dbits, d_code_bits)
        distance = _as_i32(dist_base + _as_i32(
            drem & ((_shl(torch.ones_like(drem), dist_extra) - 1) & _M32)))

        consumed = torch.where(
            is_lit, lit_bits,
            torch.where(sec_is_lit | sec_is_eof, sec_bits,
                        torch.where(plain_eof, ecode_bits,
                                    ll_bits + length_extra + d_code_bits
                                    + dist_extra)))
        truncated = running & (bpos + consumed > end)
        is_eof = plain_eof | sec_is_eof
        too_far = is_len & (distance > opos)
        err = torch.where(invalid_ll, ERR_LITLEN,
                          torch.where(is_len & d_invalid, ERR_DIST,
                                      torch.where(is_len & too_far,
                                                  ERR_TOO_FAR, OK)))
        err = torch.where(truncated, ERR_TRUNC, err)
        commit = running & ~truncated & (err == OK) & ~is_eof

        out_lit = torch.where(commit & is_lit, lit_lo, 0)
        out_hi = torch.where(commit & is_lit, lit_hi, 0)
        out_lit = torch.where(commit & sec_is_lit, sec_sym & _M32, out_lit)
        out_cnt = torch.where(commit, torch.where(is_lit, lit_count,
                                                  sec_is_lit.to(i64)), 0)
        out_cnt = ((out_cnt + 128) & 0xFF) - 128          # as int8
        out_len = torch.where(commit & is_len, length, 0)
        out_dst = torch.where(commit & is_len, distance, 0)
        for r, v in zip(rec, (out_lit, out_hi, out_cnt, out_len, out_dst)):
            r[i] = v
        rp[i] = torch.where(running, bpos, -1)

        new_bpos = torch.where(commit | (running & is_eof & ~truncated),
                               _as_i32(bpos + consumed), bpos)
        opos = _as_i32(opos + out_cnt + out_len)
        status = torch.where(
            running,
            torch.where(truncated | (err != OK), err,
                        torch.where(is_eof, EOB,
                                    torch.where(new_bpos >= stop, STOPPED,
                                                OK))),
            status)
        bpos = new_bpos
        for _ in range(2):
            need = (bpos >> 5) > base
            w0 = torch.where(need, w1, w0)
            w1 = torch.where(need, w2, w1)
            base = torch.where(need, base + 1, base)
            w2 = torch.where(need, load(base + 2), w2)
        i += 1

    i32 = torch.int32
    rl, rlh, rc, rn, rd = rec
    return ((rl.to(i32), rlh.to(i32), rc.to(torch.int8), rn.to(i32),
             rd.to(i32), rp.to(i32)),
            (bpos.to(i32), opos.to(i32), status.to(torch.int8)))
