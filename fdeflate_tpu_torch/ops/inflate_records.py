"""K4 inflate_records: foreign deflate blocks -> records, one block per lane.

JAX counterparts: the TPU kernel ``fdeflate_tpu/ops/pallas_inflate.py``
``_kernel`` (via ``decode_records_blocked``) with its numpy oracle
``decode_records_np`` and ``recs_to_records``.  The CUDA kernel is
``csrc/inflate_records.cu``; ``inflate_records_plain`` is its plain
version, one decode step of every live lane per iteration.

A lane decodes one block from absolute bit ``start`` of the flat stream
words; words at or past its ``wend`` read as 0.  Its trees are the
``(meta i32[64], tab i32[160])`` rows of ``foreign_meta`` (the port's
copy of ``pallas_inflate.foreign_meta``, ``ops/inflate_host.py``)
(``pack_tables`` stacks them, one row per lane).  A record is at most two
literals, a match, EOB or an error (``REC_*``); records are step-major,
``recs[u, lane]``, zero past a lane's last record.

Exit codes (``done``): 0 ran out of the K record slots, 1 EOB, 2 invalid
literal/length code, 3 invalid distance code (``decode_records_np`` says 2
for both), 4 a symbol runs past the lane's ``bit_end``, 5 a distance
exceeds ``out0`` plus the bytes the lane has produced.  With ``bit_end``
and ``out0`` at ``NO_LIMIT`` codes 4 and 5 never occur and records,
``bpos`` and ``done`` (3 read as 2) are ``decode_records_np``'s.  On an
error the lane stops before the failing symbol with an error record;
truncation wins over an invalid code, which wins over a distance too far,
as in ``ops/inflate.decode_symbols``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .inflate_host import REC_ERR, REC_LITS, REC_MATCH, foreign_meta

NO_LIMIT = 1 << 62          # bit_end / out0 that never stops a lane
DONE_SLOTS, DONE_EOB, DONE_BAD_LITLEN, DONE_BAD_DIST = 0, 1, 2, 3
DONE_TRUNCATED, DONE_TOO_FAR = 4, 5
META_ROWS, TAB_PAIRS = 64, 160
_MASK32 = 0xFFFFFFFF


def block_tables(lengths, hlit: int):
    """A dynamic block's (meta, tab) from its parsed code lengths
    (``inflate._parse_dynamic_lengths``: litlen at [0:hlit], distance at
    [288:320]); raises ValueError for an incomplete literal/length code."""
    return foreign_meta(lengths[:hlit], lengths[288:320])


def pack_tables(meta_tabs, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Stack per-lane ``foreign_meta`` results: (meta int32[L, 64], tab
    int32[L, 160]) on ``device``."""
    L = len(meta_tabs)
    meta = np.zeros((L, META_ROWS), np.int32)
    tab = np.zeros((L, TAB_PAIRS), np.int32)
    for i, (m, t) in enumerate(meta_tabs):
        meta[i] = m
        tab[i] = t
    return torch.from_numpy(meta).to(device), torch.from_numpy(tab).to(device)


def lanes_from_blocked(a):
    """JAX's lane-blocked ``[LB, rows, 8, 128]`` layout -> the port's
    ``[L, rows]`` (L = LB * 1024, lane ``(lb * 8 + s) * 128 + l``), so both
    packages get the same tables: a tensor for a tensor (on its device),
    else a numpy array."""
    if isinstance(a, torch.Tensor):
        LB, rows = a.shape[:2]
        return a.permute(0, 2, 3, 1).reshape(LB * 1024, rows).contiguous()
    a = np.asarray(a)
    LB, rows = a.shape[:2]
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1).reshape(LB * 1024, rows))


@functools.lru_cache(maxsize=4)
def _rev15(device: str) -> torch.Tensor:
    x = torch.arange(1 << 15, dtype=torch.int64)
    r = torch.zeros_like(x)
    for i in range(15):
        r |= ((x >> i) & 1) << (14 - i)
    return r.to(device)


def canon_table(meta, tab, brow: int) -> torch.Tensor:
    """The canonical decode of every 15-bit peek for each lane's tree at
    meta row ``brow`` (0 litlen, 32 dist): int64[L, 32768] holding
    ``code length << 16 | table entry`` (K4's compare chain, tabulated)."""
    dev = meta.device
    meta = meta.to(torch.int64)
    r15 = _rev15(str(dev))[None, :]
    L = torch.ones(meta.shape[0], 1 << 15, dtype=torch.int64, device=dev)
    for l in range(1, 15):
        L += r15 >= meta[:, brow + l, None]
    idx = meta[:, brow + 16:brow + 32].gather(1, L) + (r15 >> (15 - L))
    idx = idx.clamp(0, 2 * TAB_PAIRS - 1)
    e = (tab.to(torch.int64).gather(1, idx >> 1) >> ((idx & 1) * 16)) & 0x7FFF
    return (L << 16) | e


def inflate_records_plain(words, start, wend, bit_end, out0, meta, tab,
                          K: int):
    """Plain PyTorch K4: one record of every live lane per iteration.

    Returns (recs int32[K, L], bpos int64[L], nout int64[L], done int32[L]);
    ``nout`` counts the bytes of the lane's records.
    """
    dev = words.device
    L = start.numel()
    W = words.numel()
    w = torch.cat([words.reshape(-1).to(torch.int64) & _MASK32,
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    wend = torch.clamp(wend.to(torch.int64), max=W)[None, :]
    # one table per distinct tree (lanes of a batch often share one)
    trees, tree_of = torch.unique(
        torch.cat([meta.to(torch.int64), tab.to(torch.int64)], dim=1),
        dim=0, return_inverse=True)
    tm, tt = trees[:, :META_ROWS], trees[:, META_ROWS:]
    lit_t, dist_t = canon_table(tm, tt, 0), canon_table(tm, tt, 32)
    two_words = torch.arange(2, device=dev)[:, None]

    def peek32(p):
        i = (p >> 5)[None, :] + two_words
        v = w[torch.where(i < wend, i, W)]
        return ((v[0] | (v[1] << 32)) >> (p & 31)) & _MASK32

    def canon(t, bits):
        x = t[tree_of, bits & 0x7FFF]
        return x >> 16, x & 0xFFFF

    pos = start.to(torch.int64).clone()
    bit_end = bit_end.to(torch.int64)
    out0 = out0.to(torch.int64)
    nout = torch.zeros(L, dtype=torch.int64, device=dev)
    done = torch.zeros(L, dtype=torch.int32, device=dev)
    live = torch.ones(L, dtype=torch.bool, device=dev)
    recs = torch.zeros(K, L, dtype=torch.int32, device=dev)
    for u in range(K):
        if not bool(live.any()):
            break
        bits = peek32(pos)
        L1, e1 = canon(lit_t, bits)
        cls1 = e1 >> 13
        is_lit, is_len = cls1 == 0, cls1 == 2
        rest = bits >> L1
        # literal lanes: a second literal from the same 32-bit peek
        L2, e2 = canon(lit_t, rest)
        two = is_lit & ((e2 >> 13) == 0)
        # match lanes: length extra bits, then the distance code
        ext1 = (e1 >> 9) & 0xF
        run = (e1 & 0x1FF) + (rest & ((1 << ext1) - 1))
        dbits = peek32(pos + L1 + ext1)
        Ld, ed = canon(dist_t, dbits)
        s = ed & 0x1FF
        bad_d = is_len & (s == 0x1FF)
        dext = ((s >> 1) - 1).clamp(min=0)
        dist = torch.where(s < 2, s + 1, ((2 + (s & 1)) << dext) + 1) + (
            (dbits >> Ld) & ((1 << dext) - 1))

        used = L1 + torch.where(two, L2, 0) + torch.where(
            is_len, ext1 + torch.where(bad_d, 0, Ld + dext), 0)
        lit_rec = ((REC_LITS << 28) | ((1 + two.to(torch.int64)) << 16)
                   | (torch.where(two, e2 & 0xFF, 0) << 8) | (e1 & 0x1FF))
        rec = torch.where(is_lit, lit_rec, torch.where(
            is_len, (REC_MATCH << 28) | ((run - 3) << 15) | (dist - 1),
            3 << 28))
        adv = torch.where(is_lit, 1 + two.to(torch.int64),
                          torch.where(is_len, run, 0))
        err = torch.where(cls1 == 3, DONE_BAD_LITLEN, torch.where(
            bad_d, DONE_BAD_DIST, torch.where(
                is_len & (dist > out0 + nout), DONE_TOO_FAR, -1)))
        err = torch.where(pos + used > bit_end, DONE_TRUNCATED, err)
        is_err = live & (err >= 0)
        ok = live & ~is_err
        recs[u] = torch.where(is_err, REC_ERR << 28,
                              torch.where(ok, rec, 0)).to(torch.int32)
        pos = torch.where(ok, pos + used, pos)
        nout = torch.where(ok, nout + adv, nout)
        is_eob = cls1 == 1
        done = torch.where(is_err, err, torch.where(
            ok & is_eob, DONE_EOB, done)).to(torch.int32)
        live = ok & ~is_eob
    return recs, pos, nout, done


def inflate_records(words, start, wend, bit_end, out0, meta, tab, K: int,
                    stats=None):
    """K4 on ``words``' device.

    ``words`` int32[W] flat stream words (u32 bit patterns); per lane
    ``start``, ``wend``, ``bit_end``, ``out0`` int64[L] and ``meta``
    int32[L, 64], ``tab`` int32[L, 160].  Returns (recs int32[K, L], bpos
    int64[L], nout int64[L], done int32[L]).  CPU tensors take
    ``inflate_records_plain``; CUDA tensors launch ``csrc/inflate_records.cu``
    (a warp per lane; lanes in offset order decode fastest, the next lane's
    start hinting where a block ends).  ``stats``: None, or a zeroed int64[4]
    on the card that the kernel fills with its spans' counts (most sync
    rounds of a span, spans, spans another span continues, sync rounds).
    """
    L = start.numel()
    if (meta.shape != (L, META_ROWS) or tab.shape != (L, TAB_PAIRS)
            or any(x.numel() != L for x in (wend, bit_end, out0))):
        raise ValueError("inflate_records needs start/wend/bit_end/out0[L], "
                         "meta[L, 64] and tab[L, 160]")
    if words.device.type == "cpu":
        return inflate_records_plain(words, start, wend, bit_end, out0,
                                     meta, tab, K)
    _build.require_cuda(words, start, wend, bit_end, out0, meta, tab)
    dev = words.device
    i64, i32 = torch.int64, torch.int32
    words = words.reshape(-1).to(i32).contiguous()
    lane_in = [x.reshape(-1).to(i64).contiguous()
               for x in (start, wend, bit_end, out0)]
    lane_in[1] = lane_in[1].clamp(max=words.numel())
    meta = meta.to(i32).contiguous()
    tab = tab.to(i32).contiguous()
    recs = torch.zeros(K, L, dtype=i32, device=dev)
    bpos = torch.empty(L, dtype=i64, device=dev)
    nout = torch.empty(L, dtype=i64, device=dev)
    done = torch.empty(L, dtype=i32, device=dev)
    if L == 0:
        return recs, bpos, nout, done
    if stats is not None and (stats.shape != (4,) or stats.dtype != i64
                              or stats.device != dev):
        raise ValueError("inflate_records: stats must be int64[4] on the "
                         "words' device")
    _build.launch(
        "inflate_records", dev, words.data_ptr(),
        *(x.data_ptr() for x in lane_in), meta.data_ptr(), tab.data_ptr(),
        recs.data_ptr(), bpos.data_ptr(), nout.data_ptr(), done.data_ptr(),
        None if stats is None else stats.data_ptr(), L, K)
    return recs, bpos, nout, done


def recs_to_records(recs: torch.Tensor):
    """Kernel records [K, L] -> materialize's (lit, cnt, len, dist), each
    int32[K, L] (``pallas_inflate.recs_to_records`` without its lit_hi,
    which is zero for records of at most two literals)."""
    recs = recs.to(torch.int32)
    kind = (recs >> 28) & 0xF
    pay = recs & 0x0FFFFFFF
    is_l = kind == REC_LITS
    is_m = kind == REC_MATCH
    zero = torch.zeros_like(recs)
    rl = torch.where(is_l, pay & 0xFFFF, zero)
    rc = torch.where(is_l, (pay >> 16) & 3, zero)
    rn = torch.where(is_m, ((pay >> 15) & 0xFF) + 3, zero)
    rd = torch.where(is_m, (pay & 0x7FFF) + 1, zero)
    return rl, rc, rn, rd
