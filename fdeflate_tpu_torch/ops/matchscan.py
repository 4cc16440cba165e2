"""The device match finder and its matched zlib encoder (general levels 1-3).

JAX counterpart: ``fdeflate_tpu/ops/matchscan.py``.  It has no Pallas
kernel: XLA sorts, scans, gathers and scatters on the TPU, as plain
PyTorch does here on the card.  Every function below carries the JAX
function's name and arguments and returns its arrays bit for bit
(tests/test_torch_matchscan.py, tests/test_torch_matched.py).

    stage 1    (device) hash sort -> k-predecessor probe (``find_matches``,
               4- and 8-byte hashes) -> winner extension -> one-step
               deferral -> greedy tiling by pointer doubling -> merged
               same-distance chains -> roles, symbol frequencies and the
               byte histogram
    host       first-pass trees and shadow literal costs
    stage 1.5  (device, ``passes`` times) segment demotion -> roles and
               frequencies; host code lengths after each pass
    host       the dynamic header per stream (RFC 1951 16/17/18 run codes)
    stage 2    (device) per-byte codes -> prefix-sum bit positions ->
               pair-combined word scatter
    K7         Adler-32 of each stream (``ops/adler32.adler32_batch``: one
               launch over the batch on the card)
    read-back  each stream's used words, ``ceil(total_bits / 32)``

JAX's arithmetic, not its dtypes: the hash multiplies in int64 masked to
32 bits; the sort key keeps JAX's signed int32 value (one flat int64 sort
of ``row << 32 | key + 2^31`` gives each row's order); int32 wraps are
made explicit; the word scatter sums in int64 masked to 32 bits (its
pieces never share a bit, so that is JAX's wrapped sum); the logical
shifts of uint32 are done on non-negative int64.  A JAX scatter drops
indices out of range, where torch raises: the port scatters only the
entries that JAX's result depends on, at JAX's indices.  Scans along rows
run by doubling (log2 N passes of an elementwise max or min on shifted
copies) or as one flat cumsum (``ultrafast.row_cumsum``): PyTorch's scans
along a few long rows run one block per row on the card.  The row
entropy of ``stream_lit_bits8`` is JAX's float32 formula.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..huffman import build_huffman_tree
from ..tables import (
    CLCL_ORDER,
    DIST_SYM_TO_DIST_BASE,
    DIST_SYM_TO_DIST_EXTRA,
    DISTANCE_TO_SYM,
    LENGTH_TO_LEN_EXTRA,
    LENGTH_TO_SYMBOL,
)
from .adler32 import adler32_batch
from .bitio import BitWriter
from .ultrafast import device_of, row_cumsum

_EXT = 32          # capped per-candidate extension (merging recovers runs)
_WINDOW = 32768
_HW = 48           # header words: up to 1536 header bits

I32, I64 = torch.int32, torch.int64
_M32 = 0xFFFFFFFF


class _Tables(NamedTuple):
    lsym: torch.Tensor      # length - 3 -> length symbol
    lext: torch.Tensor      # length - 3 -> length extra bits
    dsym: torch.Tensor      # distance - 1 -> distance symbol
    dbase: torch.Tensor     # distance symbol -> base distance
    dext: torch.Tensor      # distance symbol -> extra bits
    dext_of: torch.Tensor   # distance - 1 -> extra bits (int32)


@functools.lru_cache(maxsize=8)
def _tables(device: str) -> _Tables:
    def t(a, dtype=I64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return _Tables(t(LENGTH_TO_SYMBOL), t(LENGTH_TO_LEN_EXTRA),
                   t(DISTANCE_TO_SYM), t(DIST_SYM_TO_DIST_BASE),
                   t(DIST_SYM_TO_DIST_EXTRA),
                   t(DIST_SYM_TO_DIST_EXTRA[DISTANCE_TO_SYM], I32))


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """The int32 whose bits are the low 32 bits of int64 ``x``."""
    x = x & _M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def _cols(N: int, dev, dtype=I64) -> torch.Tensor:
    return torch.arange(N, device=dev, dtype=dtype)[None, :]


def _rows(B: int, dev, dtype=I64) -> torch.Tensor:
    return torch.arange(B, device=dev, dtype=dtype)[:, None]


def _shl(x: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    """x[:, i + k], ``fill`` past the row's end."""
    out = torch.full_like(x, fill)
    if k < x.shape[1]:
        out[:, : x.shape[1] - k] = x[:, k:]
    return out


def _shr(x: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    """x[:, i - k], ``fill`` before the row's start."""
    out = torch.full_like(x, fill)
    if k < x.shape[1]:
        out[:, k:] = x[:, : x.shape[1] - k]
    return out


def _row_scan(x: torch.Tensor, op, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``op`` (torch.maximum / torch.minimum) along each
    row, from the row's end when ``reverse``: ceil(log2 n) doubling passes."""
    n = x.shape[1]
    s = 1
    while s < n:
        y = x.clone()
        if reverse:
            y[:, :-s] = op(x[:, :-s], x[:, s:])
        else:
            y[:, s:] = op(x[:, s:], x[:, :-s])
        x = y
        s *= 2
    return x


def _words(data: torch.Tensor) -> torch.Tensor:
    """int32[B, N]: the unaligned little-endian 4-byte word at every byte
    offset (zeros past the row's end), JAX's int32 values."""
    d = data.to(I64)
    w = d.clone()
    for k in (1, 2, 3):
        w |= _shl(d, k) << (8 * k)
    return _as_i32(w)


def _tz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Zero bytes at the low end of each u32 ``x`` (4 for 0): JAX's nested
    selects on ``x & 0xFF``, ``0xFF00``, ``0xFF0000``, as a count."""
    return (((x & 0xFF) == 0).to(x.dtype) + ((x & 0xFFFF) == 0)
            + ((x & 0xFFFFFF) == 0) + (x == 0))


def _lz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Zero bytes at the high end of each u32 ``x`` held in int32 (4 for
    0), as a count."""
    return (((x & -16777216) == 0).to(x.dtype) + ((x & -65536) == 0)
            + ((x & -256) == 0) + (x == 0))


def _hash12(w32: torch.Tensor) -> torch.Tensor:
    """JAX ``_hash12``: (u32(w) * 0x9E3779B1 mod 2^32) >> 20, from int64
    values in int32 range (the product stays inside int64)."""
    return ((w32.to(I64) * 0x9E3779B1) & _M32) >> 20


def find_matches(data, lengths, depth: int = 2, min_match: int = 4,
                 hash_bytes: int = 4, cost_filter: bool = True,
                 backext: bool = True, lit_bits8=None):
    """Per-position verified match (length, distance), capped at _EXT bytes.

    data: u8[B, N] (N <= 2^20); lengths: int[B].  Returns (mlen int32[B, N],
    mdist int32[B, N]), zero length where there is no match: JAX's
    sorted-neighbourhood probe (a position's candidates are its ``depth``
    predecessors in the hash-sorted order), verified word extension,
    cost filter, backward extension and score-max scatter.  The words at
    each sorted position and ``j`` bytes on are gathered once; candidate
    k's words are the same tensors shifted by k (its first k positions
    have no candidate), and its extension counts equal words before it
    counts the bytes of the first unequal one.
    """
    B, N = data.shape
    if N > 1 << 20:
        raise ValueError("find_matches takes rows of at most 2^20 bytes")
    dev = data.device
    T = _tables(str(dev))
    lengths = lengths.to(I32)[:, None]
    if lit_bits8 is None:
        lit8 = torch.full((B, 1), 40, dtype=I32, device=dev)
    else:
        lit8 = lit_bits8.to(I32).reshape(B, 1)
    W = _words(data)
    idx = _cols(N, dev)
    valid = idx + min_match <= lengths
    if hash_bytes == 8:
        hsrc = W.to(I64) ^ (_shl(W, 4).to(I64) * 0x01000193)
        hsrc = _as_i32(hsrc)
    else:
        hsrc = W
    key = (_hash12(hsrc) << 20) | idx
    key = torch.where(key >= 1 << 31, key - (1 << 32), key)   # JAX's int32
    key = torch.where(valid, key, (1 << 31) - 1 - (N - idx))
    flat = (_rows(B, dev) << 32) + (key + (1 << 31))
    s = (flat.reshape(-1).sort().values & _M32).reshape(B, N) - (1 << 31)
    spos = (s & ((1 << 20) - 1)).to(I32)
    shash = (s >> 20).to(I32)
    del key, flat, s

    # Words at sorted position p + j (j = 0, 4, .. 28) and at p - 4, p - 8,
    # clamped into the row as JAX's gathers are (entries whose index needs
    # the clamp have no match).
    p64 = spos.to(I64)
    A = [W.gather(1, (p64 + j).clamp_(max=N - 1)) for j in range(0, _EXT, 4)]
    back = {off: W.gather(1, (p64 - off).clamp_(0, N - 1)) for off in (4, 8)}
    del p64
    litb = (lit8 >> 3).clamp(2, 12)
    rowbase = _rows(B, dev) * N
    slot = rowbase + _cols(N, dev)                 # sorted index i's own slot
    best_len = torch.zeros(B, N, dtype=I32, device=dev)
    best_dist = torch.zeros_like(best_len)
    best_score = torch.zeros_like(best_len)
    for k in range(1, min(depth, N - 1) + 1):
        pos, cand = spos[:, k:], spos[:, :-k]
        dist = pos - cand
        ok = (shash[:, k:] == shash[:, :-k]) & (dist > 0) & (dist <= _WINDOW)
        # JAX adds 4 per equal word while all before it were equal, then
        # the first differing word's equal low bytes: count the equal
        # words, keep the first differing one (0 if none), then its bytes.
        words_eq = torch.zeros_like(pos)
        first = torch.zeros_like(pos)
        alive = ok
        for a in A:
            x = a[:, k:] ^ a[:, :-k]
            first = torch.where(alive, x, first)
            alive = alive & (x == 0)
            words_eq += alive
        ln = 4 * words_eq + torch.where(first != 0, _tz_bytes(first), 0)
        ln = torch.minimum(ln, lengths - pos)
        ln = torch.where(ok & (ln >= min_match), ln, 0)
        dext = T.dext_of[(dist - 1).clamp(0, _WINDOW - 1).to(I64)]
        if cost_filter:
            ln = torch.where((13 + dext) * 8 <= lit8 * ln, ln, 0)
        if backext:
            b4, b8 = back[4], back[8]
            b1 = torch.where((pos >= 4) & (cand >= 4),
                             _lz_bytes(b4[:, k:] ^ b4[:, :-k]), 0)
            b2 = torch.where((b1 == 4) & (pos >= 8) & (cand >= 8),
                             _lz_bytes(b8[:, k:] ^ b8[:, :-k]), 0)
            bext = torch.where(ln > 0, b1 + b2, 0)
        else:
            bext = torch.zeros_like(ln)

        # Keep the best-scoring candidate per position: (score << 21 |
        # len << 15 | WINDOW - dist), a scatter-max.  Entries without a
        # match carry 0 and go to their own sorted slot (a no-op).
        def packed_for(length):
            sc = (litb * length - dext).clamp(1, (1 << 10) - 1)
            return (sc << 21) | (length << 15) | (_WINDOW - dist)

        here = slot[:, k:]
        has = ln > 0
        has_b = has & (bext > 0)
        pmax = torch.zeros(B * N, dtype=I32, device=dev)
        pmax.scatter_reduce_(0, torch.where(has, rowbase + pos, here).reshape(-1),
                             torch.where(has, packed_for(ln), 0).reshape(-1),
                             "amax")
        pmax.scatter_reduce_(
            0, torch.where(has_b, rowbase + pos - bext, here).reshape(-1),
            torch.where(has_b, packed_for(ln + bext), 0).reshape(-1), "amax")
        pmax = pmax.reshape(B, N)
        cand_score = pmax >> 21
        better = cand_score > best_score
        best_len = torch.where(better, (pmax >> 15) & 0x3F, best_len)
        best_dist = torch.where(better, _WINDOW - (pmax & 0x7FFF), best_dist)
        best_score = torch.where(better, cand_score, best_score)
    return best_len, best_dist


def _byte_hist(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """int32[B, 256]: each stream's histogram of its first lengths[b] bytes."""
    B, N = data.shape
    dev = data.device
    in_stream = _cols(N, dev) < lengths.to(I64)[:, None]
    key = (_rows(B, dev) * 256 + data.to(I64))[in_stream]
    return torch.bincount(key, minlength=B * 256).reshape(B, 256).to(I32)


def stream_lit_bits8(data, lengths):
    """int32[B]: each stream's order-0 byte entropy in eighths of a bit,
    clipped to [16, 96]: the literal-cost estimate of match scoring
    (float32, JAX's formula)."""
    hist = _byte_hist(data, lengths)
    n = lengths.to(torch.float32).clamp(min=1.0)
    pf = hist.to(torch.float32) / n[:, None]
    H = -torch.where(hist > 0, pf * torch.log2(pf.clamp(min=1e-12)),
                     0.0).sum(dim=1)
    return (H * 8.0 + 0.5).to(I32).clamp(16, 96)


def extend_winners(data, mlen, mdist, lengths, limit: int = 260):
    """Fully extend each position's chosen match up to ``limit`` bytes.

    Matches of at least _EXT bytes (the probe's cap) go on comparing words
    at their current length until a word differs or ``limit`` is reached,
    as JAX's fixed loop does; the port steps only the matches still
    extending (the rest keep their length).
    """
    B, N = mlen.shape
    dev = mlen.device
    Wf = _words(data).reshape(-1)
    out = mlen.to(I32).reshape(-1).clone()
    sel = (out >= _EXT).nonzero().squeeze(1)
    col = sel % N
    base = sel - col
    cand = col - mdist.to(I64).reshape(-1)[sel]
    for _ in range((limit - _EXT) // 4 + 1):
        if sel.numel() == 0:
            break
        ln = out[sel].to(I64)
        x = (Wf[base + (col + ln).clamp(max=N - 1)]
             ^ Wf[base + (cand + ln).clamp(0, N - 1)])
        ln = ln + _tz_bytes(x)
        out[sel] = ln.to(I32)
        more = (x == 0) & (ln < limit)
        sel, col, base, cand = sel[more], col[more], base[more], cand[more]
    idx = _cols(N, dev, I32)
    ln = torch.minimum(out.reshape(B, N).clamp(max=limit),
                       lengths.to(I32)[:, None] - idx)
    return torch.where(mlen > 0, ln, 0), mdist


def greedy_tile(mlen, mdist, lengths, min_match: int = 4):
    """Greedy non-overlapping symbol tiling via pointer doubling.

    Returns (sym_start bool[B, N], is_match bool[B, N]): exactly the set a
    serial greedy walk from position 0 accepts.  ceil(log2 N) rounds: every
    visited position marks its 2^r-jump target, then the jump table
    squares (flat indices, a sentinel column N per row).
    """
    B, N = mlen.shape
    dev = mlen.device
    idx = _cols(N, dev)
    use = mlen >= min_match
    nxt = torch.where(use, idx + mlen.to(I64), idx + 1).clamp(max=N)
    jump = torch.cat([nxt, torch.full((B, 1), N, dtype=I64, device=dev)], 1)
    jump = (jump + _rows(B, dev) * (N + 1)).reshape(-1)
    vis = torch.zeros(B, N + 1, dtype=torch.bool, device=dev)
    vis[:, 0] = True
    vis = vis.reshape(-1)
    for _ in range(math.ceil(math.log2(max(N, 2)))):
        new = vis.clone()
        new[jump[vis]] = True
        vis = new
        jump = jump[jump]
    sym_start = vis.reshape(B, N + 1)[:, :N] & (idx < lengths.to(I64)[:, None])
    return sym_start, sym_start & use


def _next_after(x: torch.Tensor, N: int) -> torch.Tensor:
    """min(N, x[:, i + 1:]) for each i: JAX's reversed exclusive cummin."""
    return _row_scan(_shl(x, 1, N), torch.minimum, reverse=True)


def merge_chains(sym_start, is_match, mdist, lengths):
    """Merge adjacent same-distance accepted matches into long segments.

    Returns (seg_start bool, seg_len int32, seg_dist int32) per byte;
    seg_len only at segment starts.
    """
    B, N = sym_start.shape
    dev = sym_start.device
    idx = _cols(N, dev, I32)
    lens = lengths.to(I32)[:, None]
    mdist = mdist.to(I32)
    nsa = _next_after(torch.where(sym_start, idx, N), N)
    sym_len = torch.where(sym_start, torch.minimum(nsa, lens) - idx, 0)

    # incoming[i] = distance of the accepted match ending at i (matches
    # tile, so at most one): a scatter-max of the matches alone.
    end = (idx + sym_len).clamp(max=N).to(I64)
    incoming = torch.zeros(B * (N + 1), dtype=I32, device=dev)
    incoming.scatter_reduce_(0, (_rows(B, dev) * (N + 1) + end)[is_match],
                             mdist[is_match], "amax")
    incoming = incoming.reshape(B, N + 1)[:, :N]
    continuation = is_match & (incoming == mdist) & (mdist > 0)
    seg_start = is_match & ~continuation
    nba = _next_after(torch.where(sym_start & ~continuation, idx, N), N)
    seg_len = torch.where(seg_start, torch.minimum(nba, lens) - idx, 0)
    return seg_start, seg_len, torch.where(seg_start, mdist, 0)


def _segments(data, lengths, depth: int, min_match: int,
              backext: bool = True):
    """Device: matches -> greedy tiling -> merged segments.

    Two hash passes (4-byte buckets, cost-filtered; 8-byte buckets for the
    long matches), combined per position by estimated net bits; the
    winner extends once; a match is dropped when the next position starts
    a strictly longer one.
    """
    lit8 = stream_lit_bits8(data, lengths)
    mlen, mdist = find_matches(data, lengths, depth=depth,
                               min_match=min_match, backext=backext,
                               lit_bits8=lit8)
    ml8, md8 = find_matches(data, lengths, depth=max(depth // 2, 1),
                            min_match=max(min_match, 8), hash_bytes=8,
                            cost_filter=False, backext=backext,
                            lit_bits8=lit8)
    dext_of = _tables(str(data.device)).dext_of
    litb = (lit8.to(I32) >> 3)[:, None]

    def score(ln, d):
        dext = dext_of[(d - 1).clamp(0, _WINDOW - 1).to(I64)]
        return torch.where(ln > 0, litb * ln - dext, -(1 << 20))

    better = score(ml8, md8) > score(mlen, mdist)
    mlen = torch.where(better, ml8, mlen)
    mdist = torch.where(better, md8, mdist)
    mlen, mdist = extend_winners(data, mlen, mdist, lengths)
    mlen = torch.where(_shl(mlen, 1) > mlen, 0, mlen)
    sym_start, is_match = greedy_tile(mlen, mdist, lengths,
                                      min_match=min_match)
    return merge_chains(sym_start, is_match, mdist, lengths)


def _roles_and_freqs(data, lengths, segments, min_match: int):
    """Per-byte token roles + symbol frequencies from merged segments.

    Returns (roles, freqs): roles = (lit_mask, sub_start, sub_len,
    sub_dist) [B, N] and freqs = (litlen int32[B, 286], dist int32[B, 30]).
    A segment splits into sub-runs of 258 bytes and a tail; a tail shorter
    than ``min_match`` is literals.
    """
    B, N = data.shape
    dev = data.device
    T = _tables(str(dev))
    idx = _cols(N, dev, I32)
    in_stream = idx < lengths.to(I32)[:, None]
    seg_start, seg_len, seg_dist = segments
    seg_len, seg_dist = seg_len.to(I32), seg_dist.to(I32)

    # Propagate segment info to every covered byte.
    sstart = _row_scan(torch.where(seg_start, idx, -1), torch.maximum)
    send = _row_scan(torch.where(seg_start, idx + seg_len, 0), torch.maximum)
    covered = (sstart >= 0) & (idx < send)
    s_clamp = sstart.clamp(min=0)
    s64 = s_clamp.to(I64)
    d = seg_dist.gather(1, s64)
    Lseg = seg_len.gather(1, s64)

    q = idx - s_clamp
    nfull = Lseg // 258
    tail = Lseg - 258 * nfull
    k = q // 258
    r = q - 258 * k
    tail_ok = tail >= min_match
    in_full = covered & (k < nfull)
    in_tail = covered & (k == nfull) & tail_ok & (r < tail)
    tail_lit = covered & ~in_full & ~in_tail
    sub_start = (in_full | in_tail) & (r == 0)
    sub_len = torch.where(sub_start, torch.where(in_full, 258, tail), 0)
    lit_mask = in_stream & (~covered | tail_lit)

    # Frequencies: literals and length symbols, then distance symbols.
    rows = _rows(B, dev)
    lsym = T.lsym[(sub_len - 3).clamp(0, 255).to(I64)]
    keys = torch.cat([(rows * 286 + data.to(I64))[lit_mask],
                      (rows * 286 + lsym)[sub_start]])
    freq_l = torch.bincount(keys, minlength=B * 286).reshape(B, 286).to(I32)
    freq_l[:, 256] += 1  # EOB
    dsym = T.dsym[(d - 1).clamp(0, _WINDOW - 1).to(I64)]
    freq_d = torch.bincount((rows * 30 + dsym)[sub_start],
                            minlength=B * 30).reshape(B, 30).to(I32)
    roles = (lit_mask, sub_start, sub_len, torch.where(sub_start, d, 0))
    return roles, (freq_l, freq_d)


def _stage1(data, lengths, depth: int, min_match: int,
            backext: bool = True):
    """Segments + first-pass roles/freqs + whole-stream byte histogram."""
    segments = _segments(data, lengths, depth, min_match, backext=backext)
    roles, freqs = _roles_and_freqs(data, lengths, segments, min_match)
    return segments, roles, freqs, _byte_hist(data, lengths)


def _demote_segments(data, lengths, segments, shadow_cost, lit_lens,
                     dist_lens, min_match: int):
    """Device stage 1.5: drop merged segments whose literal encoding (at the
    host's shadow literal costs) is cheaper than their matches (at the
    first-pass code lengths), then roles and frequencies again."""
    B, N = data.shape
    dev = data.device
    T = _tables(str(dev))
    seg_start, seg_len, seg_dist = segments
    L, dd = seg_len.to(I64), seg_dist.to(I64)
    idx = _cols(N, dev)
    in_stream = idx < lengths.to(I64)[:, None]
    shadow_cost = shadow_cost.to(I64)
    lit_lens, dist_lens = lit_lens.to(I64), dist_lens.to(I64)

    c = torch.where(in_stream, shadow_cost.gather(1, data.to(I64)), 0)
    prefix = row_cumsum(c)                       # inclusive
    nfull = L // 258
    tail = L - 258 * nfull
    tail_ok = tail >= min_match
    cov_end = idx + 258 * nfull + torch.where(tail_ok, tail, 0)
    # literal bits over [i, cov_end); prefix[i - 1] is prefix[i] - c[i]
    lit_bits = prefix.gather(1, (cov_end - 1).clamp(0, N - 1)) - (prefix - c)

    bits258 = lit_lens[:, int(LENGTH_TO_SYMBOL[255])][:, None]
    t3 = (tail - 3).clamp(0, 255)
    bitsT = lit_lens.gather(1, T.lsym[t3].clamp(0, 285)) + T.lext[t3]
    ds = T.dsym[(dd - 1).clamp(0, _WINDOW - 1)].clamp(0, 29)
    bitsD = dist_lens.gather(1, ds) + T.dext[ds]
    match_bits = nfull * (bits258 + bitsD) + torch.where(tail_ok, bitsT + bitsD, 0)
    keep = ~(seg_start & (lit_bits < match_bits + 3))
    segments2 = (seg_start & keep,
                 torch.where(keep, seg_len.to(I32), 0),
                 torch.where(keep, seg_dist.to(I32), 0))
    roles, freqs = _roles_and_freqs(data, lengths, segments2, min_match)
    return segments2, roles, freqs


def _pack_symbols(data, lengths, roles, lit_codes, lit_lens, dist_codes,
                  dist_lens, header_bits, header_words):
    """Device stage 2: per-byte codes -> bit positions -> word scatter.

    lit_codes/lens: int[B, 286]; dist_codes/lens: int[B, 30];
    header_bits: int[B] (symbols start there); header_words: int[B, HW]
    (the zlib magic and dynamic header, u32 bit patterns).  Returns
    (words int32[B, W] holding JAX's u32 words, total_bits int32[B]).
    Each byte carries at most one code: a literal, or one of a sub-run's
    four slots (length code, length extra, distance code, distance extra)
    on its first four bytes; pairs of bytes combine into one piece of at
    most 30 bits, added into its word and the next.
    """
    B, N = data.shape
    dev = data.device
    T = _tables(str(dev))
    lit_mask, sub_start, sub_len, sub_dist = roles
    lit_codes, lit_lens = lit_codes.to(I64), lit_lens.to(I64)
    dist_codes, dist_lens = dist_codes.to(I64), dist_lens.to(I64)
    header_bits = header_bits.to(I64)
    idx = _cols(N, dev)
    d8 = data.to(I64)

    v = torch.where(lit_mask, lit_codes.gather(1, d8), 0)
    nb = torch.where(lit_mask, lit_lens.gather(1, d8), 0)
    # slot 0: length code
    LL = sub_len.to(I64)
    ls = T.lsym[(LL - 3).clamp(0, 255)].clamp(0, 285)
    v = torch.where(sub_start, lit_codes.gather(1, ls), v)
    nb = torch.where(sub_start, lit_lens.gather(1, ls), nb)
    # slot 1: length extra bits
    s1, LL1 = _shr(sub_start, 1), _shr(LL, 1)
    lext = T.lext[(LL1 - 3).clamp(0, 255)]
    v = torch.where(s1, (LL1 - 3) & ((torch.ones_like(lext) << lext) - 1), v)
    nb = torch.where(s1, lext, nb)
    # slot 2: distance code
    s2, d2 = _shr(sub_start, 2), _shr(sub_dist.to(I64), 2)
    ds = T.dsym[(d2 - 1).clamp(0, _WINDOW - 1)].clamp(0, 29)
    v = torch.where(s2, dist_codes.gather(1, ds), v)
    nb = torch.where(s2, dist_lens.gather(1, ds), nb)
    # slot 3: distance extra bits
    s3, d3 = _shr(sub_start, 3), _shr(sub_dist.to(I64), 3)
    ds3 = T.dsym[(d3 - 1).clamp(0, _WINDOW - 1)].clamp(0, 29)
    v = torch.where(s3, d3 - T.dbase[ds3], v)
    nb = torch.where(s3, T.dext[ds3], nb)

    nb = torch.where(idx < lengths.to(I64)[:, None], nb, 0)
    v = torch.where(nb > 0, v, 0)

    cum = row_cumsum(nb)
    eof_pos = header_bits + cum[:, -1]
    ecode, elen = lit_codes[:, 256], lit_lens[:, 256]
    total_bits = ((eof_pos + elen + 7) // 8) * 8

    n0, n1 = nb[:, 0::2], nb[:, 1::2]
    vp = (v[:, 0::2] | (v[:, 1::2] << n0)) & _M32
    npair = n0 + n1
    positions = header_bits[:, None] + cum[:, 1::2] - npair
    HW = header_words.shape[1]
    W = max((N * 16 + 600) // 32 + 4, HW + 2)
    sh = positions & 31
    lo = (vp << sh) & _M32
    hi = (vp >> 1) >> (31 - sh)
    flat = _rows(B, dev) * W + (positions >> 5)
    # JAX's segment_sum drops ids past B * W (slot B * W is its dump).
    words = torch.zeros(B * W + 2, dtype=I64, device=dev)
    for at, piece in ((flat, lo), (flat + 1, hi)):
        keep = (npair > 0) & (at <= B * W)
        words.index_add_(0, at[keep], piece[keep])
    words = words[: B * W].reshape(B, W)
    words[:, :HW] += header_words.to(I64) & _M32
    # The EOB code, at and after eof_pos; JAX drops a word past W.
    rows = torch.arange(B, device=dev)
    ewi, esh = eof_pos >> 5, eof_pos & 31
    for wi, piece in ((ewi, ecode << esh), (ewi + 1, (ecode >> 1) >> (31 - esh))):
        keep = wi < W
        words[rows[keep], wi[keep]] += piece[keep] & _M32
    return _as_i32(words), total_bits.to(I32)


def _host_header(freq_l: np.ndarray, freq_d: np.ndarray):
    """One stream's dynamic-block header + code tables on the host.

    Returns (header_bits, header_words u32[], lit_lens, lit_codes,
    dist_lens, dist_codes).  Header = zlib magic + BFINAL=1/BTYPE=10 +
    HLIT/HDIST/HCLEN + CL-coded lengths with the RFC 1951 16/17/18 run
    codes.  JAX ``_host_header`` (matchscan.py:705) line for line.
    """
    lengths, codes, _ = build_huffman_tree(freq_l.astype(np.int64), 15)
    dist_lengths, dist_codes, _ = build_huffman_tree(
        freq_d.astype(np.int64), 15
    )
    num_litlen = 286
    while num_litlen > 257 and lengths[num_litlen - 1] == 0:
        num_litlen -= 1
    num_dist = 30
    while num_dist > 1 and dist_lengths[num_dist - 1] == 0:
        num_dist -= 1

    seq = np.concatenate([lengths[:num_litlen], dist_lengths[:num_dist]])
    toks = []  # (cl_symbol, extra_val, extra_bits)
    i = 0
    while i < len(seq):
        v = int(seq[i])
        j = i + 1
        while j < len(seq) and int(seq[j]) == v:
            j += 1
        run = j - i
        if v == 0:
            while run >= 11:
                r = min(run, 138)
                toks.append((18, r - 11, 7))
                run -= r
            if run >= 3:
                toks.append((17, run - 3, 3))
                run = 0
            toks.extend([(0, 0, 0)] * run)
        else:
            toks.append((v, 0, 0))
            run -= 1
            while run >= 3:
                r = min(run, 6)
                toks.append((16, r - 3, 2))
                run -= r
            toks.extend([(v, 0, 0)] * run)
        i = j

    cl_freq = np.bincount([t[0] for t in toks], minlength=19)[:19]
    cl_lengths, cl_codes, _ = build_huffman_tree(cl_freq, 7)
    num_cl = 19
    while num_cl > 4 and cl_lengths[CLCL_ORDER[num_cl - 1]] == 0:
        num_cl -= 1

    sink = bytearray()
    w = BitWriter(sink)
    w.write_bits(0x9C78, 16)  # zlib magic
    w.write_bits(0b101, 3)    # BFINAL=1, BTYPE=dynamic
    w.write_bits(num_litlen - 257, 5)
    w.write_bits(num_dist - 1, 5)
    w.write_bits(num_cl - 4, 4)
    for j in range(num_cl):
        w.write_bits(int(cl_lengths[CLCL_ORDER[j]]), 3)
    for sym, ev, eb in toks:
        w.write_bits(int(cl_codes[sym]), int(cl_lengths[sym]))
        if eb:
            w.write_bits(ev, eb)
    hbits = w.bit_position
    w.flush()
    raw = bytes(sink) + bytes((-len(sink)) % 4)
    hwords = np.frombuffer(raw, "<u4")
    return hbits, hwords, lengths, codes, dist_lengths, dist_codes


# Search effort per general level (JAX matchscan.py:795): the
# k-predecessor probe depth of the sorted-neighbourhood finder.
DEVICE_LEVELS = {
    1: dict(depth=4, min_match=4),
    2: dict(depth=8, min_match=4),
    3: dict(depth=16, min_match=4),
}


def _code_lengths(freq_l: torch.Tensor, freq_d: torch.Tensor):
    """Host: (lit int32[B, 286], dist int32[B, 30]) optimal code lengths
    of the frequencies read back from the card."""
    fl, fd = freq_l.cpu().numpy(), freq_d.cpu().numpy()
    lit = np.zeros(fl.shape, np.int32)
    dist = np.zeros(fd.shape, np.int32)
    for b in range(fl.shape[0]):
        lit[b] = build_huffman_tree(fl[b].astype(np.int64), 15)[0]
        dist[b] = build_huffman_tree(fd[b].astype(np.int64), 15)[0]
    return lit, dist


def _first_pass_trees(hist: torch.Tensor, freq_l: torch.Tensor,
                      freq_d: torch.Tensor):
    """Host after stage 1: (shadow literal costs int32[B, 256], i.e. the
    byte histogram's code lengths with 15 for absent bytes, and the
    first-pass code lengths)."""
    h = hist.cpu().numpy()
    shadow = np.zeros(h.shape, np.int32)
    for b in range(h.shape[0]):
        sl = build_huffman_tree(h[b].astype(np.int64), 15)[0]
        shadow[b] = np.where(sl > 0, sl, 15)
    return (shadow, *_code_lengths(freq_l, freq_d))


def _headers(freq_l: torch.Tensor, freq_d: torch.Tensor):
    """Host: each stream's header and code tables, as int32 arrays
    (header_bits [B], header_words [B, 48], lit_codes, lit_lens [B, 286],
    dist_codes, dist_lens [B, 30])."""
    fl, fd = freq_l.cpu().numpy(), freq_d.cpu().numpy()
    B = fl.shape[0]
    header_words = np.zeros((B, _HW), np.uint32)
    header_bits = np.zeros(B, np.int32)
    lit_codes = np.zeros((B, 286), np.int32)
    lit_lens = np.zeros((B, 286), np.int32)
    dist_codes = np.zeros((B, 30), np.int32)
    dist_lens = np.zeros((B, 30), np.int32)
    for b in range(B):
        hbits, hwords, ll, lc, dl, dc = _host_header(fl[b], fd[b])
        if hbits > _HW * 32:
            raise ValueError(f"stream {b}: a {hbits}-bit header exceeds "
                             f"{_HW * 32} bits")
        header_bits[b] = hbits
        header_words[b, : len(hwords)] = hwords[:_HW]
        lit_lens[b], lit_codes[b] = ll, lc
        dist_lens[b], dist_codes[b] = dl, dc
    return (header_bits, header_words.view(np.int32), lit_codes, lit_lens,
            dist_codes, dist_lens)


def _read_back(words: torch.Tensor, total_bits: torch.Tensor,
               adler: torch.Tensor) -> list[bytes]:
    """The zlib streams: each stream's used words, ceil(total_bits / 32),
    in one copy from the card, cut to total_bits / 8 bytes, then its
    Adler-32 (big-endian)."""
    B, W = words.shape
    tb = total_bits.cpu().numpy().astype(np.int64)
    nw = (tb + 31) // 32
    used = _cols(W, words.device) < torch.from_numpy(nw).to(words.device)[:, None]
    flat = words[used].cpu().numpy().astype("<i4").tobytes()
    ad = adler.cpu().numpy()
    out, at = [], 0
    for b in range(B):
        out.append(flat[at: at + int(tb[b]) // 8]
                   + int(ad[b]).to_bytes(4, "big"))
        at += 4 * int(nw[b])
    return out


def compress_batch_device(streams: list[bytes], level: int = 2, *,
                          device="cuda") -> list[bytes]:
    """Batch encode at a general compression level (1-3) on ``device``.

    The level picks the probe depth (``DEVICE_LEVELS``); as in JAX, level 0
    and below encode as level 1 and levels 4 and above as level 3.
    Output: standard zlib, one dynamic block per stream.
    """
    cfg = DEVICE_LEVELS[max(1, min(int(level), 3))]
    return compress_batch_matched(streams, **cfg, device=device)


def compress_batch_matched(streams: list[bytes], depth: int = 2,
                           min_match: int = 4, backext: bool = True,
                           passes: int = 2, *, device="cuda") -> list[bytes]:
    """Batch encode with LZ77 matching (levels 1-3) on ``device``.

    Three device stages with small host hops (see the module docstring):
    match scan -> roles, frequencies, byte histogram; host first-pass trees
    and shadow literal costs; ``passes`` rounds of segment demotion and
    host code lengths; host headers; bit packing; K7 Adler-32; the used
    words read back.  Streams of at most 2^20 bytes; output: one dynamic
    block per stream, the JAX package's bytes.
    """
    dev = device_of(device)
    B = len(streams)
    lengths_np = np.array([len(s) for s in streams], np.int32)
    N = max(8, int(-(-int(lengths_np.max(initial=1)) // 8) * 8))
    buf = np.zeros((B, N), np.uint8)
    for i, s in enumerate(streams):
        buf[i, : len(s)] = np.frombuffer(s, np.uint8)
    data = torch.from_numpy(buf).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)

    segments, roles, (freq_l, freq_d), hist = _stage1(
        data, lengths, depth, min_match, backext)
    shadow, fp_lit, fp_dist = _first_pass_trees(hist, freq_l, freq_d)
    shadow = torch.from_numpy(shadow).to(dev)
    for p in range(passes):
        if p:
            fp_lit, fp_dist = _code_lengths(freq_l, freq_d)
        segments, roles, (freq_l, freq_d) = _demote_segments(
            data, lengths, segments, shadow, torch.from_numpy(fp_lit).to(dev),
            torch.from_numpy(fp_dist).to(dev), min_match)
    tables = [torch.from_numpy(a).to(dev) for a in _headers(freq_l, freq_d)]
    header_bits, header_words, lit_codes, lit_lens, dist_codes, dist_lens = tables
    words, total_bits = _pack_symbols(data, lengths, roles, lit_codes,
                                      lit_lens, dist_codes, dist_lens,
                                      header_bits, header_words)
    return _read_back(words, total_bits, adler32_batch(data, lengths))
