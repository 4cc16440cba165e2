"""The plain reference that decides ``correct``: NumPy, Python's ``zlib``
and plain Python, with nothing of the program under test.

* ``frame``: zlib stream bytes from an encode leg's artifact (words,
  total bits, Adler-32), as RFC 1950 lays them out.
* ``check_index``: every chunk of a fixed-geometry artifact decoded on its
  own, from its index entry to the next (or to the end-of-stream token),
  with the Huffman code read from the stream's own header: a lane is good
  when it ends exactly at the next entry and its literals and matches give
  exactly the chunk's bytes of the input.  All lanes step together
  (vectorised over lanes, one token per step).
* ``inflate_blocks``: a plain inflater (RFC 1951) that decodes each block
  with an empty window, the shortcut of a block-parallel decoder that
  skips the stitch; the inflate cells' control.
"""

from __future__ import annotations

import zlib

import numpy as np

# RFC 1951 3.2.5: length codes 257..285 and distance codes 0..29.
LEN_BASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                     31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227,
                     258], np.int64)
LEN_EXTRA = np.array([0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4
                     + [5] * 4 + [0], np.int64)
DIST_BASE = np.array([1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                      193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                      6145, 8193, 12289, 16385, 24577], np.int64)
DIST_EXTRA = np.array([0, 0, 0, 0] + [i // 2 for i in range(2, 28)], np.int64)
CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
PEEK = 15   # the longest code deflate allows


class DeflateError(ValueError):
    """A stream the plain inflater cannot read."""


def frame(words: np.ndarray, total_bits: int, adler: int) -> bytes:
    """One zlib stream from an artifact's words (u32 patterns, little-endian
    in the stream), its bit count (header to the padded end of the deflate
    data) and its Adler-32, stored big-endian after the data."""
    raw = np.asarray(words).astype("<u4").tobytes()[: int(total_bits) // 8]
    return raw + int(adler).to_bytes(4, "big")


class BitReader:
    """LSB-first bits of ``data`` from bit ``pos``."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def take(self, n: int) -> int:
        v = 0
        for i in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise DeflateError("read past the end of the stream")
            v |= ((self.data[byte] >> (self.pos & 7)) & 1) << i
            self.pos += 1
        return v


def canonical_codes(lengths) -> list[tuple[int, int, int]]:
    """(symbol, code, length) of a canonical Huffman code (RFC 1951
    3.2.2), codes MSB-first; raises on an over-subscribed code."""
    lengths = [int(x) for x in lengths]
    count = [0] * (PEEK + 1)
    for n in lengths:
        count[n] += 1
    count[0] = 0
    code, nxt, left = 0, [0] * (PEEK + 2), 1
    for bits in range(1, PEEK + 1):
        left = (left << 1) - count[bits]
        if left < 0:
            raise DeflateError("over-subscribed code")
        code = (code + count[bits - 1]) << 1
        nxt[bits] = code
    out = []
    for sym, n in enumerate(lengths):
        if n:
            out.append((sym, nxt[n], n))
            nxt[n] += 1
    return out


def decode_table(lengths) -> np.ndarray:
    """int64[2^15]: for each 15-bit LSB-first peek, ``symbol << 4 |
    length`` of the code it starts with, 0 where no code matches."""
    tab = np.zeros(1 << PEEK, np.int64)
    for sym, code, n in canonical_codes(lengths):
        rev = int(format(code, f"0{n}b")[::-1], 2)
        tab[rev::1 << n] = sym << 4 | n
    return tab


def read_dynamic_header(r: BitReader) -> tuple[list[int], list[int]]:
    """The literal/length and distance code lengths of a dynamic block
    whose HLIT field starts at ``r.pos`` (RFC 1951 3.2.7)."""
    hlit, hdist, hclen = r.take(5) + 257, r.take(5) + 1, r.take(4) + 4
    cl = [0] * 19
    for i in range(hclen):
        cl[CL_ORDER[i]] = r.take(3)
    cl_codes = {(code, n): sym for sym, code, n in canonical_codes(cl)}
    lengths: list[int] = []
    while len(lengths) < hlit + hdist:
        code, n = 0, 0
        while (code, n) not in cl_codes:
            code, n = code << 1 | r.take(1), n + 1
            if n > 7:
                raise DeflateError("bad code-length code")
        sym = cl_codes[(code, n)]
        if sym < 16:
            lengths.append(sym)
        elif sym == 16:
            if not lengths:
                raise DeflateError("repeat with no previous length")
            lengths += [lengths[-1]] * (3 + r.take(2))
        else:
            lengths += [0] * ((3 + r.take(3)) if sym == 17 else (11 + r.take(7)))
    if len(lengths) != hlit + hdist:
        raise DeflateError("code lengths overrun")
    return lengths[:hlit], lengths[hlit:]


def stream_tables(stream: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(literal/length table, distance table) of a zlib stream whose first
    block is dynamic, from its own header."""
    r = BitReader(stream, 16)
    r.take(1)
    if r.take(2) != 2:
        raise DeflateError("first block is not dynamic")
    lit, dist = read_dynamic_header(r)
    return decode_table(lit), decode_table(dist)


def _peek(words64: np.ndarray, pos: np.ndarray, nbits) -> np.ndarray:
    """``nbits`` (<= 32) LSB-first bits of the concatenated u32 words at
    global bit ``pos``."""
    w = pos >> 5
    v = (words64[w] | (words64[w + 1] << 32)) >> (pos & 31)
    return v & ((np.int64(1) << nbits) - 1)


def check_index(streams: list[bytes], starts: np.ndarray, eof_pos: np.ndarray,
                data: np.ndarray) -> np.ndarray:
    """bool[B, C]: lane k of stream b decodes, from ``starts[b, k]`` to the
    next entry (``eof_pos[b]`` after the last), to exactly bytes
    ``[k S, (k + 1) S)`` of ``data[b]`` (S = N / C) and stops there.

    The code is each stream's own (its first block's header); a lane fails
    on a code no table holds, an end-of-block inside it, a length or
    distance code out of range, a match reaching before the stream, a
    byte that differs, or an end anywhere but the next entry."""
    B, N = data.shape
    C = starts.shape[1]
    S = N // C
    tabs = [stream_tables(s) for s in streams]
    lit_tab = np.stack([t[0] for t in tabs]).reshape(-1)
    dist_tab = np.stack([t[1] for t in tabs]).reshape(-1)
    nw = [(len(s) + 3) // 4 + 2 for s in streams]
    base = np.concatenate([[0], np.cumsum(nw)])
    buf = np.zeros(int(base[-1]) * 4, np.uint8)
    for b, s in enumerate(streams):
        buf[base[b] * 4: base[b] * 4 + len(s)] = np.frombuffer(s, np.uint8)
    words64 = buf.view("<u4").astype(np.int64)
    flat = data.reshape(-1)

    lane_b = np.repeat(np.arange(B), C)
    ends = np.concatenate([starts[:, 1:], eof_pos[:, None]], axis=1)
    p = (starts.astype(np.int64) + base[:B, None] * 32).reshape(-1)
    end = (ends.astype(np.int64) + base[:B, None] * 32).reshape(-1)
    q = (np.arange(B)[:, None] * N + np.arange(C)[None, :] * S).reshape(-1)
    qend = q + S
    qlo = lane_b * N                     # a match may not reach before it
    tab_off = lane_b << PEEK
    ok = end >= p
    mq, mlen, mdist, mlane = [], [], [], []
    idx = np.flatnonzero(ok & (p < end))
    while idx.size:
        pi, ti = p[idx], tab_off[idx]
        e = lit_tab[ti + _peek(words64, pi, PEEK)]
        sym, n = e >> 4, e & 15
        bad = (n == 0) | (sym == 256) | (sym > 285)
        lit = ~bad & (sym < 256)
        bad |= lit & ((q[idx] >= qend[idx])
                      | (flat[np.minimum(q[idx], flat.size - 1)] != sym))
        m = np.flatnonzero(~bad & (sym > 256))
        pi = pi + n
        if m.size:
            li = sym[m] - 257
            pm = pi[m]
            xb = LEN_EXTRA[li]
            length = LEN_BASE[li] + _peek(words64, pm, xb)
            pm = pm + xb
            de = dist_tab[ti[m] + _peek(words64, pm, PEEK)]
            dsym, dn = de >> 4, de & 15
            dbad = (dn == 0) | (dsym >= 30)
            dsym = np.where(dbad, 0, dsym)
            pm = pm + dn
            dx = DIST_EXTRA[dsym]
            dist = DIST_BASE[dsym] + _peek(words64, pm, dx)
            pm = pm + dx
            lanes = idx[m]
            qm = q[lanes]
            dbad |= (qm - dist < qlo[lanes]) | (qm + length > qend[lanes])
            bad[m] |= dbad
            good = ~dbad
            mq.append(qm[good])
            mlen.append(length[good])
            mdist.append(dist[good])
            mlane.append(lanes[good])
            pi[m] = pm
            q[lanes] = qm + np.where(dbad, 0, length)
        q[idx[lit]] += 1
        p[idx] = pi
        ok[idx[bad]] = False
        idx = idx[~bad]
        idx = idx[p[idx] < end[idx]]
    ok &= (p == end) & (q == qend)
    if mq:
        ok &= _matches_ok(flat, np.concatenate(mq), np.concatenate(mlen),
                          np.concatenate(mdist), np.concatenate(mlane),
                          ok.size)
    return ok.reshape(B, C)


def _matches_ok(flat, q, length, dist, lane, n_lanes, block=1 << 22):
    """bool[n_lanes]: every byte each lane's matches copy equals the byte
    ``dist`` before it in ``flat`` (expanded ``block`` bytes at a time)."""
    ok = np.ones(n_lanes, bool)
    cum = np.cumsum(length)
    for sel in np.split(np.arange(q.size), np.flatnonzero(np.diff(cum // block)) + 1):
        ln = length[sel]
        first = np.repeat(np.cumsum(ln) - ln, ln)
        at = np.repeat(q[sel], ln) + np.arange(int(ln.sum())) - first
        diff = flat[at] != flat[at - np.repeat(dist[sel], ln)]
        ok[np.repeat(lane[sel], ln)[diff]] = False
    return ok


def inflate_blocks(stream: bytes) -> bytes:
    """A zlib stream decoded block by block, each block from an empty
    window: a back-reference before the block's first byte reads zeros.

    This breaks the exact-bytes guarantee the way a block-parallel decoder
    that skips its stitch would; the checksum is not verified.  Stored,
    fixed and dynamic blocks are read (RFC 1951 3.2.3-3.2.7)."""
    r = BitReader(stream, 16)
    out = bytearray()
    while True:
        final, btype = r.take(1), r.take(2)
        start = len(out)
        if btype == 0:
            r.pos = (r.pos + 7) & ~7
            n = r.take(16)
            r.take(16)
            out += stream[r.pos // 8: r.pos // 8 + n]
            r.pos += 8 * n
        elif btype in (1, 2):
            if btype == 1:
                lit = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
                dist = [5] * 30
            else:
                lit, dist = read_dynamic_header(r)
            _decode_block(r, decode_table(lit), decode_table(dist), out, start)
        else:
            raise DeflateError("reserved block type")
        if final:
            return bytes(out)


def _decode_block(r: BitReader, lit_tab, dist_tab, out: bytearray,
                  start: int) -> None:
    data, pos = r.data, r.pos
    lit_tab, dist_tab = lit_tab.tolist(), dist_tab.tolist()
    padded = data + bytes(8)

    def peek(at, n):
        b = at >> 3
        return (int.from_bytes(padded[b: b + 5], "little") >> (at & 7)) & ((1 << n) - 1)

    while True:
        e = lit_tab[peek(pos, PEEK)]
        if not e:
            raise DeflateError("invalid literal/length code")
        sym = e >> 4
        pos += e & 15
        if sym < 256:
            out.append(sym)
            continue
        if sym == 256:
            r.pos = pos
            return
        li = sym - 257
        if li >= 29:
            raise DeflateError("invalid length code")
        xb = int(LEN_EXTRA[li])
        length = int(LEN_BASE[li]) + peek(pos, xb)
        pos += xb
        d = dist_tab[peek(pos, PEEK)]
        if not d or (d >> 4) >= 30:
            raise DeflateError("invalid distance code")
        pos += d & 15
        dsym = d >> 4
        dx = int(DIST_EXTRA[dsym])
        dist = int(DIST_BASE[dsym]) + peek(pos, dx)
        pos += dx
        for _ in range(length):
            src = len(out) - dist
            out.append(out[src] if src >= start else 0)


def inflate(stream: bytes) -> bytes:
    """The reference decode of a zlib stream: Python's ``zlib``."""
    return zlib.decompress(stream)
