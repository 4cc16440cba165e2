"""The host half of foreign decode: zlib framing, block headers, tables.

The port's copy of the jax-free host helpers of the JAX package, kept here
so that the port imports nothing of that package:

* from ``fdeflate_tpu/ops/inflate.py``: ``WINDOW`` :47, ``_HostBitReader``
  :658, ``_parse_dynamic_lengths`` :715, ``_fixed_foreign_meta`` :801,
  ``_StreamState`` :979, ``_advance_headers`` :1002 and ``_update_window``
  :1069;
* from ``fdeflate_tpu/ops/pallas_inflate.py`` (numpy only): ``_LIT_BASE``
  :53, ``_CLS_EOB`` :57, ``REC_*`` :62-66, ``_canonical15`` :69,
  ``_canonical_order`` :99 and ``foreign_meta`` :106.

Where the originals build the reference's decode tables
(``huffman.build_table``), the port needs only what those builds decide:
the code-length code's 7-bit lookup (``_cl_table``) and whether a block's
trees are valid (``_check_trees``, the ``ok`` of ``build_table`` with the
original's error classes).  ``_StreamState`` keeps the fields the port
reads.  tests/test_torch_hostcopies.py holds ``foreign_meta``,
``_parse_dynamic_lengths`` and ``_advance_headers`` equal to the originals.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np

from .. import errors as E
from ..tables import (
    CLCL_ORDER,
    FIXED_CODE_LENGTHS,
    LEN_SYM_TO_LEN_BASE,
    LEN_SYM_TO_LEN_EXTRA,
    canonical_codes,
)

WINDOW = 32768

# ---- pallas_inflate: per-block canonical metadata ------------------------

MAXL = 15            # deflate litlen/dist codes are at most 15 bits
_ENTRIES = 320       # 0..29 dist syms, 30..31 sentinels, 32..317 litlen
_LIT_BASE = 32       # litlen canonical entries start here
_SENTINEL = 0x7FFF   # invalid-code entry (cls == 3)

_CLS_EOB = 1
_CLS_LEN = 2

# record kinds (bits 30..28 of the packed record word)
REC_IDLE = 0
REC_LITS = 1
REC_MATCH = 2
REC_EOB = 3
REC_ERR = 4


def _canonical15(lens: np.ndarray):
    """(bounds[16], kvals[16]) for a 15-bit canonical decode of ``lens``:
    bounds[l] the smallest 15-bit-scaled reversed peek not decodable at
    length <= l, sorted_index = kvals[l] + (r15 >> (15 - l)).  Complete
    trees only (ValueError otherwise)."""
    lens = np.asarray(lens, np.int64)
    cnt = np.bincount(lens, minlength=MAXL + 1).astype(np.int64)
    cnt[0] = 0
    first = np.zeros(MAXL + 1, np.int64)
    code = 0
    for L in range(1, MAXL + 1):
        first[L] = code
        code = (code + cnt[L]) << 1
    if code != 1 << (MAXL + 1):
        raise ValueError("tree must be exactly complete")
    bounds = np.zeros(16, np.int64)
    kvals = np.zeros(16, np.int64)
    acc = 0
    for L in range(1, MAXL + 1):
        bounds[L] = (first[L] + cnt[L]) << (MAXL - L)
        kvals[L] = acc - first[L]
        acc += int(cnt[L])
    return bounds, kvals


def _canonical_order(lens: np.ndarray) -> np.ndarray:
    """Symbols with nonzero length in (length, symbol) order."""
    lens = np.asarray(lens, np.int64)
    order = np.lexsort((np.arange(len(lens)), lens))
    return order[lens[order] > 0]


def foreign_meta(litlen_lens, dist_lens):
    """Per-block canonical metadata and packed symbol table of K4.

    ``litlen_lens``: >= 257 lengths, EOB present, exactly complete;
    ``dist_lens``: the 30 distance lengths, possibly empty or single-code
    (reference special cases src/huffman.rs:40-59).  Returns (meta
    i32[64], tab i32[160]): meta rows 0..15 litlen bounds, 16..31 litlen
    kvals (+ ``_LIT_BASE``), 32..47 dist bounds, 48..63 dist kvals; tab two
    15-bit entries per int32, dist entries the symbol id, litlen entries
    ``val | extra << 9 | cls << 13``.
    """
    litlen_lens = np.asarray(litlen_lens, np.int64)
    dist_lens = np.asarray(dist_lens, np.int64)

    entries = np.full(_ENTRIES, _SENTINEL, np.int64)

    lb, lk = _canonical15(litlen_lens)
    lk = lk + _LIT_BASE
    for i, sym in enumerate(_canonical_order(litlen_lens)):
        sym = int(sym)
        if sym < 256:
            e = sym  # cls LIT, extra 0
        elif sym == 256:
            e = _CLS_EOB << 13
        elif sym <= 285:
            e = (int(LEN_SYM_TO_LEN_BASE[sym - 257])
                 | int(LEN_SYM_TO_LEN_EXTRA[sym - 257]) << 9
                 | _CLS_LEN << 13)
        else:
            e = _SENTINEL  # symbols 286/287: valid code, invalid meaning
        entries[_LIT_BASE + i] = e

    nz = int(np.count_nonzero(dist_lens))
    db = np.zeros(16, np.int64)
    dk = np.zeros(16, np.int64)
    if nz == 0:
        # No distance codes: any dist decode must error.  L is always 1
        # (no bound ever exceeded) and kvals[1] points at the sentinels.
        db[1:] = 1 << MAXL
        dk[1] = 30  # idx = 30 + (r15 >> 14) in {30, 31}
    elif nz == 1:
        # One distance code: it gets code '0' (one bit); a '1' bit is an
        # invalid code (reference semantics src/huffman.rs:40-59).
        sym = int(np.flatnonzero(dist_lens)[0])
        db[1] = 1 << (MAXL - 1)
        db[2:] = 1 << MAXL
        dk[1] = 0
        dk[2] = 28  # r15 >> 13 in {2, 3} -> {30, 31}: sentinels
        entries[0] = sym
    else:
        db, dk = _canonical15(dist_lens)
        for i, sym in enumerate(_canonical_order(dist_lens)):
            entries[i] = int(sym) if sym < 30 else _SENTINEL

    meta = np.zeros(64, np.int32)
    meta[0:16] = lb
    meta[16:32] = lk
    meta[32:48] = db
    meta[48:64] = dk
    tab = (entries[0::2] | (entries[1::2] << 16)).astype(np.int32)
    return meta, tab


@functools.lru_cache(maxsize=1)
def _fixed_foreign_meta():
    fl = np.asarray(FIXED_CODE_LENGTHS, np.int64)
    return foreign_meta(fl[:288], np.full(32, 5, np.int64))


# ---- inflate: framing and block headers on the host ----------------------


class _HostBitReader:
    """Host-side bit reader for block headers (whole buffer available)."""

    def __init__(self, data: bytes, bitpos: int = 0):
        self.data = data
        self.pos = bitpos

    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos

    def peek(self, n: int) -> int:
        byte0 = self.pos >> 3
        window = int.from_bytes(self.data[byte0 : byte0 + 9], "little")
        return (window >> (self.pos & 7)) & ((1 << n) - 1)

    def take(self, n: int) -> int:
        if self.bits_left() < n:
            raise E.InsufficientInput()
        v = self.peek(n)
        self.pos += n
        return v


def _code_ok(lengths: np.ndarray, is_distance: bool) -> bool:
    """Whether ``huffman.build_table`` accepts these code lengths: an
    exactly complete code, or (distance tables) no code or one 1-bit
    code."""
    hist = np.bincount(np.asarray(lengths, np.int64), minlength=16)[:16]
    max_length = 15
    while max_length > 1 and hist[max_length] == 0:
        max_length -= 1
    if is_distance and max_length == 1 and hist[1] == 1:
        return True
    used = 0
    for i in range(1, max_length + 1):
        used = (used << 1) + int(hist[i])
    return used == 1 << max_length


def _cl_table(cl_lengths: np.ndarray) -> np.ndarray | None:
    """The code-length code's 128-entry primary table (``symbol << 16 |
    length`` at every 7-bit peek of each code, as ``build_table`` fills
    it), or None for a code that is not exactly complete."""
    if not _code_ok(cl_lengths, False):
        return None
    codes = canonical_codes(cl_lengths, 7)
    table = np.zeros(128, np.int64)
    for sym in _canonical_order(cl_lengths):
        length = int(cl_lengths[sym])
        table[int(codes[sym]) :: 1 << length] = (int(sym) << 16) | length
    return table


def _parse_dynamic_lengths(r: _HostBitReader):
    """Parse a dynamic block header up to its code lengths.

    Returns (lengths i64[320], hlit): litlen code lengths at [0:hlit]
    (zero past hlit), distance code lengths at [288:288+hdist].  Raises
    the same errors, in the same order, as the original.
    """
    hlit = r.take(5) + 257
    hdist = r.take(5) + 1
    hclen = r.take(4) + 4
    if hlit > 286:
        raise E.InvalidHlit()
    if hdist > 30:
        raise E.InvalidHdist()

    cl_lengths = np.zeros(19, np.int64)
    for i in range(hclen):
        cl_lengths[CLCL_ORDER[i]] = r.take(3)
    cl = _cl_table(cl_lengths)
    if cl is None:
        raise E.BadCodeLengthHuffmanTree()

    lengths = np.zeros(320, np.int64)
    n = 0
    total = hlit + hdist
    while n < total:
        if r.bits_left() < 7:
            raise E.InsufficientInput()
        entry = int(cl[r.peek(7)])
        length = entry & 0x7
        symbol = (entry >> 16) & 0xFF
        if symbol <= 15:
            lengths[n] = symbol
            n += 1
            r.take(length)
        else:
            if symbol == 16:
                base, extra = 3, 2
            elif symbol == 17:
                base, extra = 3, 3
            else:
                base, extra = 11, 7
            r.take(length)
            if symbol == 16:
                if n == 0:
                    raise E.InvalidCodeLengthRepeat()
                value = lengths[n - 1]
            else:
                value = 0
            repeat = r.take(extra) + base
            if n + repeat > total:
                raise E.InvalidCodeLengthRepeat()
            lengths[n : n + repeat] = value
            n += repeat

    lengths[288 : 288 + hdist] = lengths[hlit:total].copy()
    lengths[hlit:288] = 0
    lengths[288 + hdist : 320] = 0

    if lengths[256] == 0:
        raise E.BadLiteralLengthHuffmanTree()
    return lengths, hlit


def _check_trees(lengths: np.ndarray, hlit: int) -> None:
    """Raise where the original's table build (``_tables_from_lengths``)
    rejects a block's trees."""
    if not _code_ok(lengths[:hlit], False):
        raise E.BadCodeLengthHuffmanTree()
    dist = lengths[288:320]
    if dist.any() and not _code_ok(dist, True):
        raise E.BadDistanceHuffmanTree()


class _StreamState:
    __slots__ = (
        "data", "bitpos", "out", "window", "done", "error", "last_block",
        "in_block", "lengths", "meta_tab",
    )

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0
        self.out = bytearray()
        self.window = np.zeros(WINDOW, np.uint8)
        self.done = False
        self.error: E.DecompressionError | None = None
        self.last_block = False
        self.in_block = False
        self.lengths = None      # ("fixed" | (lengths, hlit)) of current block
        self.meta_tab = None     # cached foreign_meta of current block


def _advance_headers(st: _StreamState) -> None:
    """Parse framing until the stream enters a compressed block or ends.

    Stored blocks are copied host-side (they are memcpys; no device value).
    """
    r = _HostBitReader(st.data, st.bitpos)
    try:
        if st.bitpos == 0:
            cmf = r.take(8)
            flg = r.take(8)
            if (
                cmf & 0x0F != 0x08
                or (cmf & 0xF0) > 0x70
                or flg & 0x20 != 0
                or ((cmf << 8) | flg) % 31 != 0
            ):
                raise E.BadZlibHeader()
        while not st.done and not st.in_block:
            if st.last_block:
                # checksum
                r.pos = (r.pos + 7) & ~7
                stored = int.from_bytes(
                    r.take(32).to_bytes(4, "little"), "big"
                )
                if stored != zlib.adler32(bytes(st.out)):
                    raise E.WrongChecksum()
                st.done = True
                st.bitpos = r.pos
                return
            header = r.take(3)
            st.last_block = bool(header & 1)
            btype = header >> 1
            if btype == 0b00:
                r.pos = (r.pos + 7) & ~7
                length = r.take(16)
                nlen = r.take(16)
                if nlen != (~length & 0xFFFF):
                    raise E.InvalidUncompressedBlockLength()
                byte0 = r.pos >> 3
                if len(st.data) - byte0 < length:
                    raise E.InsufficientInput()
                chunk = st.data[byte0 : byte0 + length]
                st.out += chunk
                _update_window(st, np.frombuffer(chunk, np.uint8))
                r.pos += length * 8
            elif btype == 0b01:
                st.lengths = "fixed"
                st.meta_tab = None
                st.in_block = True
            elif btype == 0b10:
                lengths, hlit = _parse_dynamic_lengths(r)
                _check_trees(lengths, hlit)
                st.lengths = (lengths, hlit)
                st.meta_tab = None
                st.in_block = True
            else:
                raise E.InvalidBlockType()
        st.bitpos = r.pos
    except E.DecompressionError as err:
        st.error = err
        st.done = True
        st.bitpos = r.pos


def _update_window(st: _StreamState, new: np.ndarray) -> None:
    if len(new) >= WINDOW:
        st.window = new[-WINDOW:].copy()
    elif len(new):
        st.window = np.concatenate([st.window[len(new) :], new])
