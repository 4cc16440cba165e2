"""Huffman code lengths and reference decode tables.

Copies of functions of the JAX package, kept in the port so that it
imports nothing of that package:

* ``compute_code_lengths`` <- ``fdeflate_tpu/huffman.py:53``, the
  length-limited DP (reference: src/lib.rs:42-101) that
  ``ops/septree.kernel_tree`` runs;
* ``build_huffman_tree`` <- ``fdeflate_tpu/models/bitstream.py:47``, the
  heap Huffman build with Kraft-sum length limiting (reference:
  src/compress/bitstream.rs:198-325) that ``ops/septree._build_header``
  runs for the code-length code;
* ``build_table`` with ``DecodeTables``, ``_next_codeword`` and
  ``_leading_zeros16`` <- ``fdeflate_tpu/huffman.py:109-300``: the
  reference's 4096-entry literal/length and 512-entry distance decode
  tables with their secondary tables and ``first_len`` (reference:
  src/huffman.rs:18-184), which ``ops/decode_symbols`` reads;
* ``FIXED_LITLEN_TABLE`` / ``FIXED_DIST_TABLE`` <- ``_build_fixed_tables``
  of ``fdeflate_tpu/huffman.py:302``: the fixed-block decode tables of
  ``models/decompressor.py``.

tests/test_torch_hostcopies.py holds each equal to its original.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from .tables import (
    DISTANCE_TABLE_ENTRIES,
    EXCEPTIONAL_ENTRY,
    FIXED_CODE_LENGTHS,
    LITERAL_ENTRY,
    LITLEN_TABLE_ENTRIES,
    SECONDARY_TABLE_ENTRY,
)


def compute_code_lengths(
    freqs: np.ndarray,
    min_limit: np.ndarray,
    max_limit: np.ndarray,
) -> np.ndarray:
    """Build a length-limited Huffman tree via dynamic programming.

    Returns the optimal code length per symbol, where every symbol gets a code
    and lengths are constrained to ``[min_limit[i], max_limit[i]]``.
    Semantics match the reference's fpnge-derived DP (src/lib.rs:42-101); the
    per-offset inner loop is vectorized.
    """
    freqs = np.asarray(freqs, dtype=np.uint64)
    min_limit = np.asarray(min_limit, dtype=np.int64)
    max_limit = np.asarray(max_limit, dtype=np.int64)
    n = len(freqs)
    assert len(min_limit) == n and len(max_limit) == n
    assert np.all(min_limit >= 1) and np.all(min_limit <= max_limit)

    precision = int(max_limit.max())
    num_patterns = 1 << precision
    infinity = np.iinfo(np.uint64).max

    # dynp[sym, off]: minimal weighted length using symbols < sym with
    # codespace usage exactly `off` (in units of 2^-precision).
    dynp = np.full((n + 1, num_patterns + 1), infinity, dtype=np.uint64)
    dynp[0, 0] = 0

    for sym in range(n):
        freq = int(freqs[sym])
        for bits in range(int(min_limit[sym]), int(max_limit[sym]) + 1):
            off_delta = 1 << (precision - bits)
            cost = np.uint64(min(freq * bits, int(infinity)))
            prev = dynp[sym, : num_patterns + 1 - off_delta]
            cand = np.where(prev >= infinity - cost, infinity, prev + cost)
            cur = dynp[sym + 1, off_delta:]
            dynp[sym + 1, off_delta:] = np.minimum(cur, cand)

    lengths = np.zeros(n, dtype=np.int64)
    off = num_patterns
    for sym in range(n - 1, -1, -1):
        assert off > 0
        freq = int(freqs[sym])
        for bits in range(int(min_limit[sym]), int(max_limit[sym]) + 1):
            off_delta = 1 << (precision - bits)
            cost = min(freq * bits, int(infinity))
            if off_delta <= off:
                prev = int(dynp[sym, off - off_delta])
                total = infinity if prev >= infinity - cost else prev + cost
                if int(dynp[sym + 1, off]) == int(total):
                    off -= off_delta
                    lengths[sym] = bits
                    break
    return lengths


def build_huffman_tree(
    frequencies: np.ndarray, length_limit: int
) -> tuple[np.ndarray, np.ndarray, bool]:
    """Optimal length-limited Huffman code for the given frequencies.

    Returns ``(lengths, codes, is_multi_symbol)``.  Alphabets with <= 1 used
    symbol get a single 1-bit code and ``is_multi_symbol == False``
    (reference: src/compress/bitstream.rs:198-325).
    """
    frequencies = np.asarray(frequencies, dtype=np.int64)
    n = len(frequencies)
    lengths = np.zeros(n, dtype=np.int64)
    codes = np.zeros(n, dtype=np.int64)

    used = np.nonzero(frequencies)[0]
    if len(used) <= 1:
        if len(used):
            lengths[used[0]] = 1
        return lengths, codes, False

    # Standard two-queue-equivalent heap construction.  Ties break on the
    # smallest node id for determinism.
    heap = [(int(frequencies[i]), int(i)) for i in used]
    heapq.heapify(heap)
    parents: dict[int, tuple[int, int]] = {}
    next_id = n
    while len(heap) > 1:
        f1, n1 = heapq.heappop(heap)
        f2, n2 = heapq.heappop(heap)
        parents[next_id] = (n1, n2)
        heapq.heappush(heap, (f1 + f2, next_id))
        next_id += 1

    # Walk the tree to assign depths.
    stack = [(heap[0][1], 0)]
    while stack:
        node, depth = stack.pop()
        if node < n:
            lengths[node] = depth
        else:
            left, right = parents[node]
            stack.append((left, depth + 1))
            stack.append((right, depth + 1))

    # Kraft-sum length limiting (reference: src/compress/bitstream.rs:264-308).
    max_length = int(lengths.max())
    if max_length > length_limit:
        counts = np.zeros(16, dtype=np.int64)
        for length in lengths:
            if length:
                counts[min(int(length), length_limit)] += 1
        total = int(
            sum(int(counts[i]) << (length_limit - i) for i in range(1, length_limit + 1))
        )
        while total > (1 << length_limit):
            i = length_limit - 1
            while counts[i] == 0:
                i -= 1
            counts[i] -= 1
            counts[length_limit] -= 1
            counts[i + 1] += 2
            total -= 1
        # Reassign: least frequent symbols get the longest codes.
        order = np.argsort(frequencies, kind="stable")
        length = length_limit
        for i in order:
            if frequencies[i] > 0:
                while counts[length] == 0:
                    length -= 1
                lengths[i] = length
                counts[length] -= 1

    # Canonical, bit-reversed code assignment.
    code = 0
    for length in range(1, length_limit + 1):
        for i in np.nonzero(lengths == length)[0]:
            codes[i] = int(
                format(code, f"0{length}b")[::-1], 2
            )
            code += 1
        code <<= 1
    assert code == 2 << length_limit, "length-limited tree must be complete"

    return lengths, codes, True


def _next_codeword(codeword: int, table_size: int) -> int:
    """Advance a bit-reversed canonical codeword (reference: src/huffman.rs:5-15)."""
    if codeword == table_size - 1:
        return codeword
    adv = 15 - _leading_zeros16(codeword ^ (table_size - 1))
    bit = 1 << adv
    return (codeword & (bit - 1)) | bit


def _leading_zeros16(v: int) -> int:
    assert 0 < v < (1 << 16)
    return 16 - v.bit_length()


@dataclass
class DecodeTables:
    """Output of build_table.

    ``first_len[i]`` is the code length of the *first* symbol decoded at
    table index ``i`` (used by chunked decoders to split an atomic
    double-literal entry whose second symbol starts exactly at a chunk
    boundary); 0 where no literal decodes at ``i``.
    """

    ok: bool
    codes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    primary: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    secondary: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint16))
    first_len: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))


def build_table(
    lengths: np.ndarray,
    entries: np.ndarray | None,
    primary_table_size: int,
    *,
    is_distance_table: bool,
    double_literal: bool,
) -> DecodeTables:
    """Build primary + secondary decode tables from code lengths.

    Matches the reference builder (src/huffman.rs:18-184) entry-for-entry:

    * primary entries are the symbol's template entry (or ``symbol << 16``)
      ORed with the code length;
    * every index whose low bits parse as two complete literal codes with
      total length <= table bits gets a packed double-literal entry;
    * codes longer than the primary table bits go to per-prefix secondary
      sub-tables, with sizes that double as longer codes share the prefix.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(lengths)
    size = primary_table_size
    bits = size.bit_length() - 1
    assert size == 1 << bits
    mask = size - 1

    hist = np.bincount(lengths, minlength=16)[:16]
    max_length = 15
    while max_length > 1 and hist[max_length] == 0:
        max_length -= 1

    codes = np.zeros(n, dtype=np.int64)
    primary = np.zeros(size, dtype=np.uint32)
    secondary = np.zeros(0, dtype=np.uint16)

    def template(sym: int) -> int:
        if entries is not None and sym < len(entries):
            return int(entries[sym])
        return sym << 16

    # Zero- and one-symbol codes are only legal for distance tables
    # (reference: src/huffman.rs:39-59).
    if is_distance_table:
        if max_length == 0:
            return DecodeTables(True, codes, primary, secondary)
        if max_length == 1 and hist[1] == 1:
            symbol = int(np.nonzero(lengths == 1)[0][0])
            entry = np.uint32(template(symbol) | 1)
            primary[0::2] = entry
            primary[1::2] = 0
            return DecodeTables(True, codes, primary, secondary)

    # Exact-codespace validity check (reference: src/huffman.rs:63-75).
    codespace_used = 0
    for i in range(1, max_length + 1):
        codespace_used = (codespace_used << 1) + int(hist[i])
    if codespace_used != 1 << max_length:
        return DecodeTables(False)

    # Canonical symbol order: stable sort by code length (zero-length symbols
    # excluded), which equals the reference's counting sort.
    order = [s for s in sorted(range(n), key=lambda s: (lengths[s], s)) if lengths[s] > 0]

    # Walk the bit-reversed codeword sequence exactly as the reference does so
    # that codes (and secondary-table layout) match bit-for-bit.
    codeword = 0
    per_symbol = []  # (symbol, length, codeword) in canonical order
    prev_len = None
    for sym in order:
        length = int(lengths[sym])
        per_symbol.append((sym, length, codeword))
        codes[sym] = codeword
        codeword = _next_codeword(codeword, 1 << length)
        prev_len = length

    del prev_len

    # ---- Primary table: single-symbol entries -----------------------------
    # fs_* record the first decoded symbol for every table index, used by the
    # double-literal pass below.
    fs_sym = np.full(size, -1, dtype=np.int64)
    fs_len = np.zeros(size, dtype=np.int64)
    for sym, length, code in per_symbol:
        if length > bits:
            break
        entry = np.uint32(template(sym) | length)
        primary[code :: 1 << length] = entry
        fs_sym[code :: 1 << length] = sym
        fs_len[code :: 1 << length] = length

    # ---- Primary table: double-literal entries ----------------------------
    if double_literal:
        idx = np.arange(size, dtype=np.int64)
        l1 = fs_len
        s1 = fs_sym
        rem = idx >> np.maximum(l1, 0)
        s2 = fs_sym[rem & mask]
        l2 = fs_len[rem & mask]
        valid = (
            (s1 >= 0)
            & (s1 < 256)
            & (s2 >= 0)
            & (s2 < 256)
            & (l1 + l2 <= bits)
        )
        dbl = (
            (s1.astype(np.uint32) << 16)
            | (s2.astype(np.uint32) << 24)
            | np.uint32(LITERAL_ENTRY | (2 << 8))
            | (l1 + l2).astype(np.uint32)
        )
        primary = np.where(valid, dbl, primary)

    # ---- Secondary tables -------------------------------------------------
    # Direct simulation of the reference's subtable allocation and extension
    # rules (src/huffman.rs:139-181): iterate lengths bits+1..=max_length; a
    # new subtable starts when the primary-prefix changes; at the end of each
    # length, if the *next* codeword continues the same prefix, the subtable
    # contents are duplicated (doubling its size).
    if max_length > bits:
        sec: list[int] = []
        long_symbols = [(s, l, c) for (s, l, c) in per_symbol if l > bits]
        subtable_start = 0
        subtable_prefix = -1
        i = 0
        codeword = long_symbols[0][2] if long_symbols else 0
        for length in range(bits + 1, max_length + 1):
            count = int(hist[length])
            for _ in range(count):
                sym, slen, code = long_symbols[i]
                assert slen == length
                i += 1
                codeword = code
                if (codeword & mask) != subtable_prefix:
                    subtable_prefix = codeword & mask
                    subtable_start = len(sec)
                    subtable_size = 1 << (length - bits)
                    overflow_mask = subtable_size - 1
                    primary[subtable_prefix] = np.uint32(
                        (subtable_start << 16)
                        | EXCEPTIONAL_ENTRY
                        | SECONDARY_TABLE_ENTRY
                        | overflow_mask
                    )
                    sec.extend([0] * subtable_size)
                sec[subtable_start + (codeword >> bits)] = (sym << 4) | length
                codeword = _next_codeword(codeword, 1 << length)
            if length < max_length and (codeword & mask) == subtable_prefix:
                sec.extend(sec[subtable_start:])
                subtable_size = len(sec) - subtable_start
                overflow_mask = subtable_size - 1
                primary[subtable_prefix] = np.uint32(
                    (subtable_start << 16)
                    | EXCEPTIONAL_ENTRY
                    | SECONDARY_TABLE_ENTRY
                    | overflow_mask
                )
        secondary = np.array(sec, dtype=np.uint16)

    return DecodeTables(True, codes, primary, secondary, fs_len.astype(np.int8))


def _build_fixed_tables() -> tuple[np.ndarray, np.ndarray]:
    """Precompute the 512-entry litlen / 32-entry dist fixed-block tables.

    The reference ships these as constants (src/tables.rs:142-202); they
    are derived from FIXED_CODE_LENGTHS at import.
    """
    litlen = build_table(
        FIXED_CODE_LENGTHS[:288],
        LITLEN_TABLE_ENTRIES,
        512,
        is_distance_table=False,
        double_literal=True,
    )
    assert litlen.ok and len(litlen.secondary) == 0
    dist = build_table(
        FIXED_CODE_LENGTHS[288:320],
        DISTANCE_TABLE_ENTRIES,
        32,
        is_distance_table=True,
        double_literal=False,
    )
    assert dist.ok and len(dist.secondary) == 0
    return litlen.primary, dist.primary


FIXED_LITLEN_TABLE, FIXED_DIST_TABLE = _build_fixed_tables()
