"""DEFLATE constant tables (RFC 1951) and the PNG-corpus-trained Huffman tree.

The port's copy of the constants of ``fdeflate_tpu/tables.py`` that it
uses, derived the same way: ``LEN_SYM_TO_LEN_BASE`` :49,
``LEN_SYM_TO_LEN_EXTRA`` :56, ``DIST_SYM_TO_DIST_BASE`` :63,
``DIST_SYM_TO_DIST_EXTRA`` :70, ``CLCL_ORDER`` :78, ``LENGTH_TO_SYMBOL`` and
``LENGTH_TO_LEN_EXTRA`` (``_build_length_maps`` :87),
``distance_to_dist_sym``, ``_build_distance_map`` and ``DISTANCE_TO_SYM``
(:110-128), ``HUFFMAN_LENGTHS``
(``_TRAINED_RLE`` :137), ``HUFFMAN_CODES`` (``canonical_codes`` :153),
``FIXED_CODE_LENGTHS`` (``fixed_code_lengths`` :220), and the
decode-table constants the reference decode tables of ``huffman.build_table``
use: the entry flags and default table sizes (:36-42) and the entry
templates ``LITLEN_TABLE_ENTRIES`` and ``DISTANCE_TABLE_ENTRIES``
(``_build_litlen_entries`` :193, ``_build_distance_entries`` :207).
tests/test_torch_hostcopies.py holds every array equal to the original.
"""

from __future__ import annotations

import numpy as np

# Decode-table entry flags (reference: src/decompress.rs:61-63) and default
# table sizes (src/decompress.rs:65-67).  A 32-bit entry is a literal
# (``lit2 << 24 | lit1 << 16 | LITERAL_ENTRY | count << 8 | bits``), a
# length (``base << 16 | extra << 8 | bits``), EOF (``EXCEPTIONAL_ENTRY |
# bits``), a secondary-table pointer (``start << 16 | EXCEPTIONAL_ENTRY |
# SECONDARY_TABLE_ENTRY | mask``) or invalid (``EXCEPTIONAL_ENTRY``).
LITERAL_ENTRY = 0x8000
EXCEPTIONAL_ENTRY = 0x4000
SECONDARY_TABLE_ENTRY = 0x2000
DEFAULT_LITLEN_TABLE_SIZE = 4096
DEFAULT_DIST_TABLE_SIZE = 512

# Base match length and extra-bit count of each length symbol 257..285
# (index 0 == symbol 257).
LEN_SYM_TO_LEN_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
     67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int64,
)
LEN_SYM_TO_LEN_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
     5, 5, 5, 5, 0],
    dtype=np.int64,
)

# Base distance and extra-bit count of each distance symbol 0..29.
DIST_SYM_TO_DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513,
     769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577],
    dtype=np.int64,
)
DIST_SYM_TO_DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
     11, 11, 12, 12, 13, 13],
    dtype=np.int64,
)

# Order in which code-length-code lengths appear in a dynamic block header
# (RFC 1951 section 3.2.7).
CLCL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int64,
)


def _build_length_maps() -> tuple[np.ndarray, np.ndarray]:
    """Match length (3..258, indexed by length - 3) -> symbol, extra bits."""
    to_symbol = np.zeros(256, dtype=np.int64)
    to_extra = np.zeros(256, dtype=np.int64)
    for i in range(28):  # symbols 257..284 cover lengths 3..257
        base = int(LEN_SYM_TO_LEN_BASE[i])
        extra = int(LEN_SYM_TO_LEN_EXTRA[i])
        span = 1 << extra
        to_symbol[base - 3 : base - 3 + span] = 257 + i
        to_extra[base - 3 : base - 3 + span] = extra
    # Length 258 has its own dedicated symbol with no extra bits.
    to_symbol[255] = 285
    to_extra[255] = 0
    return to_symbol, to_extra


LENGTH_TO_SYMBOL, LENGTH_TO_LEN_EXTRA = _build_length_maps()


def distance_to_dist_sym(distance: int) -> int:
    """Distance (1..32768) -> distance symbol (0..29)."""
    return int(_DISTANCE_TO_SYM[distance - 1])


def _build_distance_map() -> np.ndarray:
    out = np.zeros(32768, dtype=np.int64)
    for sym in range(30):
        base = int(DIST_SYM_TO_DIST_BASE[sym])
        span = 1 << int(DIST_SYM_TO_DIST_EXTRA[sym])
        out[base - 1 : base - 1 + span] = sym
    return out


_DISTANCE_TO_SYM = _build_distance_map()
DISTANCE_TO_SYM = _DISTANCE_TO_SYM  # vectorized variant: DISTANCE_TO_SYM[dist-1]

# Corpus-trained literal/length code lengths (data): 286 lengths, all <= 12
# bits, as (code length, repeat count) runs.
_TRAINED_RLE = [
    # literals 0..255:
    (2, 1), (3, 1), (4, 1), (5, 2), (6, 2), (7, 3), (8, 5), (9, 7), (10, 9),
    (11, 12), (12, 171), (11, 10), (10, 1), (11, 1), (10, 9), (9, 5), (8, 1),
    (9, 1), (8, 5), (7, 3), (6, 3), (5, 1), (4, 1), (3, 1),
    # EOF (256) and length symbols 257..285:
    (12, 3), (9, 2), (11, 1), (10, 1), (11, 2), (10, 1), (11, 6), (12, 1),
    (11, 1), (12, 11), (9, 1),
]
HUFFMAN_LENGTHS = np.array(
    [length for length, count in _TRAINED_RLE for _ in range(count)],
    dtype=np.int64,
)


def canonical_codes(lengths: np.ndarray, max_length: int = 16) -> np.ndarray | None:
    """Canonical Huffman codes, bit-reversed for LSB-first streams, or
    None unless the lengths describe a complete code."""
    lengths = np.asarray(lengths, dtype=np.int64)
    codes = np.zeros(lengths.shape, dtype=np.int64)
    code = 0
    for length in range(1, max_length + 1):
        (syms,) = np.nonzero(lengths == length)
        if len(syms):
            seq = code + np.arange(len(syms), dtype=np.int64)
            codes[syms] = _bit_reverse(seq, length)
            code += len(syms)
        code <<= 1
    if code != 2 << max_length:
        return None
    return codes


def _bit_reverse(values: np.ndarray, nbits: int) -> np.ndarray:
    out = np.zeros_like(values)
    v = values.copy()
    for _ in range(nbits):
        out = (out << 1) | (v & 1)
        v >>= 1
    return out


HUFFMAN_CODES = canonical_codes(HUFFMAN_LENGTHS)


def _build_litlen_entries() -> np.ndarray:
    """Decode-table entry templates of the 288 literal/length symbols
    (reference: src/tables.rs:99-140); ``build_table`` ORs the code length
    into their low 4 bits."""
    entries = np.full(288, EXCEPTIONAL_ENTRY, dtype=np.uint32)
    lits = np.arange(256, dtype=np.uint32)
    entries[:256] = (lits << 16) | LITERAL_ENTRY | (1 << 8)
    entries[257:286] = (
        (LEN_SYM_TO_LEN_BASE.astype(np.uint32) << 16)
        | (LEN_SYM_TO_LEN_EXTRA.astype(np.uint32) << 8)
    )
    return entries


def _build_distance_entries() -> np.ndarray:
    """Templates of the 32 distance symbols; 30 and 31 stay 0 (invalid)."""
    entries = np.zeros(32, dtype=np.uint32)
    entries[:30] = (
        (DIST_SYM_TO_DIST_BASE.astype(np.uint32) << 16)
        | (DIST_SYM_TO_DIST_EXTRA.astype(np.uint32) << 8)
        | LITERAL_ENTRY
    )
    return entries


LITLEN_TABLE_ENTRIES = _build_litlen_entries()
DISTANCE_TABLE_ENTRIES = _build_distance_entries()


def fixed_code_lengths() -> np.ndarray:
    """The fixed-Huffman block code lengths (RFC 1951 section 3.2.6): 288
    literal/length codes, then 32 distance codes."""
    lengths = np.zeros(320, dtype=np.int64)
    lengths[0:144] = 8
    lengths[144:256] = 9
    lengths[256:280] = 7
    lengths[280:288] = 8
    lengths[288:320] = 5
    return lengths


FIXED_CODE_LENGTHS = fixed_code_lengths()
