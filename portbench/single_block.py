"""Is a zlib stream one RFC 1951 dynamic block?  A plain reading of its
first block header, with nothing of the program under test.

RFC 1950 puts a two-byte header before the deflate data; RFC 1951 3.2.3
starts each block with BFINAL (one bit) and BTYPE (two bits), read least
significant bit first.  A stream whose first header has BFINAL 1 and
BTYPE 2 (a dynamic Huffman block) holds that block alone.
"""

from __future__ import annotations

DYNAMIC = 0b10


def first_block_header(stream: bytes) -> tuple[int, int] | None:
    """(BFINAL, BTYPE) of the stream's first block, or None when the stream
    is too short to hold one or has a preset dictionary (FDICT), which
    would put four bytes before the first block."""
    if len(stream) < 3 or stream[1] & 0x20:
        return None
    bits = stream[2]   # bit 16 of the stream: the first block's header
    return bits & 1, (bits >> 1) & 0b11


def is_single_dynamic_block(stream: bytes) -> bool:
    """True when the stream's first block is its last (BFINAL 1) and is a
    dynamic Huffman block (BTYPE 2)."""
    return first_block_header(stream) == (1, DYNAMIC)
