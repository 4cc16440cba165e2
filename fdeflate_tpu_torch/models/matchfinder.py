"""LZ77 match finders.

The port's copy of ``fdeflate_tpu/models/matchfinder.py`` (numpy only):
``Match`` :24, ``compute_hash`` :45, ``match_length`` :53,
``rle_match`` :97, ``NullMatchFinder`` :116, ``HashTableMatchFinder``
:129, ``HashChainMatchFinder`` :159 and ``HybridMatchFinder`` :216.
tests/test_torch_hostcodec.py holds the compressors built on them to the
original's bytes.

Host equivalents of the reference's four finders
(src/compress/matchfinder/): single-probe hash table, hash chains, and the
hybrid chain+hash4 finder, sharing Fibonacci hashing, backward/forward match
extension, and the 32 KiB window clamp.  The native C++ backend
(native/, loaded by ``models/native.py``) supersedes these for
throughput; these remain the readable reference implementations.
"""

from __future__ import annotations

import numpy as np

WINDOW_SIZE = 32768
CACHE_SIZE = 1 << 16
_HASH_MUL = 0x9E3779B97F4A7C15  # Fibonacci hashing (matchfinder/mod.rs:42-44)
_M64 = (1 << 64) - 1


class Match:
    """A back-reference candidate; ``length == 0`` means no match."""

    __slots__ = ("length", "distance", "start")

    def __init__(self, length: int = 0, distance: int = 0, start: int = 0):
        self.length = length
        self.distance = distance
        self.start = start

    def is_empty(self) -> bool:
        return self.length == 0

    @property
    def end(self) -> int:
        return self.start + self.length

    def __repr__(self):
        return f"Match(len={self.length}, dist={self.distance}, start={self.start})"


def compute_hash(v: int) -> int:
    return ((v * _HASH_MUL) & _M64) >> 40


def _read8(data, i: int) -> int:
    return int.from_bytes(data[i : i + 8], "little")


def match_length(
    data, anchor: int, ip: int, prev_index: int, min_match8: bool, value: int
) -> tuple[int, int]:
    """Length and start of the match between ``ip`` and ``prev_index``.

    Verifies a 4-byte (or 8-byte) prefix, then extends backwards to the
    anchor and forwards up to 258 bytes
    (reference: src/compress/matchfinder/mod.rs:51-110).
    """
    prev = _read8(data, prev_index)
    if min_match8:
        if value != prev:
            return 0, ip
        length = 8
    else:
        if value & 0xFFFFFFFF != prev & 0xFFFFFFFF:
            return 0, ip
        length = _trailing_zero_bytes(value ^ prev)

    while length < 258 and ip > anchor and prev_index > 0 and data[ip - 1] == data[prev_index - 1]:
        length += 1
        ip -= 1
        prev_index -= 1

    limit = min(len(data) - ip, 258)
    while length + 8 <= limit:
        a = _read8(data, ip + length)
        b = _read8(data, prev_index + length)
        if a == b:
            length += 8
        else:
            length += _trailing_zero_bytes(a ^ b)
            return min(length, limit), ip
    while length < limit and data[ip + length] == data[prev_index + length]:
        length += 1
    return length, ip


def _trailing_zero_bytes(x: int) -> int:
    if x == 0:
        return 8
    return ((x & -x).bit_length() - 1) // 8


def rle_match(data, last_match: int, ip: int) -> Match:
    """Greedily match a run of identical bytes as a distance-1 reference
    (reference: src/compress/matchfinder/mod.rs:112-145)."""
    value = data[ip]
    m = Match(4, 1, ip + 1)
    min_start = max(1, last_match, m.end - 258)
    while m.start > min_start and data[m.start - 2] == value:
        m.start -= 1
        m.length += 1

    limit = min(len(data) - m.end, 258 - m.length)
    pos = m.end
    count = 0
    while count < limit and data[pos + count] == value:
        count += 1
    m.length += count
    return m


class NullMatchFinder:
    """Finds nothing; used by the RLE-only parser."""

    def get_and_insert(self, data, base_index, anchor, ip, value):
        return Match()

    def insert(self, value, offset):
        pass

    def reset_indices(self, old_base_index):
        pass


class HashTableMatchFinder:
    """Single-probe 2^16-slot hash table, minimum match length 8 (level 1).

    Reference: src/compress/matchfinder/hashtable.rs.
    """

    def __init__(self):
        self.table = np.zeros(CACHE_SIZE, dtype=np.int64)

    def get_and_insert(self, data, base_index, anchor, ip, value):
        min_offset = max(base_index + max(ip - 32768, 0), 1)
        slot = compute_hash(value) % CACHE_SIZE
        offset = int(self.table[slot])
        self.table[slot] = ip + base_index
        if offset >= min_offset:
            length, start = match_length(
                data, anchor, ip, offset - base_index, True, value
            )
            if length >= 8:
                return Match(length, ip - (offset - base_index), start)
        return Match()

    def insert(self, value, offset):
        self.table[compute_hash(value) % CACHE_SIZE] = offset

    def reset_indices(self, old_base_index):
        np.subtract(self.table, old_base_index, out=self.table)
        np.maximum(self.table, 0, out=self.table)


class HashChainMatchFinder:
    """Hash chains with bounded search depth and nice-length early exit.

    Reference: src/compress/matchfinder/hashchain.rs.
    """

    def __init__(self, min_match: int, search_depth: int, nice_length: int):
        assert 4 <= min_match <= 8
        self.table = np.zeros(CACHE_SIZE, dtype=np.int64)
        self.links = np.zeros(WINDOW_SIZE, dtype=np.int64)
        self.min_match = min_match
        self.search_depth = search_depth
        self.nice_length = nice_length
        self.mask = (1 << (8 * min_match)) - 1
        self.min_match8 = min_match == 8

    def get_and_insert(self, data, base_index, anchor, ip, value):
        min_offset = max(base_index + max(ip - 32768, 0), 1)
        best = Match()
        best_length = self.min_match - 1

        slot = compute_hash(value & self.mask) % CACHE_SIZE
        offset = int(self.table[slot])
        new_offset = ip + base_index
        self.table[slot] = new_offset
        self.links[new_offset % WINDOW_SIZE] = offset

        n = self.search_depth
        while offset >= min_offset:
            length, start = match_length(
                data, anchor, ip, offset - base_index, self.min_match8, value
            )
            if length > best_length:
                best_length = length
                best = Match(length, ip - (offset - base_index), start)
            if length >= self.nice_length or ip + length == len(data):
                break
            n -= 1
            if n == 0:
                break
            offset = int(self.links[offset % WINDOW_SIZE])

        if best_length >= self.min_match:
            return best
        return Match()

    def insert(self, value, offset):
        slot = compute_hash(value & self.mask) % CACHE_SIZE
        self.links[offset % WINDOW_SIZE] = self.table[slot]
        self.table[slot] = offset

    def reset_indices(self, old_base_index):
        for arr in (self.table, self.links):
            np.subtract(arr, old_base_index, out=arr)
            np.maximum(arr, 0, out=arr)


class HybridMatchFinder:
    """Hash chains on min_match+1 bytes plus a single-probe hash4 fallback
    (levels 4-7).  Reference: src/compress/matchfinder/hybrid.rs.
    """

    def __init__(self, min_match: int, search_depth: int, nice_length: int):
        assert 4 <= min_match <= 7
        self.table = np.zeros(CACHE_SIZE, dtype=np.int64)
        self.links = np.zeros(WINDOW_SIZE, dtype=np.int64)
        self.table4 = np.zeros(CACHE_SIZE, dtype=np.int64)
        self.min_match = min_match
        self.search_depth = search_depth
        self.nice_length = nice_length
        self.mask = (1 << (8 * min(min_match + 1, 8))) - 1
        self.mask4 = (1 << (8 * min_match)) - 1

    def _lookup(self, data, base_index, anchor, ip, value, min_match):
        min_offset = max(base_index + max(ip - 32768, 0), 1)
        best = Match()
        best_length = min_match - 1

        n = self.search_depth
        if min_match > self.min_match:
            n >>= 2

        slot4 = compute_hash(value & self.mask4) % CACHE_SIZE
        offset4 = int(self.table4[slot4])

        slot = compute_hash(value & self.mask) % CACHE_SIZE
        offset = int(self.table[slot])

        new_offset = ip + base_index
        self.table[slot] = new_offset
        self.links[new_offset % WINDOW_SIZE] = offset
        self.table4[slot4] = new_offset

        while offset >= min_offset:
            length, start = match_length(
                data, anchor, ip, offset - base_index, False, value
            )
            if length > best_length:
                best_length = length
                best = Match(length, ip - (offset - base_index), start)
            if length >= self.nice_length or ip + length == len(data):
                break
            n -= 1
            if n == 0:
                break
            offset = int(self.links[offset % WINDOW_SIZE])

        if best_length < self.min_match and offset4 > min_offset:
            length, start = match_length(
                data, anchor, ip, offset4 - base_index, False, value
            )
            best_length = length
            best = Match(length, ip - (offset4 - base_index), start)

        if best_length >= min_match:
            return best
        return Match()

    def get_and_insert(self, data, base_index, anchor, ip, value):
        return self._lookup(data, base_index, anchor, ip, value, 4)

    def get_and_insert_lazy(self, data, base_index, anchor, ip, value, min_match):
        return self._lookup(data, base_index, anchor, ip, value, min_match)

    def insert(self, value, offset):
        self.table4[compute_hash(value & self.mask4) % CACHE_SIZE] = offset
        slot = compute_hash(value & self.mask) % CACHE_SIZE
        self.links[offset % WINDOW_SIZE] = self.table[slot]
        self.table[slot] = offset

    def reset_indices(self, old_base_index):
        for arr in (self.table, self.table4, self.links):
            np.subtract(arr, old_base_index, out=arr)
            np.maximum(arr, 0, out=arr)
