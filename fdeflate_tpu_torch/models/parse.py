"""Parsers: convert input bytes into symbol streams (literal runs + backrefs).

The port's copy of ``fdeflate_tpu/models/parse.py``: the flush modes
(:17-19), ``_ParserInner`` :24, ``RleParser`` :119, ``GreedyParser`` :145
and ``LazyParser`` :194.  tests/test_torch_hostcodec.py holds the
compressors built on them to the original's bytes.

Host equivalents of the reference parse layer (src/compress/parse/):
``ParserInner`` holds the shared state and tricks — inline RLE detection that
skips hash inserts, skip-ahead acceleration when no matches are found, and a
block cut every 16384 symbols.  ``GreedyParser`` accepts matches immediately
(with backward "fizzle" extension of the follow-up probe);  ``LazyParser``
defers acceptance while a longer overlapping match may exist.
"""

from __future__ import annotations

from .bitstream import Backref, LiteralRun, write_block
from .matchfinder import Match, rle_match
from ..tables import distance_to_dist_sym

FLUSH_NONE = 0
FLUSH_SYNC = 1
FLUSH_FINISH = 2

_BLOCK_SYMBOLS = 16384


class _ParserInner:
    """Shared parser state (reference: src/compress/parse/mod.rs:17-181)."""

    def __init__(self, skip_ahead_shift: int, match_finder):
        self.match_finder = match_finder
        self.skip_ahead_shift = skip_ahead_shift
        self.symbols: list = []
        self.ip = 0
        self.last_match = 0
        self.last_block_end = 0
        self.last_index = 0

    def reset_indices(self, old_base_index: int) -> None:
        self.last_match -= old_base_index
        self.match_finder.reset_indices(old_base_index)

    def start_compress(self, data, base_index: int, start: int) -> int:
        delta = base_index - self.last_index
        self.ip -= delta
        self.last_match -= delta
        self.last_block_end = start
        self.last_index = base_index
        return delta

    def get_match(self, data, base_index: int, fizzle: bool) -> Match:
        current = int.from_bytes(data[self.ip : self.ip + 8], "little")
        if current & 0xFFFFFFFF == (current >> 8) & 0xFFFFFFFF:
            # Run of identical bytes: match it directly and skip inserting
            # the run interior into the hash tables.
            m = rle_match(data, self.last_match, self.ip)
            self.ip = m.end - 3
            return m
        anchor = self.ip if fizzle else self.last_match
        m = self.match_finder.get_and_insert(data, base_index, anchor, self.ip, current)
        if fizzle and not m.is_empty():
            # Extend backwards past the probe position ("fizzle").
            while (
                m.length < 258
                and m.start > self.last_match
                and m.start > m.distance + 1
                and data[m.start - 1] == data[m.start - m.distance - 1]
            ):
                m.length += 1
                m.start -= 1
        self.ip += 1
        return m

    def advance_to_match(self, data, base_index: int, max_ip: int) -> Match:
        while self.ip < max_ip:
            m = self.get_match(data, base_index, False)
            if not m.is_empty():
                return m
            # Skip ahead when no match has been found for a while.
            self.ip += (self.ip - self.last_match) >> self.skip_ahead_shift
        return Match()

    def advance(self, data, base_index: int, end: int) -> None:
        """Insert match-finder entries for positions up to ``end``."""
        for j in range(self.ip, min(end, max(len(data) - 8, 0))):
            v = int.from_bytes(data[j : j + 8], "little")
            self.match_finder.insert(v, base_index + j)
        self.ip = max(self.ip, end)

    def insert_match(self, base_index: int, m: Match) -> None:
        if m.start > self.last_match:
            self.symbols.append(
                LiteralRun(base_index + self.last_match, base_index + m.start)
            )
        self.symbols.append(
            Backref(m.length, m.distance, distance_to_dist_sym(m.distance))
        )
        self.last_match = m.end

    def write_block_if_ready(self, writer, data, base_index: int, flush: int) -> None:
        if len(self.symbols) >= _BLOCK_SYMBOLS:
            last_block = flush == FLUSH_FINISH and self.last_match == len(data)
            write_block(writer, data, base_index, self.symbols, last_block)
            self.symbols.clear()
            self.last_block_end = self.last_match

    def end_compress(self, writer, data, base_index: int, start: int, flush: int) -> int:
        if flush != FLUSH_NONE and (self.symbols or self.last_match < len(data)):
            self.ip = min(self.ip, len(data))
            if self.last_match < len(data):
                self.symbols.append(
                    LiteralRun(base_index + self.last_match, base_index + len(data))
                )
                self.ip = len(data)
                self.last_match = len(data)
            write_block(writer, data, base_index, self.symbols, flush == FLUSH_FINISH)
            self.symbols.clear()
            self.last_block_end = self.ip
        return self.last_block_end - start


class RleParser:
    """Distance-1 runs only (Z_RLE analogue; reference: parse/rle.rs)."""

    def __init__(self, skip_ahead_shift: int):
        from .matchfinder import NullMatchFinder

        self.inner = _ParserInner(skip_ahead_shift, NullMatchFinder())

    def reset_indices(self, old_base_index: int) -> None:
        self.inner.reset_indices(old_base_index)

    def compress(self, writer, data, base_index: int, start: int, flush: int) -> int:
        inner = self.inner
        inner.start_compress(data, base_index, start)
        lookahead = 258 if flush == FLUSH_NONE else 7
        max_ip = max(len(data) - lookahead, 0)
        while True:
            m = inner.advance_to_match(data, base_index, max_ip)
            if m.is_empty():
                break
            inner.ip = m.end
            inner.insert_match(base_index, m)
            inner.write_block_if_ready(writer, data, base_index, flush)
        return inner.end_compress(writer, data, base_index, start, flush)


class GreedyParser:
    """Accept every match immediately (levels 1-3; reference: parse/greedy.rs)."""

    def __init__(self, skip_ahead_shift: int, match_finder):
        self.inner = _ParserInner(skip_ahead_shift, match_finder)
        self.m = Match()

    def reset_indices(self, old_base_index: int) -> None:
        self.inner.reset_indices(old_base_index)

    def compress(self, writer, data, base_index: int, start: int, flush: int) -> int:
        inner = self.inner
        delta = inner.start_compress(data, base_index, start)
        if not self.m.is_empty():
            self.m.start -= delta

        lookahead = 258 + 8 if flush == FLUSH_NONE else 7
        max_ip = max(len(data) - lookahead, 0)

        while True:
            if self.m.is_empty():
                self.m = inner.advance_to_match(data, base_index, max_ip)
                if self.m.is_empty():
                    break

            inner.advance(data, base_index, self.m.end)

            # Probe the position after the match; needed either way.
            m2 = Match()
            if inner.ip < max_ip:
                m2 = inner.get_match(data, base_index, True)
            elif flush == FLUSH_NONE:
                break

            # Accept the current match unless the (backward-extended) next
            # match almost completely overlaps it.
            if m2.is_empty() or m2.start > self.m.start + 1:
                inner.insert_match(base_index, self.m)
                inner.write_block_if_ready(writer, data, base_index, flush)
                if not m2.is_empty() and m2.start < inner.last_match:
                    m2.length -= inner.last_match - m2.start
                    m2.start = inner.last_match
                    if m2.length < 4:
                        m2 = Match()
            self.m = m2

        return inner.end_compress(writer, data, base_index, start, flush)


class LazyParser:
    """Defer match acceptance while a longer overlap may exist (levels 4-7;
    reference: parse/lazy.rs)."""

    def __init__(self, skip_ahead_shift: int, max_lazy: int, match_finder):
        self.inner = _ParserInner(skip_ahead_shift, match_finder)
        self.max_lazy = max_lazy
        self.m0 = Match()
        self.m1 = Match()

    def reset_indices(self, old_base_index: int) -> None:
        self.inner.reset_indices(old_base_index)

    def compress(self, writer, data, base_index: int, start: int, flush: int) -> int:
        inner = self.inner
        delta = inner.start_compress(data, base_index, start)
        if not self.m0.is_empty():
            self.m0.start -= delta
        if not self.m1.is_empty():
            self.m1.start -= delta

        lookahead = 258 + 8 if flush == FLUSH_NONE else 7
        max_ip = max(len(data) - lookahead, 0)

        while True:
            if self.m1.is_empty():
                self.m1 = inner.advance_to_match(data, base_index, max_ip)
                if self.m1.is_empty():
                    break

            m2 = Match()
            if self.m1.length <= self.max_lazy:
                if inner.ip < max_ip:
                    value = int.from_bytes(data[inner.ip : inner.ip + 8], "little")
                    m2 = inner.match_finder.get_and_insert_lazy(
                        data,
                        base_index,
                        inner.last_match,
                        inner.ip,
                        value,
                        self.m1.length + 1,
                    )
                    inner.ip += 1
                    if m2.length <= self.m1.length:
                        m2 = Match()
                elif flush == FLUSH_NONE:
                    break

            if m2.is_empty():
                inner.advance(data, base_index, self.m1.end)
                # Emit a deferred non-overlapping prefix match first.
                if not self.m0.is_empty() and self.m0.start + 4 <= self.m1.start:
                    self.m0.length = min(
                        self.m0.length, self.m1.start - self.m0.start
                    )
                    inner.insert_match(base_index, self.m0)
                    self.m0 = Match()
                inner.insert_match(base_index, self.m1)
                self.m0 = Match()
                self.m1 = Match()
                continue
            elif m2.start <= self.m1.start:
                self.m1 = m2
                continue
            else:
                if (
                    self.m0.is_empty()
                    or self.m1.start < self.m0.start
                    or (
                        self.m1.start == self.m0.start
                        and self.m1.length > self.m0.length
                    )
                ):
                    self.m0 = self.m1
                self.m1 = m2

            inner.write_block_if_ready(writer, data, base_index, flush)

        return inner.end_compress(writer, data, base_index, start, flush)
