"""Compressor orchestration: levels 0-9, zlib framing, streaming windows.

The port's copy of ``fdeflate_tpu/models/compressor.py``: ``_make_parser``
:53, ``Compressor`` :69 (with ``new_rle`` and level 0's stored blocks),
``compress_to_vec`` :207, ``compress_to_vec_with_level`` :212,
``_compress_to_vec_with_level_python`` :222 and ``compress_to_vec_rle``
:228.  tests/test_torch_hostcodec.py holds every level's bytes, streamed
and one-shot, on the Python and the native path, to the original's.

Equivalent of the reference's Compressor (src/compress/mod.rs): maps each
compression level to a (parser, match-finder) configuration, buffers a 32 KiB
window across ``write_data`` calls, splits stored blocks at 65535 bytes, and
writes the zlib header/Adler-32 framing.

Level map (reference: src/compress/mod.rs:75-88):

  0    stored blocks only
  1    greedy + single-probe hash table (min match 8)
  2    greedy + hash chains(8, 16, 64)
  3    greedy + hash chains(6, 16, 32)
  4    lazy + hybrid(5, 16, 32),  max_lazy 12
  5    lazy + hybrid(5, 64, 64),  max_lazy 16
  6    lazy + hybrid(4, 128, 128), max_lazy 16
  7+   lazy + hybrid(4, 256, 258), max_lazy 256
"""

from __future__ import annotations

import zlib

from ..ops.bitio import BitWriter
from . import native
from .matchfinder import (
    HashChainMatchFinder,
    HashTableMatchFinder,
    HybridMatchFinder,
)
from .parse import (
    FLUSH_FINISH,
    FLUSH_NONE,
    FLUSH_SYNC,
    GreedyParser,
    LazyParser,
    RleParser,
)
from .ultrafast import UltraFastCompressor, compress_to_vec_ultra_fast

STORED_BLOCK_MAX_SIZE = 65535
WINDOW_SIZE = 32768

__all__ = [
    "Compressor",
    "UltraFastCompressor",
    "compress_to_vec",
    "compress_to_vec_with_level",
    "compress_to_vec_rle",
    "compress_to_vec_ultra_fast",
]


def _make_parser(level: int):
    if level == 1:
        return GreedyParser(5, HashTableMatchFinder())
    if level == 2:
        return GreedyParser(6, HashChainMatchFinder(8, 16, 64))
    if level == 3:
        return GreedyParser(6, HashChainMatchFinder(6, 16, 32))
    if level == 4:
        return LazyParser(9, 12, HybridMatchFinder(5, 16, 32))
    if level == 5:
        return LazyParser(9, 16, HybridMatchFinder(5, 64, 64))
    if level == 6:
        return LazyParser(9, 16, HybridMatchFinder(4, 128, 128))
    return LazyParser(12, 256, HybridMatchFinder(4, 256, 258))


class Compressor:
    """Streaming compressor producing zlib or raw deflate output.

    ``sink`` may be a bytearray or any object with a ``write`` method (the
    reference's ``W: Write`` parameter); with a writer, compressed bytes
    stream out on every ``write_data``/``flush`` call and ``finish`` returns
    the writer.
    """

    def __init__(self, sink=None, level: int = 1, zlib_mode: bool = True):
        self._writer_obj = None
        if sink is not None and not isinstance(sink, bytearray):
            self._writer_obj = sink
            sink = bytearray()
        self.sink = sink if sink is not None else bytearray()
        if zlib_mode:
            self.sink += b"\x78\x01"
        self._writer = BitWriter(self.sink)
        self._level = level
        self._parser = None if level == 0 else _make_parser(level)
        self._window_size = 0 if level == 0 else WINDOW_SIZE
        self._checksum = 1 if zlib_mode else None
        self._zlib = zlib_mode
        # Buffered input with its absolute base index.
        self._data = bytearray()
        self._base_index = 0
        self._written = 0

    @classmethod
    def new_rle(cls, sink: bytearray | None = None, zlib_mode: bool = True) -> "Compressor":
        """RLE-only compressor (Z_RLE analogue; reference: src/compress/mod.rs:107-123)."""
        self = cls(sink, 0, zlib_mode)
        self._parser = RleParser(5)
        self._level = -1
        self._window_size = 1
        return self

    # --------------------------------------------------------------- write

    def write_data(self, data) -> None:
        data = bytes(data)
        # Bound per-call work so indices stay well-behaved (the reference
        # chunks at 1 GiB for u32 indices; src/compress/mod.rs:126-135).
        CHUNK = 1 << 30
        for off in range(0, max(len(data), 1), CHUNK):
            self._write_chunk(data[off : off + CHUNK])
        self._drain()

    def _write_chunk(self, data: bytes) -> None:
        if self._checksum is not None:
            self._checksum = zlib.adler32(data, self._checksum)

        if not self._data:
            written = self._compress(data, self._base_index, 0, FLUSH_NONE)
            start = max(written - self._window_size, 0)
            self._data += data[start:]
            self._base_index += start
            self._written = written - start
            return

        self._data += data
        written = self._compress(
            bytes(self._data), self._base_index, self._written, FLUSH_NONE
        )
        self._written += written

        # Discard history before the window start, with hysteresis.
        discard = max(self._written - self._window_size, 0)
        if discard > 128 * 1024:
            del self._data[:discard]
            self._base_index += discard
            self._written -= discard

    def flush(self) -> None:
        """Sync flush: emit pending symbols plus an empty stored block."""
        written = self._compress(
            bytes(self._data), self._base_index, self._written, FLUSH_SYNC
        )
        self._written += written
        self._drain()

    def finish(self):
        """Write the remainder of the stream and return the sink/writer."""
        self._compress(bytes(self._data), self._base_index, self._written, FLUSH_FINISH)
        self._data.clear()
        self._writer.flush()
        if self._checksum is not None:
            self.sink += self._checksum.to_bytes(4, "big")
        if self._writer_obj is not None:
            self._drain()
            return self._writer_obj
        return self.sink

    def _drain(self) -> None:
        """Stream completed whole bytes out to a file-like sink."""
        if self._writer_obj is not None and self.sink:
            self._writer_obj.write(bytes(self.sink))
            del self.sink[:]

    # ------------------------------------------------------------ internals

    def _compress(self, data: bytes, base_index: int, start: int, flush: int) -> int:
        writer = self._writer
        if flush == FLUSH_FINISH and len(data) == start:
            # Empty final block: 10-bit fixed-Huffman empty block.
            writer.write_bits(3, 10)
            writer.flush()
            return 0

        if self._parser is None:  # level 0: stored blocks
            written = 0
            pos = start
            while len(data) - pos > STORED_BLOCK_MAX_SIZE:
                writer.write_bits(0, 3)
                writer.flush()
                self.sink += b"\xff\xff\x00\x00"
                self.sink += data[pos : pos + STORED_BLOCK_MAX_SIZE]
                pos += STORED_BLOCK_MAX_SIZE
                written += STORED_BLOCK_MAX_SIZE
            remaining = len(data) - pos
            if remaining == STORED_BLOCK_MAX_SIZE or flush != FLUSH_NONE:
                writer.write_bits(1 if flush == FLUSH_FINISH else 0, 3)
                writer.flush()
                self.sink += remaining.to_bytes(2, "little")
                self.sink += (~remaining & 0xFFFF).to_bytes(2, "little")
                self.sink += data[pos:]
                written += remaining
        else:
            written = self._parser.compress(writer, data, base_index, start, flush)

        if flush == FLUSH_SYNC:
            writer.write_bits(0, 3)
            writer.flush()
            self.sink += b"\x00\x00\xff\xff"

        return written


def compress_to_vec(data) -> bytes:
    """Compress at the default level (1)."""
    return compress_to_vec_with_level(data, 1)


def compress_to_vec_with_level(data, level: int) -> bytes:
    """One-shot compression; dispatches to the native C++ kernel when
    available, with the streaming Python Compressor as fallback/oracle."""
    if native.available():
        return native.deflate(bytes(data), level)
    return _compress_to_vec_with_level_python(data, level)


def _compress_to_vec_with_level_python(data, level: int) -> bytes:
    c = Compressor(level=level)
    c.write_data(data)
    return bytes(c.finish())


def compress_to_vec_rle(data) -> bytes:
    """Compress using only distance-1 run matches."""
    c = Compressor.new_rle()
    c.write_data(data)
    return bytes(c.finish())
