"""Streaming zlib/DEFLATE decompressor (host orchestration layer).

The port's copy of ``fdeflate_tpu/models/decompressor.py``: ``_BitBuffer``
:60, ``Decompressor`` :95, ``decompress_to_vec`` :582,
``decompress_to_vec_bounded`` :587 and ``_decompress_to_vec_python``
:626.  tests/test_torch_hostcodec.py holds the (consumed, produced)
sequence, output and error class of ``read`` to the original's on the
fuzz corpus at several chunkings.

This is the reference decoder: a resumable state machine with the exact
``read(input, output, output_position)`` contract of the reference
Decompressor (src/decompress.rs:96-337):

* returns ``(consumed, produced)``; postcondition: input fully consumed, or
  output full, or the stream is done;
* the output buffer doubles as the 32 KiB back-reference window, so callers
  must keep decompressed history in ``output``;
* interrupted RLE/back-reference copies resume via a queued-output carry
  (src/decompress.rs:194-219, 1066-1070);
* results are chunking-insensitive: decoding whole vs byte-by-byte yields
  identical results (src/decompress.rs:1331-1384).

It always uses the reference's *careful loop* semantics
(src/decompress.rs:832-1007), one symbol at a time with full bounds
checks, which makes chunking-insensitivity hold by construction.  The
throughput paths are whole-buffer decodes: the native C++ kernel, or the
card's batch decoder (``parallel/discovery.decompress_batch``: K5, K4 and
K7), both held to this implementation.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from .. import errors as E
from ..huffman import FIXED_DIST_TABLE, FIXED_LITLEN_TABLE, build_table
from ..parallel import discovery
from ..tables import (
    CLCL_ORDER,
    DEFAULT_DIST_TABLE_SIZE,
    DEFAULT_LITLEN_TABLE_SIZE,
    DIST_SYM_TO_DIST_BASE,
    DIST_SYM_TO_DIST_EXTRA,
    DISTANCE_TABLE_ENTRIES,
    EXCEPTIONAL_ENTRY,
    LEN_SYM_TO_LEN_BASE,
    LEN_SYM_TO_LEN_EXTRA,
    LITERAL_ENTRY,
    LITLEN_TABLE_ENTRIES,
    SECONDARY_TABLE_ENTRY,
)
from . import native

_M64 = (1 << 64) - 1

# Decoder states (reference: src/decompress.rs:83-93).
_ZLIB_HEADER = 0
_BLOCK_HEADER = 1
_CODE_LENGTH_CODES = 2
_CODE_LENGTHS = 3
_COMPRESSED_DATA = 4
_UNCOMPRESSED_DATA = 5
_CHECKSUM = 6
_DONE = 7


class _BitBuffer:
    """LSB-first 64-bit bit buffer (reference: src/decompress.rs:1021-1064)."""

    __slots__ = ("buffer", "nbits")

    def __init__(self):
        self.buffer = 0
        self.nbits = 0

    def fill(self, data, pos: int) -> int:
        """Refill from ``data[pos:]``; returns the new position."""
        avail = len(data) - pos
        if avail >= 8:
            bits = self.nbits & 63
            word = int.from_bytes(data[pos : pos + 8], "little")
            self.buffer = (self.buffer | (word << bits)) & _M64
            pos += (63 - bits) >> 3
            self.nbits = bits | 56
        else:
            nbytes = min(avail, (63 - self.nbits) >> 3)
            if nbytes:
                word = int.from_bytes(data[pos : pos + nbytes], "little")
                self.buffer = (self.buffer | (word << self.nbits)) & _M64
                self.nbits += nbytes * 8
                pos += nbytes
        return pos

    def peek(self, nbits: int) -> int:
        return self.buffer & ((1 << nbits) - 1)

    def consume(self, nbits: int) -> None:
        self.buffer >>= nbits
        self.nbits -= nbits


class Decompressor:
    """Decompressor for arbitrary zlib streams (streaming, resumable)."""

    def __init__(self):
        self._bits = _BitBuffer()
        self._state = _ZLIB_HEADER
        self._last_block = False
        self._fixed_table = False
        self._ignore_adler32 = False
        self._checksum = 1  # running adler32 value

        # Queued output carried across read() calls: ("rle", byte, length) or
        # ("backref", dist, length); None when empty.
        self._queued: tuple[str, int, int] | None = None

        # Compressed-block decode tables.
        self._litlen_table = np.zeros(DEFAULT_LITLEN_TABLE_SIZE, np.uint32)
        self._secondary = np.zeros(0, np.uint16)
        self._dist_table = np.zeros(DEFAULT_DIST_TABLE_SIZE, np.uint32)
        self._dist_secondary = np.zeros(0, np.uint16)
        self._eof_code = 0
        self._eof_mask = 0
        self._eof_bits = 0

        # Block-header parsing state.
        self._hlit = 0
        self._hdist = 0
        self._hclen = 0
        self._num_lengths_read = 0
        self._cl_table = np.zeros(128, np.uint32)
        self._code_lengths = np.zeros(320, np.int64)

        self._uncompressed_bytes_left = 0

    # ------------------------------------------------------------------ API

    def ignore_adler32(self) -> None:
        """Skip verification of the checksum at the end of the stream."""
        self._ignore_adler32 = True

    def is_done(self) -> bool:
        """True once the stream (including the checksum) is fully decoded."""
        return self._state == _DONE

    def read(self, input: bytes, output, output_position: int):
        """Decompress a chunk; see the module docstring for the contract."""
        if self._state == _DONE:
            return 0, 0
        if output_position > len(output):
            raise IndexError("output_position out of bounds")

        data = input
        pos = 0
        out_len = len(output)
        idx = output_position

        # Drain queued output from an interrupted copy.
        if self._queued is not None:
            kind, a, length = self._queued
            self._queued = None
            n = min(length, out_len - idx)
            if kind == "rle":
                output[idx : idx + n] = bytes([a]) * n
            else:  # backref
                self._copy_backref(output, idx, a, n)
            idx += n
            if length - n > 0:
                self._queued = (kind, a, length - n)
                return 0, n

        last_state = None
        while last_state != self._state:
            last_state = self._state
            if self._state == _ZLIB_HEADER:
                pos = self._bits.fill(data, pos)
                if self._bits.nbits < 16:
                    break
                cmf = self._bits.peek(8)
                flg = (self._bits.peek(16) >> 8) & 0xFF
                if (
                    cmf & 0x0F != 0x08
                    or (cmf & 0xF0) > 0x70
                    or flg & 0x20 != 0
                    or ((cmf << 8) | flg) % 31 != 0
                ):
                    raise E.BadZlibHeader()
                self._bits.consume(16)
                self._state = _BLOCK_HEADER
            elif self._state == _BLOCK_HEADER:
                pos = self._read_block_header(data, pos)
            elif self._state == _CODE_LENGTH_CODES:
                pos = self._read_code_length_codes(data, pos)
            elif self._state == _CODE_LENGTHS:
                pos = self._read_code_lengths(data, pos)
            elif self._state == _COMPRESSED_DATA:
                pos, idx, end_of_block = self._read_compressed(
                    data, pos, output, idx, out_len
                )
                if end_of_block:
                    self._state = _CHECKSUM if self._last_block else _BLOCK_HEADER
            elif self._state == _UNCOMPRESSED_DATA:
                # Drain whole bytes buffered in the bit buffer first.
                while (
                    self._bits.nbits > 0
                    and self._uncompressed_bytes_left > 0
                    and idx < out_len
                ):
                    output[idx] = self._bits.peek(8)
                    self._bits.consume(8)
                    idx += 1
                    self._uncompressed_bytes_left -= 1
                if self._bits.nbits == 0:
                    self._bits.buffer = 0

                copy = min(
                    self._uncompressed_bytes_left, len(data) - pos, out_len - idx
                )
                output[idx : idx + copy] = data[pos : pos + copy]
                pos += copy
                idx += copy
                self._uncompressed_bytes_left -= copy
                if self._uncompressed_bytes_left == 0:
                    self._state = _CHECKSUM if self._last_block else _BLOCK_HEADER
            elif self._state == _CHECKSUM:
                pos = self._bits.fill(data, pos)
                align_bits = self._bits.nbits % 8
                if self._bits.nbits >= 32 + align_bits:
                    self._checksum = zlib.adler32(
                        bytes(output[output_position:idx]), self._checksum
                    )
                    if align_bits:
                        self._bits.consume(align_bits)
                    stored = int.from_bytes(
                        self._bits.peek(32).to_bytes(4, "little"), "big"
                    )
                    if not self._ignore_adler32 and stored != self._checksum:
                        raise E.WrongChecksum()
                    self._state = _DONE
                    self._bits.consume(32)
                    break

        if not self._ignore_adler32 and self._state != _DONE:
            self._checksum = zlib.adler32(
                bytes(output[output_position:idx]), self._checksum
            )

        return pos, idx - output_position

    # ------------------------------------------------------- header parsing

    def _read_block_header(self, data, pos: int) -> int:
        pos = self._bits.fill(data, pos)
        bits = self._bits
        if bits.nbits < 10:
            return pos

        start = bits.peek(3)
        self._last_block = bool(start & 1)
        btype = start >> 1
        if btype == 0b00:  # stored
            align_bits = (bits.nbits - 3) % 8
            header_bits = 3 + 32 + align_bits
            if bits.nbits < header_bits:
                return pos
            length = (bits.peek(align_bits + 19) >> (align_bits + 3)) & 0xFFFF
            nlen = (bits.peek(header_bits) >> (align_bits + 19)) & 0xFFFF
            if nlen != (~length & 0xFFFF):
                raise E.InvalidUncompressedBlockLength()
            self._state = _UNCOMPRESSED_DATA
            self._uncompressed_bytes_left = length
            bits.consume(header_bits)
            return pos
        if btype == 0b01:  # fixed
            bits.consume(3)
            # Empty fixed blocks ("partial flushes"): EOF is 7 zero bits.
            if bits.peek(7) == 0:
                bits.consume(7)
                if self._last_block:
                    self._state = _CHECKSUM
                    return pos
                while bits.nbits >= 10 and bits.peek(10) == 0b010:
                    bits.consume(10)
                    pos = bits.fill(data, pos)
                return self._read_block_header(data, pos)
            if not self._fixed_table:
                self._fixed_table = True
                reps = DEFAULT_LITLEN_TABLE_SIZE // 512
                self._litlen_table = np.tile(FIXED_LITLEN_TABLE, reps)
                self._dist_table = np.tile(
                    FIXED_DIST_TABLE, DEFAULT_DIST_TABLE_SIZE // 32
                )
                self._secondary = np.zeros(0, np.uint16)
                self._dist_secondary = np.zeros(0, np.uint16)
                self._eof_bits = 7
                self._eof_code = 0
                self._eof_mask = 0x7F
            self._state = _COMPRESSED_DATA
            return pos
        if btype == 0b10:  # dynamic
            if bits.nbits < 17:
                return pos
            self._hlit = (bits.peek(8) >> 3) + 257
            self._hdist = (bits.peek(13) >> 8) + 1
            self._hclen = (bits.peek(17) >> 13) + 4
            if self._hlit > 286:
                raise E.InvalidHlit()
            if self._hdist > 30:
                raise E.InvalidHdist()
            bits.consume(17)
            self._state = _CODE_LENGTH_CODES
            self._fixed_table = False
            return pos
        raise E.InvalidBlockType()

    def _read_code_length_codes(self, data, pos: int) -> int:
        bits = self._bits
        pos = bits.fill(data, pos)
        if bits.nbits + (len(data) - pos) * 8 < 3 * self._hclen:
            return pos

        cl_lengths = np.zeros(19, np.int64)
        for i in range(self._hclen):
            cl_lengths[CLCL_ORDER[i]] = bits.peek(3)
            bits.consume(3)
            # The bit buffer holds 56..=63 bits; 19 codes need 57.
            if i == 17:
                pos = bits.fill(data, pos)

        result = build_table(
            cl_lengths, None, 128, is_distance_table=False, double_literal=False
        )
        if not result.ok:
            raise E.BadCodeLengthHuffmanTree()
        self._cl_table = result.primary

        self._state = _CODE_LENGTHS
        self._num_lengths_read = 0
        return pos

    def _read_code_lengths(self, data, pos: int) -> int:
        bits = self._bits
        total = self._hlit + self._hdist
        lengths = self._code_lengths
        while self._num_lengths_read < total:
            pos = bits.fill(data, pos)
            if bits.nbits < 7:
                return pos
            entry = int(self._cl_table[bits.peek(7)])
            length = entry & 0x7
            symbol = (entry >> 16) & 0xFF
            if symbol <= 15:
                lengths[self._num_lengths_read] = symbol
                self._num_lengths_read += 1
                bits.consume(length)
            else:
                if symbol == 16:
                    base_repeat, extra_bits = 3, 2
                elif symbol == 17:
                    base_repeat, extra_bits = 3, 3
                else:
                    base_repeat, extra_bits = 11, 7
                if bits.nbits < length + extra_bits:
                    return pos
                if symbol == 16:
                    if self._num_lengths_read == 0:
                        raise E.InvalidCodeLengthRepeat()
                    value = lengths[self._num_lengths_read - 1]
                else:
                    value = 0
                repeat = (bits.peek(length + extra_bits) >> length) + base_repeat
                if self._num_lengths_read + repeat > total:
                    raise E.InvalidCodeLengthRepeat()
                lengths[
                    self._num_lengths_read : self._num_lengths_read + repeat
                ] = value
                self._num_lengths_read += repeat
                bits.consume(length + extra_bits)

        # Move distance lengths to 288.. and zero-pad both alphabets.  The
        # source and destination ranges can overlap, hence the copy.
        lengths[288 : 288 + self._hdist] = lengths[self._hlit : total].copy()
        lengths[self._hlit : 288] = 0
        lengths[288 + self._hdist : 320] = 0

        self._build_tables(self._hlit, lengths)
        self._state = _COMPRESSED_DATA
        return pos

    def _build_tables(self, hlit: int, code_lengths: np.ndarray) -> None:
        # A stream without an EOF code is invalid.
        if code_lengths[256] == 0:
            raise E.BadLiteralLengthHuffmanTree()

        litlen = build_table(
            code_lengths[:hlit],
            LITLEN_TABLE_ENTRIES,
            DEFAULT_LITLEN_TABLE_SIZE,
            is_distance_table=False,
            double_literal=True,
        )
        if not litlen.ok:
            # Matches the reference's (surprising) choice of error variant
            # for an invalid litlen tree (src/decompress.rs:570-580).
            raise E.BadCodeLengthHuffmanTree()
        self._litlen_table = litlen.primary
        self._secondary = litlen.secondary
        eof_len = int(code_lengths[256])
        self._eof_code = int(litlen.codes[256])
        self._eof_mask = (1 << eof_len) - 1
        self._eof_bits = eof_len

        dist_lengths = code_lengths[288:320]
        if not dist_lengths.any():
            self._dist_table = np.zeros(DEFAULT_DIST_TABLE_SIZE, np.uint32)
            self._dist_secondary = np.zeros(0, np.uint16)
        else:
            dist = build_table(
                dist_lengths,
                DISTANCE_TABLE_ENTRIES,
                DEFAULT_DIST_TABLE_SIZE,
                is_distance_table=True,
                double_literal=False,
            )
            if not dist.ok:
                raise E.BadDistanceHuffmanTree()
            self._dist_table = dist.primary
            self._dist_secondary = dist.secondary

    # ------------------------------------------------------ compressed data

    def _read_compressed(self, data, pos: int, output, idx: int, out_len: int):
        """Decode symbols until out of input bits, output space, or block end.

        Careful-loop semantics (reference: src/decompress.rs:832-1007): every
        step re-validates bit availability, so behavior cannot depend on how
        the input was chunked.
        """
        bits = self._bits
        litlen_table = self._litlen_table
        dist_table = self._dist_table
        litlen_bits = DEFAULT_LITLEN_TABLE_SIZE.bit_length() - 1
        dist_bits = DEFAULT_DIST_TABLE_SIZE.bit_length() - 1
        litlen_mask = DEFAULT_LITLEN_TABLE_SIZE - 1
        dist_mask = DEFAULT_DIST_TABLE_SIZE - 1

        while True:
            pos = bits.fill(data, pos)
            if idx == out_len:
                break

            stream = bits.buffer
            entry = int(litlen_table[stream & litlen_mask])
            code_bits = entry & 0xFF

            if entry & LITERAL_ENTRY:
                advance = (entry >> 8) & 0xF
                if bits.nbits < code_bits:
                    break
                if idx + advance <= out_len:
                    output[idx] = (entry >> 16) & 0xFF
                    if advance == 2:
                        output[idx + 1] = (entry >> 24) & 0xFF
                    idx += advance
                    bits.consume(code_bits)
                    continue
                # advance == 2 with exactly one byte of room: emit the first
                # byte now, queue the second.
                output[idx] = (entry >> 16) & 0xFF
                self._queued = ("rle", (entry >> 24) & 0xFF, 1)
                idx += 1
                bits.consume(code_bits)
                break

            # 13+ bit literal, back-reference, or EOF.
            if not entry & EXCEPTIONAL_ENTRY:
                length_base = entry >> 16
                length_extra_bits = (entry >> 8) & 0xFF
            elif entry & SECONDARY_TABLE_ENTRY:
                sec_index = (entry >> 16) + (
                    (stream >> litlen_bits) & (entry & 0xFF)
                )
                sec_entry = int(self._secondary[sec_index])
                symbol = sec_entry >> 4
                code_bits = sec_entry & 0xF
                if bits.nbits < code_bits:
                    break
                if symbol < 256:
                    bits.consume(code_bits)
                    output[idx] = symbol
                    idx += 1
                    continue
                if symbol == 256:
                    bits.consume(code_bits)
                    return pos, idx, True
                length_base = int(LEN_SYM_TO_LEN_BASE[symbol - 257])
                length_extra_bits = int(LEN_SYM_TO_LEN_EXTRA[symbol - 257])
            elif code_bits == 0:
                raise E.InvalidLiteralLengthCode()
            else:
                if bits.nbits < code_bits:
                    break
                bits.consume(code_bits)
                return pos, idx, True

            stream >>= code_bits
            length = length_base + (stream & ((1 << length_extra_bits) - 1))
            stream >>= length_extra_bits

            dist_entry = int(dist_table[stream & dist_mask])
            if dist_entry & LITERAL_ENTRY:
                dist_base = dist_entry >> 16
                dist_extra_bits = (dist_entry >> 8) & 0xF
                dist_code_bits = dist_entry & 0xFF
            elif bits.nbits > code_bits + length_extra_bits + dist_bits:
                if dist_entry >> 8 == 0:
                    raise E.InvalidDistanceCode()
                sec_index = (dist_entry >> 16) + (
                    (stream >> dist_bits) & (dist_entry & 0xFF)
                )
                sec_entry = int(self._dist_secondary[sec_index])
                dist_sym = sec_entry >> 4
                if dist_sym >= 30:
                    raise E.InvalidDistanceCode()
                dist_base = int(DIST_SYM_TO_DIST_BASE[dist_sym])
                dist_extra_bits = int(DIST_SYM_TO_DIST_EXTRA[dist_sym])
                dist_code_bits = sec_entry & 0xF
            else:
                break
            stream >>= dist_code_bits

            dist = dist_base + (stream & ((1 << dist_extra_bits) - 1))
            total_bits = (
                code_bits + length_extra_bits + dist_code_bits + dist_extra_bits
            )
            if bits.nbits < total_bits:
                break
            if dist > idx:
                raise E.DistanceTooFarBack()
            bits.consume(total_bits)

            copy_length = min(length, out_len - idx)
            if dist == 1:
                output[idx : idx + copy_length] = (
                    bytes([output[idx - 1]]) * copy_length
                )
            else:
                self._copy_backref(output, idx, dist, copy_length)
            if length > copy_length:
                kind = "rle" if dist == 1 else "backref"
                carry = output[idx - 1] if dist == 1 else dist
                self._queued = (kind, carry, length - copy_length)
                idx = out_len
                break
            idx += copy_length

        # A complete block may end exactly when the output fills; peek for the
        # EOF code so such streams can still finish (src/decompress.rs:1009).
        if (
            self._queued is None
            and bits.nbits >= 15
            and bits.peek(15) & self._eof_mask == self._eof_code
        ):
            bits.consume(self._eof_bits)
            return pos, idx, True

        return pos, idx, False

    @staticmethod
    def _copy_backref(output, idx: int, dist: int, n: int) -> None:
        """Copy ``n`` bytes from ``idx - dist``, replicating when overlapping."""
        if n <= 0:
            return
        if dist >= n:
            output[idx : idx + n] = output[idx - dist : idx - dist + n]
            return
        # Overlapping: double the copied span each step.
        src = idx - dist
        copied = dist
        output[idx : idx + dist] = output[src:idx]
        while copied < n:
            chunk = min(copied, n - copied)
            output[idx + copied : idx + copied + chunk] = output[
                idx : idx + chunk
            ]
            copied += chunk


# Smallest input that takes the card's batch decoder when the native
# backend is unavailable (JAX's ``1 << 18``, models/decompressor.py:607).
_DEVICE_ROUTE_MIN = 1 << 18


def decompress_to_vec(input: bytes, *, device="cuda") -> bytes:
    """Decompress a complete zlib stream (reference: src/decompress.rs:1079)."""
    return decompress_to_vec_bounded(input, None, device=device)


def decompress_to_vec_bounded(input: bytes, maxlen: int | None, *,
                              device="cuda") -> bytes:
    """Decompress with an output size bound.

    Raises ``errors.OutputTooLarge`` (carrying the partial output) if the
    output would exceed ``maxlen``.  Reference: src/decompress.rs:1111-1144.

    Whole-buffer decodes go to the native C++ kernel when it is available.
    Without it, inputs of ``_DEVICE_ROUTE_MIN`` bytes or more (unless
    ``FDEFLATE_TPU_NO_DEVICE=1``) go to the batch decoder on ``device``
    (``parallel/discovery.decompress_batch``: K5, K4 and K7 on the card,
    their plain versions for "cpu"); without CUDA, the default device
    raises RuntimeError.  An exception the batch decoder raises propagates.
    A decode error it returns for the stream sends the stream to the
    Python state machine, which alone decides the error class and partial
    output of malformed streams; it also decodes all other inputs.
    """
    if native.available():
        return native.inflate(input, maxlen=maxlen)
    if (len(input) >= _DEVICE_ROUTE_MIN
            and os.environ.get("FDEFLATE_TPU_NO_DEVICE") != "1"):
        r = discovery.decompress_batch([input], device=device)[0]
        if isinstance(r, bytes):
            if maxlen is not None and len(r) > maxlen:
                raise E.OutputTooLarge(bytes(r[:maxlen]))
            return r
    return _decompress_to_vec_python(input, maxlen)


def _decompress_to_vec_python(input: bytes, maxlen: int | None) -> bytes:
    bound = maxlen if maxlen is not None else (1 << 63)
    decoder = Decompressor()
    output = bytearray(min(1024, bound))
    input_index = 0
    output_index = 0
    while True:
        consumed, produced = decoder.read(input[input_index:], output, output_index)
        input_index += consumed
        output_index += produced
        if decoder.is_done():
            break
        if output_index == bound:
            raise E.OutputTooLarge(bytes(output))
        if output_index == len(output):
            output.extend(bytearray(min(output_index + 32 * 1024, bound) - len(output)))
            continue
        if input_index == len(input):
            raise E.InsufficientInput()
        raise AssertionError("read() violated its post-condition")
    return bytes(output[:output_index])
