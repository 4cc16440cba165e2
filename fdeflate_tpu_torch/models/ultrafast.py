"""Ultra-fast PNG-mode compressor.

The port's copy of ``fdeflate_tpu/models/ultrafast.py`` (numpy only):
``tokenize`` :54, ``UltraFastCompressor`` :165,
``compress_to_vec_ultra_fast`` :212 and
``_compress_to_vec_ultra_fast_python`` :225.  Its ``STREAM_HEADER`` and
``STREAM_HEADER_BITS`` (:40-46) are the port's copies in ``trees.py`` and
its ``pack_bits`` the one in ``ops/bitio.py``.  tests/test_torch_hostcopies.py
holds ``tokenize`` to the original on fuzzed inputs, and
tests/test_torch_hostcodec.py the streams to the original's bytes.

Produces fdeflate-style streams: exactly one dynamic-Huffman block per zlib
stream, literal codes from the corpus-trained <=12-bit tree, and zero-runs as
the only back-references (literal 0 followed by distance-1 length codes).
Reference: src/compress/ultrafast.rs.  Every byte is assigned at most one
``(code, nbits)`` token by data-parallel classification (zero-run
membership, run-relative position and 258-boundary tokens are elementwise
arithmetic), and the tokens are packed with one prefix-sum scatter
(ops/bitio.pack_bits).  The encoded-stream bytes match the reference
exactly (same segmentation rules, same canned header).
"""

from __future__ import annotations

import zlib

import numpy as np

from ..tables import (
    HUFFMAN_CODES,
    HUFFMAN_LENGTHS,
    LENGTH_TO_LEN_EXTRA,
    LENGTH_TO_SYMBOL,
)
from ..ops.bitio import pack_bits
from ..trees import STREAM_HEADER
from . import native

_CODES = HUFFMAN_CODES.astype(np.uint32)
_LENGTHS = HUFFMAN_LENGTHS.astype(np.uint8)
_LEN_TO_SYM = LENGTH_TO_SYMBOL.astype(np.int32)
_LEN_TO_EXTRA = LENGTH_TO_LEN_EXTRA.astype(np.int32)


def tokenize(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-byte (code value, bit count) token assignment for one write call.

    Implements the reference's 8-byte-chunk zero-run segmentation rules
    (src/compress/ultrafast.rs:94-167) as closed-form per-byte classification:

    * whole zero chunks are always run members;
    * zeros at the *end* of a chunk always start/extend a run;
    * zeros at the *start* of a chunk join a run only if one is active;
    * bytes past the last full chunk are always literals.

    Returns ``(values, nbits)`` arrays of length ``len(data)``; bytes that
    emit no bits have ``nbits == 0``.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    values = np.zeros(n, dtype=np.uint32)
    nbits = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return values, nbits

    # All arithmetic stays in 32-bit lanes (8x the elementwise throughput of
    # int64 on both the host and the TPU VPU).
    n8 = n // 8
    if n8:
        nonzero = data[: n8 * 8].reshape(n8, 8) != 0
        chunk_zero = ~nonzero.any(axis=1)
        # t: zero bytes at the chunk start; l: zero bytes at the chunk end.
        t = np.where(chunk_zero, 8, np.argmax(nonzero, axis=1)).astype(np.int32)
        l = np.where(chunk_zero, 8, np.argmax(nonzero[:, ::-1], axis=1)).astype(
            np.int32
        )

        # A run is active entering chunk c iff the previous chunk was all
        # zero or ended with zeros.
        prev_run = np.zeros(n8, dtype=bool)
        prev_run[1:] = chunk_zero[:-1] | (l[:-1] > 0)

        offs = np.arange(8, dtype=np.int32)
        member = (
            chunk_zero[:, None]
            | ((offs[None, :] < t[:, None]) & prev_run[:, None])
            | (offs[None, :] >= (8 - l)[:, None])
        ).reshape(-1)
    else:
        member = np.zeros(0, dtype=bool)

    na = n8 * 8
    idx = np.arange(na, dtype=np.int32)
    prev_member = np.concatenate(([False], member[:-1]))
    start_flag = member & ~prev_member
    seg_start = np.maximum.accumulate(np.where(start_flag, idx, np.int32(-1)))
    # Segment end (exclusive): next non-member position, computed by a
    # reversed minimum-accumulate over non-member indices.
    nxt = np.where(~member, idx, np.int32(na))
    seg_end = np.minimum.accumulate(nxt[::-1])[::-1]

    p = idx - seg_start
    q = p - np.int32(1)
    run1 = seg_end - seg_start - np.int32(1)  # R - 1 after the leading literal
    k = run1 // np.int32(258)
    tail = run1 - k * np.int32(258)
    q0 = k * np.int32(258)

    aligned = data[:na]
    v = np.where(member, np.uint32(0), _CODES[aligned])
    nb = np.where(member, np.uint8(0), _LENGTHS[aligned])

    # Leading literal-0 of every run.
    is_first = member & (p == 0)
    v = np.where(is_first, np.uint32(int(_CODES[0])), v)
    nb = np.where(is_first, np.uint8(int(_LENGTHS[0])), nb)

    # One (code 285 + 1-bit distance) per full 258 consumed.
    qk = q // np.int32(258)
    is_285 = member & (p > 0) & (q - qk * np.int32(258) == 257)
    v = np.where(is_285, np.uint32(int(_CODES[285])), v)
    nb = np.where(is_285, np.uint8(int(_LENGTHS[285]) + 1), nb)

    # Tail > 4: length symbol + (extra bits | 1-bit distance).
    tail_idx = np.clip(tail - 3, 0, 255)
    tail_sym = _LEN_TO_SYM[tail_idx]
    tail_extra_bits = _LEN_TO_EXTRA[tail_idx]
    big_tail = member & (tail > 4)
    at_sym = big_tail & (q == q0)
    at_extra = big_tail & (q == q0 + 1)
    v = np.where(at_sym, _CODES[tail_sym], v)
    nb = np.where(at_sym, _LENGTHS[tail_sym], nb)
    extra_val = (tail - np.int32(3)).astype(np.uint32) & (
        (np.uint32(1) << tail_extra_bits.astype(np.uint32)) - np.uint32(1)
    )
    v = np.where(at_extra, extra_val, v)
    nb = np.where(at_extra, (tail_extra_bits + 1).astype(np.uint8), nb)

    # Tail 1..4: that many literal zeros.
    small_tail = member & (tail > 0) & (tail <= 4) & (q >= q0) & (q < q0 + tail)
    v = np.where(small_tail, np.uint32(int(_CODES[0])), v)
    nb = np.where(small_tail, np.uint8(int(_LENGTHS[0])), nb)

    values[:na] = v
    nbits[:na] = nb

    # Remainder bytes are always literals.
    if na < n:
        rem = data[na:]
        values[na:] = _CODES[rem]
        nbits[na:] = _LENGTHS[rem]

    return values, nbits


class UltraFastCompressor:
    """Streaming ultra-fast compressor (single block, zero-RLE only).

    ``sink`` may be a bytearray or any object with a ``write`` method.
    """

    def __init__(self, sink=None):
        self._writer_obj = None
        if sink is not None and not isinstance(sink, bytearray):
            self._writer_obj = sink
            sink = bytearray()
        self.sink = sink if sink is not None else bytearray()
        self._checksum = 1
        self.sink += STREAM_HEADER[:53]
        self._carry_value = STREAM_HEADER[53] & 0x1F
        self._carry_bits = 5

    def write_data(self, data) -> None:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        self._checksum = zlib.adler32(arr.tobytes(), self._checksum)
        values, nbits = tokenize(arr)
        out, self._carry_value, self._carry_bits = pack_bits(
            values, nbits, self._carry_value, self._carry_bits
        )
        self.sink += out
        if self._writer_obj is not None and self.sink:
            self._writer_obj.write(bytes(self.sink))
            del self.sink[:]

    def finish(self):
        out, v, nb = pack_bits(
            np.array([int(_CODES[256])], np.uint64),
            np.array([int(_LENGTHS[256])], np.uint64),
            self._carry_value,
            self._carry_bits,
        )
        self.sink += out
        if nb:
            self.sink.append(v)  # pad to byte boundary
        self.sink += self._checksum.to_bytes(4, "big")
        if self._writer_obj is not None:
            self._writer_obj.write(bytes(self.sink))
            del self.sink[:]
            return self._writer_obj
        return self.sink


def compress_to_vec_ultra_fast(data) -> bytes:
    """One-shot ultra-fast compression (reference: src/compress/mod.rs:313-317).

    Dispatches to the native C++ kernel when available (bit-identical
    output); the numpy token pipeline is the fallback and oracle.
    """
    if native.available():
        return native.compress_ultra(bytes(data))
    return _compress_to_vec_ultra_fast_python(data)


def _compress_to_vec_ultra_fast_python(data) -> bytes:
    c = UltraFastCompressor()
    c.write_data(data)
    return bytes(c.finish())
