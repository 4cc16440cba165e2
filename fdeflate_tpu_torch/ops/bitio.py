"""Bit-level I/O on the host: a streaming bit writer and vectorized bit packing.

The port's copy of ``fdeflate_tpu/ops/bitio.py`` (numpy only):
``pack_bits`` :24, ``_sorted_scatter_or`` :73 and ``BitWriter`` :81.  The
device encoders pack on the card; this writer assembles the matched
encoder's dynamic-block header (``ops/matchscan._host_header``).
tests/test_torch_hostcopies.py holds it to the original.

``pack_bits`` places LSB-first codes at exclusive-prefix-sum positions
(``word[i] |= value << (position mod 64)``, disjoint bits) with numpy;
``BitWriter`` carries the sub-byte state across calls.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1


def pack_bits(
    values: np.ndarray,
    lengths: np.ndarray,
    carry_value: int = 0,
    carry_bits: int = 0,
) -> tuple[bytes, int, int]:
    """Pack LSB-first variable-length codes into bytes.

    ``values[i]`` holds ``lengths[i]`` (< 58) significant bits.  ``carry_*``
    is the sub-byte tail from a previous call.  Returns
    ``(packed_bytes, new_carry_value, new_carry_bits)`` with
    ``new_carry_bits < 8``.
    """
    values = np.asarray(values, dtype=np.uint64)
    lengths = np.asarray(lengths, dtype=np.int64)
    total = carry_bits + int(lengths.sum())
    if total == 0 or len(values) == 0:
        return b"", carry_value, carry_bits

    positions = carry_bits + np.concatenate(
        ([0], np.cumsum(lengths)[:-1])
    ).astype(np.int64)

    nwords = (total + 63) // 64 + 1
    words = np.zeros(nwords, dtype=np.uint64)
    words[0] = carry_value

    wi = (positions >> 6).astype(np.int64)
    sh = (positions & 63).astype(np.uint64)
    lo = values << sh  # wraps mod 2^64, which is exactly the low word part
    hi = (values >> np.uint64(1)) >> (np.uint64(63) - sh)
    # ``positions`` is monotone, so ``wi`` is sorted: scatter-OR reduces to a
    # segmented OR (reduceat), which is orders of magnitude faster than
    # ufunc.at.
    _sorted_scatter_or(words, wi, lo)
    _sorted_scatter_or(words, wi + 1, hi)

    full_bytes = total >> 3
    out = words.tobytes()[:full_bytes]
    rem_bits = total & 7
    if rem_bits:
        rem_value = (int(words[full_bytes >> 3]) >> ((full_bytes & 7) * 8)) & (
            (1 << rem_bits) - 1
        )
    else:
        rem_value = 0
    return out, rem_value, rem_bits


def _sorted_scatter_or(words: np.ndarray, wi: np.ndarray, vals: np.ndarray) -> None:
    """``words[wi] |= vals`` for a *sorted* index array ``wi``."""
    if len(vals) == 0:
        return
    starts = np.concatenate(([0], np.nonzero(np.diff(wi))[0] + 1))
    words[wi[starts]] |= np.bitwise_or.reduceat(vals, starts)


class BitWriter:
    """Streaming LSB-first bit writer over a bytearray sink.

    Semantics match the reference writer (src/compress/bitwriter.rs): bits
    accumulate little-endian-first; ``flush`` pads to a byte boundary.
    """

    def __init__(self, sink: bytearray | None = None):
        self.sink = sink if sink is not None else bytearray()
        self._value = 0
        self._nbits = 0

    def write_bits(self, bits: int, nbits: int) -> None:
        self._value |= (bits & ((1 << nbits) - 1)) << self._nbits
        self._nbits += nbits
        if self._nbits >= 64:
            self.sink += (self._value & _M64).to_bytes(8, "little")
            self._value >>= 64
            self._nbits -= 64

    def write_packed(self, values: np.ndarray, lengths: np.ndarray) -> None:
        """Emit a whole array of codes with one vectorized pack."""
        # Flush whole bytes out of the carry first.
        while self._nbits >= 8:
            self.sink.append(self._value & 0xFF)
            self._value >>= 8
            self._nbits -= 8
        out, self._value, self._nbits = pack_bits(
            values, lengths, self._value, self._nbits
        )
        self.sink += out

    def flush(self) -> bytearray:
        """Pad to a byte boundary and drain; returns the sink."""
        if self._nbits % 8:
            self.write_bits(0, 8 - self._nbits % 8)
        while self._nbits >= 8:
            self.sink.append(self._value & 0xFF)
            self._value >>= 8
            self._nbits -= 8
        assert self._nbits == 0
        self._value = 0
        return self.sink

    @property
    def bit_position(self) -> int:
        return len(self.sink) * 8 + self._nbits
