"""Decompression error taxonomy of the port.

Copy of ``fdeflate_tpu/errors.py`` (``Status`` :14, ``DecompressionError``
:38 and its subclasses, ``OutputTooLarge`` :146, ``error_for_status``
:164), kept in the port so
that it imports nothing of the JAX package.  Class names and ``Status`` values are the original's
(tests/test_torch_hostcopies.py holds them equal), so a port error and a
JAX error of one kind share a class name.

Mirrors the reference's 16-variant error enum (src/decompress.rs:13-48) as a
Python exception hierarchy plus stable integer status codes.  Device kernels
cannot raise: lane-parallel decode sets a per-stream status code (one of
``Status``), which the host converts back to the matching exception.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Per-stream status codes used by device kernels (0 == OK)."""

    OK = 0
    BAD_ZLIB_HEADER = 1
    INSUFFICIENT_INPUT = 2
    INVALID_BLOCK_TYPE = 3
    INVALID_UNCOMPRESSED_BLOCK_LENGTH = 4
    INVALID_HLIT = 5
    INVALID_HDIST = 6
    INVALID_CODE_LENGTH_REPEAT = 7
    BAD_CODE_LENGTH_HUFFMAN_TREE = 8
    BAD_LITERAL_LENGTH_HUFFMAN_TREE = 9
    BAD_DISTANCE_HUFFMAN_TREE = 10
    INVALID_LITERAL_LENGTH_CODE = 11
    INVALID_DISTANCE_CODE = 12
    INPUT_STARTS_WITH_RUN = 13
    DISTANCE_TOO_FAR_BACK = 14
    WRONG_CHECKSUM = 15
    EXTRA_INPUT = 16
    # Not part of the reference enum: bounded decompression overflow.
    OUTPUT_TOO_LARGE = 17


class DecompressionError(Exception):
    """Base class for all deflate-stream decode errors."""

    status: Status = Status.OK

    def __eq__(self, other):  # value-style equality, like the reference enum
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class BadZlibHeader(DecompressionError):
    """The zlib header is corrupt."""

    status = Status.BAD_ZLIB_HEADER


class InsufficientInput(DecompressionError):
    """All input was consumed, but the end of the stream wasn't reached."""

    status = Status.INSUFFICIENT_INPUT


class InvalidBlockType(DecompressionError):
    """A block header specifies an invalid block type."""

    status = Status.INVALID_BLOCK_TYPE


class InvalidUncompressedBlockLength(DecompressionError):
    """An uncompressed block's NLEN value is invalid."""

    status = Status.INVALID_UNCOMPRESSED_BLOCK_LENGTH


class InvalidHlit(DecompressionError):
    """Too many literal/length codes were specified."""

    status = Status.INVALID_HLIT


class InvalidHdist(DecompressionError):
    """Too many distance codes were specified."""

    status = Status.INVALID_HDIST


class InvalidCodeLengthRepeat(DecompressionError):
    """A code-length repeat had no previous code or ran past the end."""

    status = Status.INVALID_CODE_LENGTH_REPEAT


class BadCodeLengthHuffmanTree(DecompressionError):
    """The stream doesn't specify a valid Huffman tree."""

    status = Status.BAD_CODE_LENGTH_HUFFMAN_TREE


class BadLiteralLengthHuffmanTree(DecompressionError):
    """The stream doesn't specify a valid Huffman tree."""

    status = Status.BAD_LITERAL_LENGTH_HUFFMAN_TREE


class BadDistanceHuffmanTree(DecompressionError):
    """The stream doesn't specify a valid Huffman tree."""

    status = Status.BAD_DISTANCE_HUFFMAN_TREE


class InvalidLiteralLengthCode(DecompressionError):
    """The stream contains a literal/length code not allowed by the header."""

    status = Status.INVALID_LITERAL_LENGTH_CODE


class InvalidDistanceCode(DecompressionError):
    """The stream contains a distance code not allowed by the header."""

    status = Status.INVALID_DISTANCE_CODE


class InputStartsWithRun(DecompressionError):
    """The stream contains a back-reference as the first symbol."""

    status = Status.INPUT_STARTS_WITH_RUN


class DistanceTooFarBack(DecompressionError):
    """The stream contains a back-reference that is too far back."""

    status = Status.DISTANCE_TOO_FAR_BACK


class WrongChecksum(DecompressionError):
    """The zlib stream checksum is incorrect."""

    status = Status.WRONG_CHECKSUM


class ExtraInput(DecompressionError):
    """Extra input data after the end of the stream."""

    status = Status.EXTRA_INPUT


class OutputTooLarge(Exception):
    """Bounded decompression exceeded ``maxlen`` (carries the partial output).

    Mirrors BoundedDecompressionError::OutputTooLarge
    (reference: src/decompress.rs:1090-1102).
    """

    def __init__(self, partial_output: bytes):
        super().__init__("output too large")
        self.partial_output = partial_output


_STATUS_TO_ERROR: dict[Status, type[DecompressionError]] = {
    cls.status: cls
    for cls in DecompressionError.__subclasses__()
}


def error_for_status(status: int) -> DecompressionError:
    """Convert a device status code back into the matching exception."""
    return _STATUS_TO_ERROR[Status(status)]()
