"""K12 header_tables: dynamic-block headers -> K4's tables.

JAX counterpart: none on the device.  The JAX package (and the port until
now) parses each validated header on the host (``_HostBitReader``,
``_parse_dynamic_lengths``) and builds its tables (``foreign_meta``); the
port's copies are in ``ops/inflate_host.py``.  The CUDA kernel is
``csrc/header_tables.cu``; ``header_tables_plain`` is its plain version,
that host loop (``parse_header``) over the same inputs.

A header is the absolute bit offset of a dynamic-block header in the
concatenated stream words (``ops/inflate.pad_words``), with its stream's
word end ``wend`` (words at or past it read as 0) and payload end bit
``bit_end`` (the host reader takes no bit at or past it): the rows
``discovery.stage2_batch_inputs`` builds for block discovery, and
``ops/inflate.decompress_sequential`` for the headers its streams reached
in a round.  Its status:

* ``LANE`` (0): parsed, with (meta i32[64], tab i32[160]) of
  ``foreign_meta``;
* ``SKIPPED`` (1): the parse fails (BTYPE not 2, HLIT > 286, HDIST > 30, a
  code-length code that is not exactly complete, a 16 first, a repeat past
  HLIT + HDIST, too few bits, no end-of-block code);
* ``DROPPED`` (2): parsed, but ``block_tables`` refuses its trees (a
  literal/length code, or a distance code of two or more codes, that is
  not exactly complete).

Its ``host_ok`` is 1 where the host's own rule (``_check_trees``, which
``_advance_headers`` applies) takes a lane's trees too: it refuses a single
distance code longer than one bit, which ``foreign_meta`` takes.  It is 0
for every header that is not a lane.  Block discovery reads the first three
rows of ``info`` alone; the sequential path sends a header with ``host_ok``
0 to the host's parse.

The parse follows RFC 1951 (a code 16 repeats the length before it, 0 after
a 17 or an 18), not K5's rule (``ops/validate_headers``), so a false header
K5 lets through comes out DROPPED here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .. import errors as E
from . import inflate_host as host
from .inflate_records import META_ROWS, TAB_PAIRS, block_tables

LANE, SKIPPED, DROPPED = 0, 1, 2


class _WordsReader(host._HostBitReader):
    """``_HostBitReader`` over a stream's words (``data``: their bytes, to
    its word end) whose payload ends at bit ``end``."""

    def __init__(self, data, end: int, bitpos: int):
        super().__init__(data, bitpos)
        self.end = end

    def bits_left(self) -> int:
        return self.end - self.pos


def parse_header(r):
    """The host's parse of the header at reader ``r``'s position and its
    table build: (status, bfinal, lengths, hlit, tables), ``r`` left at the
    symbol start when the parse succeeds.  ``lengths`` (i64[320]) and
    ``hlit`` are ``_parse_dynamic_lengths``' (None, 0 when skipped);
    ``tables`` is ``block_tables``' (meta, tab), None unless a lane; bfinal
    is 0 when skipped."""
    try:
        bfinal = r.take(1)
        if r.take(2) != 0b10:
            return SKIPPED, 0, None, 0, None
        lengths, hlit = host._parse_dynamic_lengths(r)
    except E.DecompressionError:
        return SKIPPED, 0, None, 0, None
    try:
        tables = block_tables(lengths, hlit)
    except ValueError:
        return DROPPED, bfinal, lengths, hlit, None
    return LANE, bfinal, lengths, hlit, tables


def _host_ok(lengths, hlit: int) -> bool:
    """Whether ``_check_trees`` takes the parsed trees."""
    try:
        host._check_trees(lengths, hlit)
    except E.DecompressionError:
        return False
    return True


def header_tables_plain(words, offs, wend, bit_end):
    """Plain K12: ``parse_header`` over each header in turn.  Returns
    ``header_tables``' (info, meta, tab) on the CPU."""
    w = np.ascontiguousarray(words.reshape(-1).cpu().numpy())
    data = memoryview(w.view(np.uint8))
    cols = [x.reshape(-1).tolist() for x in (offs, wend, bit_end)]
    H = len(cols[0])
    info = np.zeros((4, H), np.int64)
    meta = np.zeros((H, META_ROWS), np.int32)
    tab = np.zeros((H, TAB_PAIRS), np.int32)
    for h, (c, we, end) in enumerate(zip(*cols)):
        r = _WordsReader(data[: min(we, w.size) * 4], end, c)
        status, bfinal, lengths, hlit, tables = parse_header(r)
        info[:, h] = (status, bfinal, -1 if status == SKIPPED else r.pos,
                      status == LANE and _host_ok(lengths, hlit))
        if tables is not None:
            meta[h], tab[h] = tables
    return torch.from_numpy(info), torch.from_numpy(meta), torch.from_numpy(tab)


def header_tables(words, offs, wend, bit_end):
    """K12 on ``words``' device: every header parsed and its tables built.

    ``words`` int32[W] (u32 bit patterns); ``offs``, ``wend``, ``bit_end``
    int64[H].  Returns (info int64[4, H]: each header's status, BFINAL,
    symbol start (0 and -1 when skipped) and host_ok; meta int32[H, 64],
    tab int32[H, 160]: its tables, zero unless a lane).  CPU tensors take
    ``header_tables_plain``; CUDA tensors launch ``csrc/header_tables.cu``,
    one launch for all headers (a warp a header).
    """
    H = offs.numel()
    if wend.numel() != H or bit_end.numel() != H:
        raise ValueError("header_tables: offs, wend and bit_end need one "
                         "entry per header")
    if words.device.type == "cpu":
        return header_tables_plain(words, offs, wend, bit_end)
    _build.require_cuda(words, offs, wend, bit_end)
    dev = words.device
    words = _build.i32(words.reshape(-1))
    cols = [_build.i64(x) for x in (offs, wend, bit_end)]
    info = torch.empty(4, H, dtype=torch.int64, device=dev)
    meta = torch.empty(H, META_ROWS, dtype=torch.int32, device=dev)
    tab = torch.empty(H, TAB_PAIRS, dtype=torch.int32, device=dev)
    if H == 0:
        return info, meta, tab
    _build.launch("header_tables", dev, words.data_ptr(),
                  *(x.data_ptr() for x in cols), words.numel(),
                  info.data_ptr(), meta.data_ptr(), tab.data_ptr(), H)
    return info, meta, tab
