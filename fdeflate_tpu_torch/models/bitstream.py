"""Dynamic-Huffman block emission.

The port's copy of ``fdeflate_tpu/models/bitstream.py`` (numpy only):
``LiteralRun`` :35, ``Backref`` :41, ``_count_and_build`` :133, the
demotion pass (``ENABLE_DEMOTION`` :160, ``_demote_unprofitable`` :171,
``_block_cost_bits`` :260) and ``write_block`` :292.  Its
``build_huffman_tree`` (:47) is the port's copy in ``huffman.py`` and its
``BitWriter`` the one in ``ops/bitio.py``.  tests/test_torch_hostcopies.py
holds ``write_block`` to the original on fuzzed symbol streams.

Equivalent of the reference's block writer (src/compress/bitstream.rs):
per-block frequency counting, Huffman tree construction with Kraft-sum length
limiting, and serialization of the block.  The hot paths are vectorized:
frequencies come from ``np.bincount`` over literal runs, and all symbol codes
for a block are emitted through one ``pack_bits`` scatter instead of a serial
bit loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..huffman import build_huffman_tree
from ..ops.bitio import BitWriter
from ..tables import (
    CLCL_ORDER,
    DIST_SYM_TO_DIST_BASE,
    DIST_SYM_TO_DIST_EXTRA,
    LENGTH_TO_LEN_EXTRA,
    LENGTH_TO_SYMBOL,
)

# Symbols produced by the parse layer (reference: src/compress/bitstream.rs:29-39).
# A literal run is (LITERAL_RUN, start, end) with absolute stream indices;
# a back-reference is (BACKREF, length, distance, dist_sym).
LITERAL_RUN = 0
BACKREF = 1


@dataclass
class LiteralRun:
    start: int
    end: int


@dataclass
class Backref:
    length: int
    distance: int
    dist_sym: int


def _count_and_build(arr, base_index: int, symbols: list):
    """Frequency count + litlen/dist tree construction for one block."""
    frequencies = np.zeros(286, dtype=np.int64)
    dist_frequencies = np.zeros(30, dtype=np.int64)
    frequencies[256] = 1

    for sym in symbols:
        if isinstance(sym, LiteralRun):
            counts = np.bincount(
                arr[sym.start - base_index : sym.end - base_index], minlength=256
            )
            frequencies[:256] += counts
        else:
            frequencies[LENGTH_TO_SYMBOL[sym.length - 3]] += 1
            dist_frequencies[sym.dist_sym] += 1

    lengths, codes, _ = build_huffman_tree(frequencies, 15)
    dist_lengths, dist_codes, _ = build_huffman_tree(dist_frequencies, 15)
    return lengths, codes, dist_lengths, dist_codes


# Master switch for the demotion pass.  With it off, write_block emits every
# parsed symbol as-is — byte-for-byte the reference encoder's behavior
# (src/compress/bitstream.rs:143-194), which tests use as the "emulated
# fdeflate" size baseline (no Rust toolchain exists in this image to run the
# real one; the parse/match layers are statement-level faithful ports, so
# the emitted symbol stream matches the reference's choices).
ENABLE_DEMOTION = True

_DEMOTE_MAX_LEN = 32  # longer matches always beat their literal encoding
# Bits of advantage a match must show before it survives.  A per-symbol cost
# model can't see the codespace externality of match symbols (every kept
# match lengthens the literal codes a little); 3 bits of margin empirically
# restores size monotonicity across levels on the LZ-hostile corpora while
# leaving LZ-friendly data untouched (SIZES.md).
_DEMOTE_MARGIN = 3


def _demote_unprofitable(arr, base_index, symbols, lengths, dist_lengths):
    """Replace back-references that cost more bits than their literals.

    Short matches at far distances can be more expensive than entropy-coded
    literals (on LZ-hostile data the hybrid finder's min_match of 4-5 accepts
    many such break-even matches, inverting the level/size ordering — see
    SIZES.md).  Using the first-pass code lengths as the cost model, demote
    each losing backref to a literal run; the caller rebuilds the trees over
    the demoted symbol stream.  Returns the new symbol list, or None when
    nothing was demoted.

    This is an addition over the reference encoder (its bitstream writer
    emits every parsed symbol as-is, src/compress/bitstream.rs:143-194);
    output remains plain DEFLATE either way.
    """
    # Reconstruct each backref's absolute output position: symbols tile the
    # block contiguously, so literal runs anchor positions in both
    # directions.
    pos_of = [None] * len(symbols)
    pos = None
    for i, s in enumerate(symbols):
        if isinstance(s, LiteralRun):
            pos = s.end
        else:
            pos_of[i] = pos
            if pos is not None:
                pos += s.length
    nxt = None
    for i in range(len(symbols) - 1, -1, -1):
        s = symbols[i]
        if isinstance(s, LiteralRun):
            nxt = s.start
        elif pos_of[i] is None and nxt is not None:
            nxt -= s.length
            pos_of[i] = nxt
        else:
            nxt = pos_of[i]

    # Price literals with a shadow literals-only tree over the full block
    # bytes (match-covered bytes included).  The first-pass litlen tree is an
    # equilibrium that already paid codespace to the match symbols, which
    # makes every break-even match look exactly break-even; the shadow tree
    # prices the alternative where the bytes are coded as literals.
    hist = np.zeros(256, dtype=np.int64)
    for i, s in enumerate(symbols):
        if isinstance(s, LiteralRun):
            lo, hi = s.start - base_index, s.end - base_index
        elif pos_of[i] is not None:
            lo = pos_of[i] - base_index
            hi = lo + s.length
        else:
            continue
        hist += np.bincount(arr[lo:hi], minlength=256)
    shadow_lengths, _, _ = build_huffman_tree(hist, 15)
    lit_cost = np.where(shadow_lengths > 0, shadow_lengths, 15).astype(np.int64)

    changed = False
    out: list = []
    for i, s in enumerate(symbols):
        if (
            isinstance(s, LiteralRun)
            or s.length > _DEMOTE_MAX_LEN
            or pos_of[i] is None
        ):
            out.append(s)
            continue
        lsym = int(LENGTH_TO_SYMBOL[s.length - 3])
        match_bits = (
            int(lengths[lsym])
            + int(LENGTH_TO_LEN_EXTRA[s.length - 3])
            + int(dist_lengths[s.dist_sym])
            + int(DIST_SYM_TO_DIST_EXTRA[s.dist_sym])
        )
        start = pos_of[i] - base_index
        literal_bits = int(lit_cost[arr[start : start + s.length]].sum())
        if literal_bits < match_bits + _DEMOTE_MARGIN:
            changed = True
            run = LiteralRun(pos_of[i], pos_of[i] + s.length)
            if out and isinstance(out[-1], LiteralRun) and out[-1].end == run.start:
                # Replace rather than mutate: the previous run object may be
                # shared with a snapshot of the pre-demotion symbol list.
                out[-1] = LiteralRun(out[-1].start, run.end)
            else:
                out.append(run)
        else:
            out.append(s)
    return out if changed else None


def _block_cost_bits(arr, base_index, symbols, lengths, dist_lengths) -> int:
    """Exact bit size this block would serialize to under the given trees."""
    num_litlen = 286
    while num_litlen > 257 and lengths[num_litlen - 1] == 0:
        num_litlen -= 1
    num_dist = 30
    while num_dist > 1 and dist_lengths[num_dist - 1] == 0:
        num_dist -= 1
    cl_freq = np.bincount(
        np.concatenate([lengths[:num_litlen], dist_lengths[:num_dist]]),
        minlength=19,
    )[:19]
    cl_lengths, _, _ = build_huffman_tree(cl_freq, 7)
    bits = 3 + 5 + 5 + 4 + 3 * 19
    bits += int(cl_lengths[lengths[:num_litlen]].sum())
    bits += int(cl_lengths[dist_lengths[:num_dist]].sum())
    for s in symbols:
        if isinstance(s, LiteralRun):
            bits += int(
                lengths[arr[s.start - base_index : s.end - base_index]].sum()
            )
        else:
            lsym = int(LENGTH_TO_SYMBOL[s.length - 3])
            bits += (
                int(lengths[lsym])
                + int(LENGTH_TO_LEN_EXTRA[s.length - 3])
                + int(dist_lengths[s.dist_sym])
                + int(DIST_SYM_TO_DIST_EXTRA[s.dist_sym])
            )
    return bits + int(lengths[256])


def write_block(
    writer: BitWriter,
    data,
    base_index: int,
    symbols: list,
    eof: bool,
) -> None:
    """Serialize one dynamic-Huffman block (reference: src/compress/bitstream.rs:41-196)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data

    lengths, codes, dist_lengths, dist_codes = _count_and_build(
        arr, base_index, symbols
    )
    if ENABLE_DEMOTION:
        # Iterate demotion (each pass lengthens the surviving match symbols'
        # codes, which can turn further break-even matches unprofitable),
        # keeping the exactly-cheapest candidate: the per-symbol cost model
        # over-fires on some inputs, so the final choice is by measured
        # whole-block size — demotion can never emit a larger block.
        best = (
            _block_cost_bits(arr, base_index, symbols, lengths, dist_lengths),
            symbols, lengths, codes, dist_lengths, dist_codes,
        )
        for _ in range(3):
            demoted = _demote_unprofitable(
                arr, base_index, symbols, lengths, dist_lengths
            )
            if demoted is None:
                break
            symbols = demoted
            lengths, codes, dist_lengths, dist_codes = _count_and_build(
                arr, base_index, symbols
            )
            cost = _block_cost_bits(
                arr, base_index, symbols, lengths, dist_lengths
            )
            if cost < best[0]:
                best = (cost, symbols, lengths, codes, dist_lengths, dist_codes)
        _, symbols, lengths, codes, dist_lengths, dist_codes = best

    num_litlen = 286
    while num_litlen > 257 and lengths[num_litlen - 1] == 0:
        num_litlen -= 1
    num_dist = 30
    while num_dist > 1 and dist_lengths[num_dist - 1] == 0:
        num_dist -= 1

    # Code-length code: plain 0..15 values, no 16/17/18 run-length encoding
    # (reference: src/compress/bitstream.rs:103-141).
    cl_freq = np.bincount(
        np.concatenate([lengths[:num_litlen], dist_lengths[:num_dist]]),
        minlength=19,
    )[:19]
    cl_lengths, cl_codes, _ = build_huffman_tree(cl_freq, 7)

    writer.write_bits(0b101 if eof else 0b100, 3)  # BFINAL + BTYPE=dynamic
    writer.write_bits(num_litlen - 257, 5)
    writer.write_bits(num_dist - 1, 5)
    writer.write_bits(15, 4)  # HCLEN: always send all 19 CL code lengths
    for j in range(19):
        writer.write_bits(int(cl_lengths[CLCL_ORDER[j]]), 3)
    for length in np.concatenate([lengths[:num_litlen], dist_lengths[:num_dist]]):
        writer.write_bits(int(cl_codes[length]), int(cl_lengths[length]))

    # Emit all block symbols through one vectorized pack.  Each token is
    # (value, nbits); literal runs gather codes per byte, back-references
    # pack code+extra into single tokens.
    values: list[np.ndarray] = []
    nbits: list[np.ndarray] = []
    codes_u = codes.astype(np.uint64)
    lengths_u = lengths.astype(np.uint64)
    for sym in symbols:
        if isinstance(sym, LiteralRun):
            chunk = arr[sym.start - base_index : sym.end - base_index]
            values.append(codes_u[chunk])
            nbits.append(lengths_u[chunk])
        else:
            lsym = int(LENGTH_TO_SYMBOL[sym.length - 3])
            len_extra = int(LENGTH_TO_LEN_EXTRA[sym.length - 3])
            v1 = int(codes[lsym]) | ((sym.length - 3) & ((1 << len_extra) - 1)) << int(
                lengths[lsym]
            )
            n1 = int(lengths[lsym]) + len_extra
            dist_extra = int(DIST_SYM_TO_DIST_EXTRA[sym.dist_sym])
            v2 = int(dist_codes[sym.dist_sym]) | (
                sym.distance - int(DIST_SYM_TO_DIST_BASE[sym.dist_sym])
            ) << int(dist_lengths[sym.dist_sym])
            n2 = int(dist_lengths[sym.dist_sym]) + dist_extra
            values.append(np.array([v1, v2], dtype=np.uint64))
            nbits.append(np.array([n1, n2], dtype=np.uint64))
    values.append(np.array([int(codes[256])], dtype=np.uint64))
    nbits.append(np.array([int(lengths[256])], dtype=np.uint64))

    writer.write_packed(np.concatenate(values), np.concatenate(nbits))
