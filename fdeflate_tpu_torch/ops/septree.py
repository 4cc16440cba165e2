"""Class-separated ultra-fast tree ("septree"): the port's copy.

Copy of ``fdeflate_tpu/ops/septree.py``: ``kernel_tree`` :53,
``_build_header`` :89, ``TreeProfile`` :131 (the fields the port reads:
lengths, codes and the canned header) and ``sep_profile`` :191,
kept in the port so that it imports nothing of the JAX package.
tests/test_torch_hostcopies.py holds the lengths, codes and canned
headers equal to the original's.

All 256 literals get code lengths <= 11 and EOB and the 29 length symbols
exactly 12, so a decoder knows a symbol's class from its code length
(``ops/decode_sep.py``).  Streams of this tree are plain standard zlib: the
canned header below declares it.

The port's ``tree=`` arguments take any object with ``lens``, ``codes``,
``header_bytes`` and ``header_bits``: this ``TreeProfile`` or the JAX one.
"""

from __future__ import annotations

import functools

import numpy as np

from ..huffman import build_huffman_tree, compute_code_lengths
from ..tables import CLCL_ORDER, HUFFMAN_LENGTHS

N_LIT = 256          # literals, all present, lengths <= LIT_MAXL
LIT_MAXL = 11
SEP_LEN = 12         # EOB + length symbols all sit exactly here


@functools.lru_cache(maxsize=1)
def kernel_tree() -> tuple[np.ndarray, np.ndarray]:
    """(lengths i64[286], codes i64[286]) of the class-separated tree.

    Literal weights come from the trained tree (freq ~ 2^-len); the DP
    re-optimizes them under the <=11 cap with symbols 256..285 pinned to 12
    bits.  Codes are canonical and bit-reversed (LSB-first).
    """
    trained = np.asarray(HUFFMAN_LENGTHS, np.int64)
    freqs = np.zeros(286, np.uint64)
    freqs[:N_LIT] = (1 << (24 - trained[:N_LIT])).astype(np.uint64)
    freqs[N_LIT:] = 1  # pinned anyway
    min_l = np.ones(286, np.int64)
    max_l = np.full(286, LIT_MAXL, np.int64)
    min_l[N_LIT:] = SEP_LEN
    max_l[N_LIT:] = SEP_LEN
    lens = compute_code_lengths(freqs, min_l, max_l)

    assert (lens[N_LIT:] == SEP_LEN).all()
    assert (lens[:N_LIT] >= 1).all() and (lens[:N_LIT] <= LIT_MAXL).all()
    assert int(np.sum(1 << (SEP_LEN - lens))) == 1 << SEP_LEN, "Kraft"

    codes = np.zeros(286, np.int64)
    code = 0
    for length in range(1, SEP_LEN + 1):
        for sym in np.nonzero(lens == length)[0]:
            codes[sym] = int(format(code, f"0{length}b")[::-1], 2)
            code += 1
        code <<= 1
    assert code == 2 << SEP_LEN
    return lens, codes


def _build_header(litlen_lens: np.ndarray) -> tuple[bytes, int]:
    """Canned zlib + dynamic-block header bytes for ``litlen_lens``.

    zlib magic 78 01, BFINAL=1, BTYPE=dynamic, HLIT=29 (286 codes), HDIST=0
    (one distance code, 1 bit wide), HCLEN=15, then the CL-coded lengths
    without 16/17/18 run-length encoding.  Returns (bytes, total_bits);
    only ``total_bits`` of the byte string are header.
    """
    lens = np.asarray(litlen_lens, np.int64)
    dist_lens = np.array([1], np.int64)
    cl_freq = np.bincount(
        np.concatenate([lens, dist_lens]), minlength=19)[:19]
    cl_lens, cl_codes, _ = build_huffman_tree(cl_freq, 7)

    acc = 0
    pos = 0

    def put(v: int, n: int):
        nonlocal acc, pos
        acc |= int(v) << pos
        pos += n

    put(0x78, 8)
    put(0x01, 8)
    put(0b101, 3)   # BFINAL=1, BTYPE=10 (dynamic)
    put(286 - 257, 5)
    put(1 - 1, 5)
    put(15, 4)
    for j in range(19):
        put(int(cl_lens[CLCL_ORDER[j]]), 3)
    for length in np.concatenate([lens, dist_lens]):
        put(int(cl_codes[length]), int(cl_lens[length]))
    nbytes = (pos + 7) // 8
    return acc.to_bytes(nbytes, "little"), pos


class TreeProfile:
    """One ultra-fast tree: code lengths, codes and its canned header (any
    <= 12-bit tree with all literals present)."""

    def __init__(self, lens: np.ndarray, codes: np.ndarray):
        self.lens = np.asarray(lens, np.int64)
        self.codes = np.asarray(codes, np.int64)
        hdr, bits = _build_header(self.lens)
        self.header_bytes = hdr
        self.header_bits = int(bits)


@functools.lru_cache(maxsize=1)
def sep_profile() -> TreeProfile:
    """The class-separated throughput profile (module docstring)."""
    lens, codes = kernel_tree()
    return TreeProfile(lens, codes)
