"""Huffman tree -> the port's encode and decode tables.

The codec's parameters are its Huffman tree.  ``tree_tables`` turns the
numpy code/length vectors the JAX package holds (``tables.HUFFMAN_CODES`` /
``HUFFMAN_LENGTHS`` today, a septree or adaptive tree later) into the
tensors the port's kernels take as runtime inputs, on one device.

JAX counterparts:
  * encode tokens: ``fdeflate_tpu/ops/pallas_assign.py`` ``_const_tables``,
    ``runtime_tables`` and the ``blocked_input`` run tokens (:599-601);
  * header words: ``fdeflate_tpu/ops/ultrafast_kernel.py`` ``_header_words``;
  * decode metadata: ``fdeflate_tpu/ops/pallas_decode2.py``
    ``canonical_meta`` and the canonical rule of ``decode_chunk_np``.

Token format (as in the JAX assign kernel): ``v | nbits << 13`` with the
code bits LSB-first in ``v``.

Decode table: 4096 entries indexed by the next 12 stream bits (LSB-first,
i.e. not bit-reversed), entry = ``val | extra << 9 | cls << 13 | L << 16``
where ``L`` is the code length and (val, extra, cls) the canonical-order
symbol entry of ``canonical_meta``.  Every peek gets the entry the JAX
kernel's canonical rule gives it, invalid ones included (an index past the
symbol table reads as entry 0: a zero literal).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from fdeflate_tpu.models.ultrafast import STREAM_HEADER, STREAM_HEADER_BITS
from fdeflate_tpu.tables import (
    HUFFMAN_CODES,
    HUFFMAN_LENGTHS,
    LEN_SYM_TO_LEN_BASE,
    LEN_SYM_TO_LEN_EXTRA,
)

MAXL = 12            # longest code the fixed-geometry codec takes
CLS_LIT, CLS_EOB, CLS_LEN = 0, 1, 2
TAB_PAD = 512        # canonical symbol table entries (286 used)
NB_SHIFT = 13        # token = v | nbits << NB_SHIFT


def canonical_meta(lens) -> tuple[tuple, tuple, np.ndarray]:
    """(bounds, kvals, packed) for a <=12-bit code-length vector.

    Same definitions as ``pallas_decode2.canonical_meta``: code length of a
    bit-reversed 12-bit peek ``r12`` is ``1 + #{l < MAXL: r12 >= bounds[l]}``,
    its canonical index ``kvals[L] + (r12 >> (MAXL - L))``, and ``packed``
    holds ``val | extra << 9 | cls << 13`` per index.
    """
    lens = np.asarray(lens, dtype=np.int64)
    if lens.max() > MAXL:
        raise ValueError(f"code lengths above {MAXL} bits are not supported")
    cnt = np.bincount(lens, minlength=MAXL + 1)
    cnt[0] = 0
    first = np.zeros(MAXL + 1, np.int64)
    code = 0
    for L in range(1, MAXL + 1):
        first[L] = code
        code = (code + cnt[L]) << 1
    bounds = [0] * (MAXL + 1)
    kvals = [0] * (MAXL + 1)
    acc = 0
    for L in range(1, MAXL + 1):
        bounds[L] = int(first[L] + cnt[L]) << (MAXL - L)
        kvals[L] = acc - int(first[L])
        acc += int(cnt[L])

    order = np.lexsort((np.arange(len(lens)), lens))
    order = order[lens[order] > 0]
    packed = np.zeros(TAB_PAD, np.int32)
    for i, sym in enumerate(order):
        if sym < 256:
            val, extra, cls = int(sym), 0, CLS_LIT
        elif sym == 256:
            val, extra, cls = 0, 0, CLS_EOB
        else:
            val = int(LEN_SYM_TO_LEN_BASE[sym - 257])
            extra = int(LEN_SYM_TO_LEN_EXTRA[sym - 257])
            cls = CLS_LEN
        packed[i] = val | (extra << 9) | (cls << 13)
    return tuple(bounds), tuple(kvals), packed


def _bitrev12(x: np.ndarray) -> np.ndarray:
    r = np.zeros_like(x)
    for i in range(MAXL):
        r |= ((x >> i) & 1) << (MAXL - 1 - i)
    return r


def decode_table(lens) -> np.ndarray:
    """int32[4096]: the canonical rule evaluated for every 12-bit peek."""
    bounds, kvals, packed = canonical_meta(lens)
    r12 = _bitrev12(np.arange(1 << MAXL, dtype=np.int64))
    L = np.ones_like(r12)
    for l in range(1, MAXL):
        L += r12 >= bounds[l]
    idx = np.asarray(kvals)[L] + (r12 >> (MAXL - L))
    ent = np.where(idx < TAB_PAD, packed[np.minimum(idx, TAB_PAD - 1)], 0)
    return (ent.astype(np.int64) | (L << 16)).astype(np.int32)


def header_words(header: bytes, header_bits: int, nwords: int) -> np.ndarray:
    """The canned stream header as little-endian u32 words (int32 view).

    Only the low ``header_bits % 8`` bits of the last partial byte belong to
    the header (the trained header's byte 53 contributes 5 bits)."""
    nfull, rem = divmod(header_bits, 8)
    raw = bytearray(header[:nfull]) + bytes(4 * nwords - nfull)
    if rem:
        raw[nfull] = header[nfull] & ((1 << rem) - 1)
    return np.frombuffer(bytes(raw), dtype="<u4").view(np.int32).copy()


@dataclass(frozen=True)
class TreeTables:
    """One tree's runtime tables, on one device.

    lit_tok   int32[256]  literal tokens (v | nbits << 13)
    len_tok   int32[29]   length-symbol tokens for symbols 257..285
    dtab      int32[4096] decode table (see module docstring)
    header    int32[nh]   canned stream header words
    Scalars: zero-literal token, 285-run token (its 1 distance bit
    included), header bits, EOF code and length.
    """

    lit_tok: torch.Tensor
    len_tok: torch.Tensor
    dtab: torch.Tensor
    header: torch.Tensor
    zlit_tok: int
    t285_tok: int
    header_bits: int
    eof_code: int
    eof_bits: int


def tree_tables(codes, lens, header: bytes = STREAM_HEADER,
                header_bits: int = STREAM_HEADER_BITS,
                device="cpu") -> TreeTables:
    """Port tensors for a canonical tree given as numpy code/length vectors.

    ``codes`` are LSB-first (bit-reversed) as ``tables.canonical_codes``
    returns them; ``header`` is the stream prefix that declares this tree.
    """
    codes = np.asarray(codes, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    tok = codes | (lens << NB_SHIFT)
    nh = (header_bits + 31) // 32 + 1
    dev = torch.device(device)
    as_t = functools.partial(torch.as_tensor, dtype=torch.int32, device=dev)
    return TreeTables(
        lit_tok=as_t(tok[:256].astype(np.int32)),
        len_tok=as_t(tok[257:286].astype(np.int32)),
        dtab=as_t(decode_table(lens)),
        header=as_t(header_words(header, header_bits, nh)),
        zlit_tok=int(tok[0]),
        t285_tok=int(codes[285] | ((lens[285] + 1) << NB_SHIFT)),
        header_bits=int(header_bits),
        eof_code=int(codes[256]),
        eof_bits=int(lens[256]),
    )


@functools.lru_cache(maxsize=8)
def trained_tables(device: str = "cpu") -> TreeTables:
    """The trained PNG tree's tables on ``device`` (built once per device)."""
    return tree_tables(HUFFMAN_CODES, HUFFMAN_LENGTHS, device=device)
