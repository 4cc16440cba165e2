"""Huffman tree -> the port's encode and decode tables.

The codec's parameters are its Huffman tree.  ``tree_tables`` turns
numpy code/length vectors (``tables.HUFFMAN_CODES`` / ``HUFFMAN_LENGTHS``,
or an ``ops/septree.TreeProfile``'s) into the tensors the
port's kernels take as runtime inputs, on one device; ``code_tables`` does
the same for code/length tensors already on the device (the adaptive tree,
built there with no host round trip).  ``sep_tables`` gives the
class-separated decode kernel's (meta, vals) rows.

JAX counterparts:
  * encode tokens: ``fdeflate_tpu/ops/pallas_assign.py`` ``_const_tables``,
    ``runtime_tables`` and the ``blocked_input`` run tokens (:599-601);
  * header words: ``fdeflate_tpu/ops/ultrafast_kernel.py`` ``_header_words``
    and ``TreeProfile.header_words``;
  * canonical codes: ``fdeflate_tpu/ops/adaptive.py`` ``canonical_codes``;
  * decode metadata: ``fdeflate_tpu/ops/pallas_decode2.py``
    ``canonical_meta``, ``sep_meta`` and the canonical rule of
    ``decode_chunk_np``.

Token format (as in the JAX assign kernel): ``v | nbits << 13`` with the
code bits LSB-first in ``v``.  The kernels derive the zero-literal token
(``lit_tok[0]``) and the 285-run token (``len_tok[28]`` with its one
distance bit) from the tables, so a tree on the device needs no host read.

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

from .tables import (
    HUFFMAN_CODES,
    HUFFMAN_LENGTHS,
    LEN_SYM_TO_LEN_BASE,
    LEN_SYM_TO_LEN_EXTRA,
)

# Canned 54-byte stream prefix of the trained tree (``STREAM_HEADER`` and
# ``STREAM_HEADER_BITS`` of fdeflate_tpu/models/ultrafast.py:40-46): zlib
# magic, BFINAL=1/BTYPE=dynamic, and the code-length-encoded trained tree
# (286 litlen codes + one 1-bit distance code).  The final byte contributes
# only its low 5 bits.
STREAM_HEADER = bytes(
    [120, 1, 237, 192, 3, 160, 36, 89, 150, 198, 241, 255, 119, 238, 141, 200,
     204, 167, 114, 75, 99, 174, 109, 219, 182, 109, 219, 182, 109, 219, 182,
     109, 105, 140, 158, 150, 74, 175, 158, 50, 51, 34, 238, 249, 118, 183,
     106, 122, 166, 135, 59, 107, 213, 15]
)
STREAM_HEADER_BITS = 53 * 8 + 5

MAXL = 12            # longest code the fixed-geometry codec takes
CLS_LIT, CLS_EOB, CLS_LEN = 0, 1, 2
TAB_PAD = 512        # canonical symbol table entries (286 used)
NB_SHIFT = 13        # token = v | nbits << NB_SHIFT
NSYM = 286           # literal/length alphabet (256 = EOB)

# Per-symbol decode entry (val | extra << 9 | cls << 13).
_ENTRY = np.zeros(NSYM, np.int64)
_ENTRY[:256] = np.arange(256)
_ENTRY[256] = CLS_EOB << 13
_ENTRY[257:] = (LEN_SYM_TO_LEN_BASE.astype(np.int64)
                | LEN_SYM_TO_LEN_EXTRA.astype(np.int64) << 9 | CLS_LEN << 13)


def _bitrev(x: torch.Tensor, nbits: int) -> torch.Tensor:
    r = torch.zeros_like(x)
    for i in range(nbits):
        r |= ((x >> i) & 1) << (nbits - 1 - i)
    return r


def canonical_codes(lens: torch.Tensor):
    """Canonical LSB-first codes of a length vector, on its device.

    Twin of ``adaptive.canonical_codes``: symbols in (length, symbol)
    order, ``first[L] = (first[L-1] + cnt[L-1]) << 1``.  Returns int64
    ``(codes[n], first[MAXL+1], cnt[MAXL+1], idx_in_class[n])``.
    """
    lens = lens.to(torch.int64)
    dev = lens.device
    lensc = lens.clamp(0, MAXL)
    Ls = torch.arange(MAXL + 1, device=dev)
    onehot = ((lensc[:, None] == Ls) & (lens > 0)[:, None]).to(torch.int64)
    cnt = onehot.sum(dim=0)
    # first[L] = sum over 1 <= l < L of cnt[l] << (L - l)
    shift = Ls[:, None] - Ls[None, :]
    use = (shift > 0) & (Ls[None, :] > 0)
    first = torch.where(use, cnt[None, :] << shift.clamp(min=0), 0).sum(dim=1)
    idx_in_class = (onehot.cumsum(dim=0) - 1).gather(1, lensc[:, None])[:, 0]
    idx_in_class = torch.where(lens > 0, idx_in_class, 0)
    codes = _bitrev(first[lensc] + idx_in_class, 16) >> (16 - lensc)
    return torch.where(lens > 0, codes, 0), first, cnt, idx_in_class


def canonical_meta(lens):
    """(bounds, kvals, packed) of a <=12-bit code-length vector, as tensors
    on its device (int64[MAXL+1], int64[MAXL+1], int64[TAB_PAD]).

    Same definitions as ``pallas_decode2.canonical_meta``: code length of a
    bit-reversed 12-bit peek ``r12`` is ``1 + #{l < MAXL: r12 >= bounds[l]}``,
    its canonical index ``kvals[L] + (r12 >> (MAXL - L))``, and ``packed``
    holds ``val | extra << 9 | cls << 13`` per index.
    """
    lens = torch.as_tensor(lens).to(torch.int64)
    dev = lens.device
    _codes, first, cnt, idx_in_class = canonical_codes(lens)
    off = cnt.cumsum(dim=0) - cnt                # symbols shorter than L
    Ls = torch.arange(MAXL + 1, device=dev)
    bounds = torch.where(Ls > 0, (first + cnt) << (MAXL - Ls), 0)
    kvals = off - first
    lensc = lens.clamp(0, MAXL)
    slot = torch.where(lens > 0, off[lensc] + idx_in_class, TAB_PAD)
    packed = torch.zeros(TAB_PAD + 1, dtype=torch.int64, device=dev)
    entry = torch.as_tensor(_ENTRY[: lens.shape[0]], device=dev)
    packed.scatter_(0, slot, torch.where(lens > 0, entry, 0))
    return bounds, kvals, packed[:TAB_PAD]


def peek_index(bounds: torch.Tensor, kvals: torch.Tensor):
    """(L, idx) int64[4096]: the canonical rule's code length and sorted
    index for every LSB-first 12-bit peek."""
    r12 = _bitrev(torch.arange(1 << MAXL, device=bounds.device), MAXL)
    L = 1 + (r12[:, None] >= bounds[1:MAXL][None, :]).sum(dim=1)
    return L, kvals[L] + (r12 >> (MAXL - L))


def decode_table(lens) -> torch.Tensor:
    """int32[4096] on ``lens``' device: the canonical rule for every peek.

    With ``lens`` on the card (an adaptive tree) the table is built there,
    with no host read."""
    bounds, kvals, packed = canonical_meta(lens)
    L, idx = peek_index(bounds, kvals)
    ent = torch.where(idx < TAB_PAD, packed[idx.clamp(max=TAB_PAD - 1)], 0)
    return (ent | (L << 16)).to(torch.int32)


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
    Scalars: header bits, EOF code and length.  A tree with no framing (the
    adaptive tree's lane windows carry no header and no EOF token) has an
    empty header and zero scalars.
    """

    lit_tok: torch.Tensor
    len_tok: torch.Tensor
    dtab: torch.Tensor
    header: torch.Tensor
    header_bits: int = 0
    eof_code: int = 0
    eof_bits: int = 0


def code_tables(codes: torch.Tensor, lens: torch.Tensor) -> TreeTables:
    """Unframed tables of a tree given as code/length tensors, built on
    their device with no host read (``codes`` LSB-first, lengths <= 12)."""
    codes = codes.to(torch.int64)
    lens = lens.to(torch.int64)
    tok = (codes | (lens << NB_SHIFT)).to(torch.int32)
    return TreeTables(lit_tok=tok[:256].contiguous(),
                      len_tok=tok[257:NSYM].contiguous(),
                      dtab=decode_table(lens),
                      header=torch.zeros(0, dtype=torch.int32,
                                         device=codes.device))


def tree_tables(codes, lens, header: bytes = STREAM_HEADER,
                header_bits: int = STREAM_HEADER_BITS,
                device="cpu") -> TreeTables:
    """Port tensors for a canonical tree given as numpy code/length vectors.

    ``codes`` are LSB-first (bit-reversed) as ``tables.canonical_codes``
    returns them; ``header`` is the stream prefix that declares this tree.
    Raises ValueError for a code longer than 12 bits.
    """
    codes = np.asarray(codes, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    if lens.max() > MAXL:
        raise ValueError(f"code lengths above {MAXL} bits are not supported")
    dev = torch.device(device)
    t = code_tables(torch.from_numpy(codes).to(dev),
                    torch.from_numpy(lens).to(dev))
    nh = (header_bits + 31) // 32 + 1
    return TreeTables(
        lit_tok=t.lit_tok, len_tok=t.len_tok, dtab=t.dtab,
        header=torch.from_numpy(header_words(header, header_bits, nh)).to(dev),
        header_bits=int(header_bits),
        eof_code=int(codes[256]),
        eof_bits=int(lens[256]),
    )


@functools.lru_cache(maxsize=8)
def trained_tables(device: str = "cpu") -> TreeTables:
    """The trained PNG tree's tables on ``device`` (built once per device)."""
    return tree_tables(HUFFMAN_CODES, HUFFMAN_LENGTHS, device=device)


@functools.lru_cache(maxsize=8)
def profile_tables(profile, device: str = "cpu") -> TreeTables:
    """A tree profile's tables on ``device`` (``ops/septree.TreeProfile``,
    or any object with ``codes``, ``lens``, ``header_bytes`` and
    ``header_bits``):
    its codes and lengths, its canned header (built once per profile and
    device)."""
    return tree_tables(profile.codes, profile.lens, profile.header_bytes,
                       profile.header_bits, device=device)


def sep_tables(lens, device="cpu"):
    """(meta int32[32], vals int32[64]) of a class-separated tree, on
    ``device``: the rows ``pallas_decode2.sep_meta(lens)`` gives.

    meta: rows 0..12 bounds, 16..28 kvals, row 15 the literal count (the
    sorted index where the 12-bit class starts); vals: literal byte values
    by sorted index, four per int32.

    Raises ValueError unless every literal code is at most 11 bits and EOB
    and the 29 length symbols are exactly 12 (where ``sep_meta`` asserts),
    and unless the code fills the code space: then every 12-bit code is
    EOB or a length symbol, as the decode kernel's arithmetic class needs.
    """
    lens = np.asarray(lens, dtype=np.int64)
    if (lens.shape != (NSYM,) or (lens[256:] != MAXL).any()
            or (lens[:256] > MAXL - 1).any() or (lens < 0).any()):
        raise ValueError("the sep decode needs a class-separated tree "
                         "(ops/septree): literals <= 11 bits, EOB and the "
                         "length symbols exactly 12")
    if int(np.sum((1 << MAXL) >> lens[lens > 0])) != 1 << MAXL:
        raise ValueError("the sep decode needs a complete code")
    bounds, kvals, packed = canonical_meta(torch.from_numpy(lens))
    n_lit = int(np.count_nonzero(lens[:256]))
    meta = np.zeros(32, np.int64)
    meta[: MAXL + 1] = bounds.numpy()
    meta[16 : 16 + MAXL + 1] = kvals.numpy()
    meta[15] = n_lit
    vals = np.zeros(64, np.int64)
    lit = packed.numpy()[:n_lit] & 0xFF
    np.add.at(vals, np.arange(n_lit) >> 2, lit << ((np.arange(n_lit) & 3) * 8))
    dev = torch.device(device)
    return (torch.from_numpy(meta.astype(np.int32)).to(dev),
            torch.from_numpy(vals.astype(np.uint32).view(np.int32)).to(dev))
