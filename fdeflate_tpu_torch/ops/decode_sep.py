"""K6 decode_sep: fixed-geometry decode of a class-separated tree.

JAX counterpart: the TPU kernel
``fdeflate_tpu/ops/pallas_decode2.py:_kernel_sep`` (via
``decode_blocked_sep``), with the window staging before it folded in as in
K3 (``ops/decode2.py``).  The CUDA kernel is ``csrc/decode_sep.cu``, K3's
group decode with the sep tree's table; ``decode_sep_plain`` is its plain
version, a loop over word steps vectorised across lanes.

Lane ``b * C + k`` reads stream ``b`` from bit ``chunk_starts[b, k]`` and
writes exactly S = N / C bytes to ``out[b, k*S : (k+1)*S]``.  Semantics are
``_kernel_sep``'s (``csrc/lanes.cuh`` ``decode_sep_lane`` spells them out):
S / 4 word steps of up to four symbols; literals from the 4-packed ``vals``
table; a length symbol's zero run carried across steps and dropped at the
lane end; EOB consumes its 12 bits and decoding goes on (K3 stalls there),
so a lane that meets the stream's end reads on through the EOF token and
the zero bits after it (zero literals, the sep tree's all-zero code).
Words at or past W read as 0.  ``meta``/``vals`` are ``trees.sep_tables``.
"""

from __future__ import annotations

import torch

from .. import _build
from ..trees import MAXL, peek_index

_MASK32 = 0xFFFFFFFF


def decode_sep_plain(words: torch.Tensor, chunk_starts: torch.Tensor,
                     meta: torch.Tensor, vals: torch.Tensor, N: int, C: int):
    """Plain PyTorch K6: one sub-step of every lane per iteration.

    Returns (out u8[B, N], bpos int32[B, C]) — bpos is each lane's exit bit
    relative to its start.
    """
    out, bpos, _eob = decode_sep_plain_eob(words, chunk_starts, meta, vals,
                                           N, C)
    return out, bpos


def decode_sep_plain_eob(words: torch.Tensor, chunk_starts: torch.Tensor,
                         meta: torch.Tensor, vals: torch.Tensor, N: int,
                         C: int):
    """``decode_sep_plain`` and bool[B, C]: the lanes whose decode meets
    an EOB, which the CUDA kernel decodes serially (its ``stats[4]`` counts
    them)."""
    B, W = words.shape
    S = N // C
    L = B * C
    dev = words.device
    # Two zero words past each row: reads at or past W see zeros.
    w64 = torch.cat([words.to(torch.int64) & _MASK32,
                     torch.zeros(B, 2, dtype=torch.int64, device=dev)], dim=1)
    w64 = w64.reshape(-1)
    row0 = torch.arange(L, device=dev) // C * (W + 2)
    start = chunk_starts.reshape(-1).to(torch.int64)
    m = meta.to(torch.int64)
    v4 = vals.to(torch.int64) & _MASK32
    n_lit = m[15]
    # The canonical rule (bounds compares, kvals) for every 12-bit peek.
    Lp, idxp = peek_index(m[: MAXL + 1], m[16 : 16 + MAXL + 1])
    pos = torch.zeros(L, dtype=torch.int64, device=dev)
    run = torch.zeros(L, dtype=torch.int64, device=dev)
    out = torch.empty(L, S // 4, dtype=torch.int64, device=dev)
    met = torch.zeros(L, dtype=torch.bool, device=dev)
    for u in range(S // 4):
        used = torch.zeros(L, dtype=torch.int64, device=dev)
        filled = torch.zeros(L, dtype=torch.int64, device=dev)
        word = torch.zeros(L, dtype=torch.int64, device=dev)
        for _ in range(4):
            take = torch.minimum(run, 4 - filled)
            filled += take
            run -= take
            need = (filled < 4) & (run == 0)
            a = start + pos + used
            wi = a >> 5
            wi = torch.where(wi < W, wi, W)
            sh = a & 31
            bits = w64[row0 + wi] >> sh
            bits |= (w64[row0 + wi + 1] << (32 - sh)) & _MASK32
            Lc = Lp[bits & 0xFFF]
            idx = idxp[bits & 0xFFF]
            is12 = need & (Lc == MAXL)
            is_lit = need & (Lc < MAXL)
            sp = idx - n_lit - 1                  # length symbol 257 + sp
            is_run = is12 & (sp >= 0)
            met |= is12 & (sp < 0)
            e = torch.where((sp < 4) | (sp == 28), 0, (sp >> 2) - 1)
            base = torch.where(sp < 4, sp + 3, ((4 + (sp & 3)) << e) + 3)
            base = torch.where(sp == 28, 258, base)
            byte = (v4[(idx >> 2).clamp(0, 63)] >> ((idx & 3) * 8)) & 0xFF
            word |= torch.where(is_lit, byte << (filled * 8), 0)
            filled += is_lit.to(torch.int64)
            run = torch.where(is_run, base + ((bits >> Lc) & ((1 << e) - 1)),
                              run)
            used += torch.where(is_lit | is12, Lc, 0) + torch.where(
                is_run, e + 1, 0)
        run -= torch.minimum(run, 4 - filled)
        pos += used
        out[:, u] = word
    # int64 -> int32 keeps the low 32 bits; the words are little-endian.
    out = out.to(torch.int32).view(torch.uint8).reshape(B, N)
    return out, pos.to(torch.int32).reshape(B, C), met.reshape(B, C)


def decode_sep(words: torch.Tensor, chunk_starts: torch.Tensor,
               meta: torch.Tensor, vals: torch.Tensor, N: int, C: int,
               stats=None):
    """K6 on ``words``' device: (out u8[B, N], bpos int32[B, C]).

    ``words`` int32[B, W] stream words (u32 bit patterns), ``chunk_starts``
    int32[B, C] absolute lane start bits, ``meta`` int32[32] and ``vals``
    int32[64] from ``trees.sep_tables``.  CPU tensors take
    ``decode_sep_plain``; CUDA tensors launch ``csrc/decode_sep.cu`` (K3's
    group decode with the sep tree's table; a lane whose decode meets an EOB
    is decoded again serially).  ``stats``: None, or a zeroed int64[5] on
    the card that the kernel fills with its spans' counts (most sync rounds
    of a span, spans, spans another span continues, sync rounds) and the
    lanes it decoded serially.
    """
    B, W = words.shape
    if N % C or (N // C) % 4 or chunk_starts.shape != (B, C):
        raise ValueError("decode_sep needs N % C == 0, (N / C) % 4 == 0 and "
                         "chunk_starts[B, C]")
    if meta.shape != (32,) or vals.shape != (64,):
        raise ValueError("decode_sep needs meta int32[32] and vals int32[64]")
    if words.device.type == "cpu":
        return decode_sep_plain(words, chunk_starts, meta, vals, N, C)
    _build.require_cuda(words, chunk_starts, meta, vals)
    dev = words.device
    if stats is not None and (stats.shape != (5,) or stats.dtype != torch.int64
                              or stats.device != dev):
        raise ValueError("decode_sep: stats must be int64[5] on the words' "
                         "device")
    words = _build.i32(words)
    chunk_starts = _build.i32(chunk_starts)
    meta = _build.i32(meta)
    vals = _build.i32(vals)
    out = torch.empty(B, N, dtype=torch.uint8, device=dev)
    bpos = torch.empty(B, C, dtype=torch.int32, device=dev)
    if B * C == 0:
        return out, bpos
    _build.launch("decode_sep", dev, words.data_ptr(), chunk_starts.data_ptr(),
                  meta.data_ptr(), vals.data_ptr(), out.data_ptr(),
                  bpos.data_ptr(), None if stats is None else stats.data_ptr(),
                  B, W, N, C, dev.index)
    return out, bpos
