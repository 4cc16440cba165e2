"""K3 decode2 and K8 decode2_canon: fixed-geometry decode, and
``decode_blocked``, the decode of lane windows.

JAX counterparts: the TPU kernel
``fdeflate_tpu/ops/pallas_decode2.py:_kernel_light`` (via ``decode_blocked``,
light and fast), with the window staging before it folded in: the TPU
kernel ``ops/repack.py:_slab_kernel`` and the XLA log-shift and bit shift
of ``repack.stage_blocked_from_linear``.  The CUDA kernel is
``csrc/decode2.cu``; ``decode2_plain`` is its plain version, a loop over
decode steps vectorised across lanes.

Lane ``b * C + k`` reads stream ``b`` from bit ``chunk_starts[b, k]`` and
writes exactly S = N / C bytes to ``out[b, k*S : (k+1)*S]`` (standard
[B, N] byte order).  Semantics are ``_kernel_light``'s: literals; zero runs
(length base + extra bits, the 1 distance bit consumed unchecked); a run
overrunning the lane is cut at S with all its bits counted; on EOB the lane
stalls and writes zeros to its end.  Words at or past W read as 0.  The
decode table is ``trees.decode_table`` (one entry per 12-bit peek).

K8 (``decode2_canon``) is the counterpart of the TPU kernel
``pallas_decode2.py:_kernel``, the unrolled body that ``decode_blocked``
runs with ``light=False``: the same contract on lane windows, with the
canonical compare chain and the 512-entry symbol table of
``canonical_meta`` in place of K3's 4096-entry peek table.  The CUDA kernel
is ``csrc/decode2_canon.cu``, K3's group decode with a table built from
those rows (a table that breaks K3's protocol, ``canon_unsafe``, is decoded
one thread per lane); ``decode2_canon_plain`` is its plain version, a loop
over word steps and sub-steps vectorised across lanes.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..tables import HUFFMAN_LENGTHS
from ..trees import (
    CLS_LEN,
    CLS_LIT,
    MAXL,
    TAB_PAD,
    TreeTables,
    _bitrev,
    canonical_meta,
    peek_index,
    trained_tables,
)

_MASK32 = 0xFFFFFFFF


def decode2_plain(words: torch.Tensor, chunk_starts: torch.Tensor,
                  dtab: torch.Tensor, N: int, C: int):
    """Plain PyTorch K3: one decode step for every live lane per iteration.

    Returns (out u8[B, N], bpos int32[B, C]) — bpos is each lane's exit bit
    relative to its start.
    """
    B, W = words.shape
    S = N // C
    L = B * C
    dev = words.device
    # Two zero words past each row: reads at or past W see zeros.
    w64 = torch.cat([words.to(torch.int64) & _MASK32,
                     torch.zeros(B, 2, dtype=torch.int64, device=dev)], dim=1)
    w64 = w64.reshape(-1)
    lane = torch.arange(L, device=dev)
    row0 = lane // C * (W + 2)
    start = chunk_starts.reshape(-1).to(torch.int64)
    dt = dtab.to(torch.int64)
    pos = torch.zeros(L, dtype=torch.int64, device=dev)
    opos = torch.zeros(L, dtype=torch.int64, device=dev)
    live = torch.ones(L, dtype=torch.bool, device=dev)
    out = torch.zeros(L * S + 1, dtype=torch.int64, device=dev)  # +1: dump
    while True:
        live &= opos < S
        if not bool(live.any()):
            break
        a = start + pos
        wi = a >> 5
        wi = torch.where((wi >= 0) & (wi < W), wi, W)
        sh = a & 31
        bits = w64[row0 + wi] >> sh
        bits |= torch.where(sh > 0, (w64[row0 + wi + 1] << (32 - sh)) & _MASK32, 0)
        e = dt[bits & ((1 << MAXL) - 1)]
        nbits = (e >> 16) & 0x1F
        cls = (e >> 13) & 3
        val = e & 0x1FF
        extra = (e >> 9) & 0xF
        is_lit = live & (cls == CLS_LIT)
        is_run = live & (cls == CLS_LEN)
        out.scatter_(0, torch.where(is_lit, lane * S + opos, L * S), val)
        run = val + ((bits >> nbits) & ((1 << extra) - 1))
        opos += torch.where(is_lit, 1,
                            torch.where(is_run, torch.minimum(run, S - opos), 0))
        pos += torch.where(is_lit, nbits,
                           torch.where(is_run, nbits + extra + 1, 0))
        live = is_lit | is_run      # EOB (or anything else) stalls
    return (out[: L * S].to(torch.uint8).reshape(B, N),
            pos.to(torch.int32).reshape(B, C))


def decode2(words: torch.Tensor, chunk_starts: torch.Tensor,
            dtab: torch.Tensor, N: int, C: int):
    """K3 on ``words``' device: (out u8[B, N], bpos int32[B, C]).

    ``words`` int32[B, W] stream words (u32 bit patterns), ``chunk_starts``
    int32[B, C] absolute lane start bits, ``dtab`` int32[4096].  CPU
    tensors take ``decode2_plain``; CUDA tensors launch ``csrc/decode2.cu``.
    """
    B, W = words.shape
    if N % C or (N // C) % 4 or chunk_starts.shape != (B, C):
        raise ValueError("decode2 needs N % C == 0, (N / C) % 4 == 0 and "
                         "chunk_starts[B, C]")
    if words.device.type == "cpu":
        return decode2_plain(words, chunk_starts, dtab, N, C)
    _build.require_cuda(words, chunk_starts, dtab)
    words = _build.i32(words)
    chunk_starts = _build.i32(chunk_starts)
    out = torch.empty(B, N, dtype=torch.uint8, device=words.device)
    bpos = torch.empty(B, C, dtype=torch.int32, device=words.device)
    if B * C == 0:
        return out, bpos
    _build.launch("decode2", words.device, words.data_ptr(),
                  chunk_starts.data_ptr(), dtab.data_ptr(), out.data_ptr(),
                  bpos.data_ptr(), B, W, N, C, words.device.index)
    return out, bpos


@functools.lru_cache(maxsize=8)
def canon_tables(device: str = "cpu"):
    """K8's tables of the trained tree on ``device``: (meta int32[32]:
    bounds at 0..12, kvals at 16..28; packed int32[512])."""
    bounds, kvals, packed = canonical_meta(torch.from_numpy(HUFFMAN_LENGTHS))
    meta = torch.zeros(32, dtype=torch.int64)
    meta[: MAXL + 1] = bounds
    meta[16 : 16 + MAXL + 1] = kvals
    dev = torch.device(device)
    return meta.to(torch.int32).to(dev), packed.to(torch.int32).to(dev)


def decode2_canon_plain(win: torch.Tensor, T: int, meta: torch.Tensor,
                        packed: torch.Tensor):
    """Plain PyTorch K8: T word steps of four sub-steps, every lane at once
    (``fdt::decode_canon_lane``).  Returns (out u8[L, 4T], bpos int32[L])."""
    L, ww = win.shape
    dev = win.device
    # Two zero words past each row: reads at or past wwin see zeros.
    w64 = torch.cat([win.to(torch.int64) & _MASK32,
                     torch.zeros(L, 2, dtype=torch.int64, device=dev)], dim=1)
    bounds = meta.to(torch.int64)[:MAXL]
    kvals = meta.to(torch.int64)[16 : 16 + MAXL + 1]
    tab = torch.cat([packed.to(torch.int64),
                     torch.zeros(1, dtype=torch.int64, device=dev)])
    rows = torch.arange(L, device=dev)
    pos = torch.zeros(L, dtype=torch.int64, device=dev)
    run = torch.zeros(L, dtype=torch.int64, device=dev)
    out = torch.zeros(L, T, dtype=torch.int64, device=dev)
    for u in range(T):
        word = torch.zeros(L, dtype=torch.int64, device=dev)
        filled = torch.zeros(L, dtype=torch.int64, device=dev)
        for _s in range(4):
            take = torch.minimum(run, 4 - filled)
            filled += take
            run -= take
            need = (filled < 4) & (run == 0)
            wi = (pos >> 5).clamp(max=ww)
            sh = pos & 31
            bits = w64[rows, wi] >> sh
            bits |= torch.where(sh > 0, (w64[rows, wi + 1] << (32 - sh))
                                & _MASK32, 0)
            r12 = _bitrev(bits & ((1 << MAXL) - 1), MAXL)
            Lc = 1 + (r12[:, None] >= bounds[None, 1:MAXL]).sum(dim=1)
            idx = kvals[Lc] + (r12 >> (MAXL - Lc))
            e = tab[torch.where((idx >= 0) & (idx < TAB_PAD), idx, TAB_PAD)]
            val = e & 0x1FF
            extra = (e >> 9) & 0xF
            cls = e >> 13
            is_lit = need & (cls == CLS_LIT)
            is_run = need & (cls == CLS_LEN)
            word |= torch.where(is_lit, val << (8 * filled), 0)
            filled += is_lit.to(torch.int64)
            run = torch.where(is_run, val + ((bits >> Lc) & ((1 << extra) - 1)),
                              run)
            pos += torch.where(is_lit, Lc, torch.where(is_run, Lc + extra + 1, 0))
        run -= torch.minimum(run, 4 - filled)
        out[:, u] = word
    # int64 -> int32 keeps the low 32 bits; the words' bytes are the output.
    out = out.to(torch.int32).view(torch.uint8).reshape(L, 4 * T)
    return out, pos.to(torch.int32)


def canon_unsafe(meta: torch.Tensor, packed: torch.Tensor) -> bool:
    """Whether K8's CUDA kernel decodes every lane of this table serially
    (``fdt::canon_unsafe``): some 12-bit peek's entry is a literal above
    255 or a run of base below 3, where K3's group decode and K8's word
    steps part.  False for ``canon_tables()``."""
    m = meta.to(torch.int64)
    _L, idx = peek_index(m[: MAXL + 1], m[16 : 16 + MAXL + 1])
    tab = packed.to(torch.int64)
    e = torch.where((idx >= 0) & (idx < TAB_PAD),
                    tab[idx.clamp(0, TAB_PAD - 1)], 0)
    cls, val = e >> 13, e & 0x1FF
    return bool((((cls == CLS_LIT) & (val > 255))
                 | ((cls == CLS_LEN) & (val < 3))).any())


def decode2_canon(win: torch.Tensor, T: int, meta: torch.Tensor,
                  packed: torch.Tensor, stats=None):
    """K8 on ``win``'s device: (out u8[L, 4T], bpos int32[L]).

    ``win`` int32[L, wwin] lane windows (bit 0 at each lane's chunk start;
    words past ``wwin`` read as 0), ``meta``/``packed`` from
    ``canon_tables``.  CPU tensors take ``decode2_canon_plain``; CUDA
    tensors launch ``csrc/decode2_canon.cu`` (K3's group decode with the
    table of these rows; every lane one thread where ``canon_unsafe``).
    ``stats``: None, or a zeroed int64[5] on the card that the kernel fills
    with its spans' counts (most sync rounds of a span, spans, spans
    another span continues, sync rounds) and the lanes it decoded serially.
    """
    L, ww = win.shape
    if meta.shape != (32,) or packed.shape != (TAB_PAD,):
        raise ValueError("decode2_canon needs meta[32] and packed[512]")
    if win.device.type == "cpu":
        return decode2_canon_plain(win, T, meta, packed)
    _build.require_cuda(win, meta, packed)
    dev = win.device
    if stats is not None and (stats.shape != (5,) or stats.dtype != torch.int64
                              or stats.device != dev):
        raise ValueError("decode2_canon: stats must be int64[5] on the "
                         "windows' device")
    win = _build.i32(win)
    out = torch.empty(L, 4 * T, dtype=torch.uint8, device=dev)
    bpos = torch.empty(L, dtype=torch.int32, device=dev)
    if L == 0 or T == 0:
        return out, bpos.zero_()
    meta = _build.i32(meta)
    packed = _build.i32(packed)
    _build.launch("decode2_canon", dev, win.data_ptr(), meta.data_ptr(),
                  packed.data_ptr(), out.data_ptr(), bpos.data_ptr(),
                  None if stats is None else stats.data_ptr(), L, ww, T,
                  dev.index)
    return out, bpos


def decode_blocked(win: torch.Tensor, T: int, U: int = 32, lane_major=None,
                   light: bool = True, tables: TreeTables | None = None,
                   R: int | None = None, fast: bool | None = None):
    """Decode fixed-geometry lane windows (JAX ``pallas_decode2.
    decode_blocked`` :1012).  Returns (out u8[L, 4T], bpos int32[L]).

    ``win`` int32[L, wwin]: lane ``b * C + k``'s window, bit 0 at its chunk
    start (the port's row layout; JAX takes ``[LB, wwin, 8, 128]``).
    ``out`` is in standard byte order (``out.reshape(B, N)``) where JAX
    returns the TPU kernel's words, step- or lane-major.

    ``light=True``, with any ``fast``: K3 on each row from bit 0, with the
    trained tree's table or, given ``tables`` (a ``trees.TreeTables``, as
    ``ops/adaptive.encode_adaptive_blocked`` returns; JAX takes its
    (meta, tabp) rows), that tree's.  ``fast`` picks a body of the one TPU
    kernel ``_kernel_light``, whose counterpart is K3.  ``light=False``: K8,
    the trained tree only; ``tables`` then raises ValueError (JAX asserts).
    ``U``, ``R`` and ``lane_major`` size the TPU kernel's grid and output
    block; they are accepted and ignored.
    """
    L, _ww = win.shape
    if not light:
        if tables is not None:
            raise ValueError("runtime tables need the light kernel")
        meta, packed = canon_tables(str(win.device))
        return decode2_canon(win, T, meta, packed)
    t = trained_tables(str(win.device)) if tables is None else tables
    starts = torch.zeros(L, 1, dtype=torch.int32, device=win.device)
    out, bpos = decode2(win, starts, t.dtab, 4 * T, 1)
    return out, bpos.reshape(L)
