"""K1 assign_pack: stream bytes -> per-lane bit windows and chunk bits.

JAX counterparts:
  * ``assign_tokens`` <- ``fdeflate_tpu/ops/ultrafast_kernel.py``
    ``_assign_tokens`` with ``split_S = S`` (the XLA token assignment);
  * ``assign_pack`` <- the TPU kernels ``ops/pallas_assign.py:_kernel``
    and ``ops/pallas_pack.py:_kernel_v2`` (via ``assign_tokens_blocked``
    and ``pack_blocked_pallas_v2``).  The CUDA kernel is
    ``csrc/assign_pack.cu``; ``assign_pack_plain`` is its plain version.

A lane is one S-byte chunk of one stream (lane = b * C + k).  A lane's
window holds its tokens' bits from bit 0, zeros past them:
``wwin(S) = ceil(13 * S / 32)`` words, since no byte emits more than 13
bits.  ``chunk_bits[lane]`` is the lane's payload bit count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..tables import LENGTH_TO_LEN_EXTRA, LENGTH_TO_SYMBOL
from ..trees import NB_SHIFT, TreeTables

_TOK_MASK = (1 << NB_SHIFT) - 1

# Run tail T (3..258) -> length symbol - 257 and its extra-bit count.
_TAIL_SYM = np.zeros(259, np.int64)
_TAIL_SYM[3:] = LENGTH_TO_SYMBOL - 257
_TAIL_EXTRA = np.zeros(259, np.int64)
_TAIL_EXTRA[3:] = LENGTH_TO_LEN_EXTRA


def wwin(S: int) -> int:
    """Window words per lane: the worst case of 13 bits per byte."""
    return (13 * S + 31) // 32


class Runs(NamedTuple):
    """Per-byte run structure of the token grammar (int64/bool [B, N])."""

    d: torch.Tensor          # the bytes
    member: torch.Tensor     # byte belongs to a zero run
    is_first: torch.Tensor   # the run's opening literal zero
    is_285: torch.Tensor     # a 258-byte block's length-285 token
    at_sym: torch.Tensor     # the tail's length symbol (tail >= 5)
    at_extra: torch.Tensor   # the tail's extra-bits token
    small_tail: torch.Tensor  # one of the tail's <= 4 literal zeros
    tail: torch.Tensor       # the run's tail length, per byte
    in_stream: torch.Tensor  # byte index < length
    in_aligned: torch.Tensor  # byte index < length // 8 * 8


def runs(data: torch.Tensor, lengths: torch.Tensor, S: int) -> Runs:
    """The run structure of ``_assign_tokens(..., split_S=S)``: 8-byte-chunk
    run membership below the aligned length, runs cut at every S-byte lane
    boundary, each run a literal zero, one 285 token per further 258 bytes
    and its tail.  Tree-independent."""
    B, N = data.shape
    dev = data.device
    d = data.to(torch.int64)
    lengths = lengths.to(torch.int64)
    aligned = lengths // 8 * 8

    # ---- 8-byte-chunk run membership ------------------------------------
    nz = d.reshape(B, N // 8, 8) != 0
    offs8 = torch.arange(8, device=dev).expand(B, N // 8, 8)
    chunk_zero = ~nz.any(dim=2)
    tfirst = torch.where(nz, offs8, 8).amin(dim=2)
    last_nz = torch.where(nz, offs8, -1).amax(dim=2)
    l = torch.where(chunk_zero, 8, 7 - last_nz)
    false_col = torch.zeros(B, 1, dtype=torch.bool, device=dev)
    prev_zero = torch.cat([false_col, chunk_zero[:, :-1]], dim=1)
    prev_l = torch.cat([torch.zeros_like(l[:, :1]), l[:, :-1]], dim=1)
    prev_run = prev_zero | (prev_l > 0)
    member = (chunk_zero[:, :, None]
              | ((offs8 < tfirst[:, :, None]) & prev_run[:, :, None])
              | (offs8 >= (8 - l)[:, :, None])).reshape(B, N)
    idx = torch.arange(N, device=dev)[None, :]
    in_aligned = idx < aligned[:, None]
    member = member & in_aligned

    # ---- run segments, cut at every S-byte lane boundary -----------------
    prev_member = torch.cat([false_col, member[:, :-1]], dim=1)
    start_flag = member & ~prev_member
    seg_start = torch.cummax(torch.where(start_flag, idx, -1), dim=1).values
    nxt = torch.where(~member, idx, N)
    seg_end = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    seg_end = torch.minimum(seg_end, aligned[:, None])
    cstart = idx // S * S
    seg_start = torch.maximum(seg_start, cstart)
    seg_end = torch.minimum(seg_end, cstart + S)

    p = idx - seg_start
    q = p - 1
    run1 = seg_end - seg_start - 1
    tail = run1 - run1 // 258 * 258
    q0 = run1 - tail
    big_tail = member & (tail > 4)
    return Runs(
        d=d, member=member,
        is_first=member & (p == 0),
        is_285=member & (p > 0) & (q - q // 258 * 258 == 257),
        at_sym=big_tail & (q == q0),
        at_extra=big_tail & (q == q0 + 1),
        small_tail=member & (tail > 0) & (tail <= 4) & (q >= q0)
        & (q < q0 + tail),
        tail=tail, in_stream=idx < lengths[:, None], in_aligned=in_aligned)


def assign_tokens(data: torch.Tensor, lengths: torch.Tensor, S: int,
                  t: TreeTables):
    """Per-byte tokens, twin of ``_assign_tokens(..., split_S=S)``.

    Returns int64 ``(v, nb, at_extra)`` of shape [B, N]: token bits, token
    bit counts and the extra-bits-token mask.
    """
    r = runs(data, lengths, S)
    dev = data.device
    lit = t.lit_tok.to(torch.int64)[r.d]
    zlit = t.lit_tok[0].to(torch.int64)
    t285 = t.len_tok[28].to(torch.int64) + (1 << NB_SHIFT)   # + distance bit
    v = torch.where(r.member, 0, lit & _TOK_MASK)
    nb = torch.where(r.member, 0, lit >> NB_SHIFT)

    zero_lit = r.is_first | r.small_tail
    v = torch.where(zero_lit, zlit & _TOK_MASK, v)
    nb = torch.where(zero_lit, zlit >> NB_SHIFT, nb)
    v = torch.where(r.is_285, t285 & _TOK_MASK, v)
    nb = torch.where(r.is_285, t285 >> NB_SHIFT, nb)

    tl = r.tail.clamp(0, 258)
    sym_tok = t.len_tok.to(torch.int64)[torch.as_tensor(_TAIL_SYM, device=dev)[tl]]
    tail_extra = torch.as_tensor(_TAIL_EXTRA, device=dev)[tl]
    v = torch.where(r.at_sym, sym_tok & _TOK_MASK, v)
    nb = torch.where(r.at_sym, sym_tok >> NB_SHIFT, nb)
    v = torch.where(r.at_extra, (r.tail - 3) & ((1 << tail_extra) - 1), v)
    nb = torch.where(r.at_extra, tail_extra + 1, nb)

    # Bytes past the aligned length are literals; padding emits nothing.
    is_rem = ~r.in_aligned & r.in_stream
    v = torch.where(is_rem, lit & _TOK_MASK, v)
    nb = torch.where(is_rem, lit >> NB_SHIFT, nb)
    nb = torch.where(r.in_stream, nb, 0)
    v = torch.where(nb > 0, v, 0)
    return v, nb, r.at_extra


def token_symbols(data: torch.Tensor, lengths: torch.Tensor,
                  S: int) -> torch.Tensor:
    """int64[B, N] DEFLATE symbol per byte, -1 where the byte emits none
    (mid-run bytes, extra bits, padding): the ``return_syms`` output of
    ``_assign_tokens(..., split_S=S)``."""
    r = runs(data, lengths, S)
    tail_sym = torch.as_tensor(_TAIL_SYM + 257, device=data.device)
    sym = torch.where(r.member | ~r.in_stream, -1, r.d)
    sym = torch.where(r.is_first | r.small_tail, 0, sym)
    sym = torch.where(r.at_sym, tail_sym[r.tail.clamp(0, 258)], sym)
    return torch.where(r.is_285, 285, sym)


def assign_pack_plain(data: torch.Tensor, lengths: torch.Tensor, C: int,
                      t: TreeTables):
    """Plain PyTorch K1: tokens, pair-combine, scatter-add into windows.

    Bits of different pairs are disjoint, so the add is the OR the kernel
    does.  Returns (win int32[L, wwin], chunk_bits int32[L]).
    """
    B, N = data.shape
    S = N // C
    L = B * C
    v, nb, _ = assign_tokens(data, lengths, S, t)
    v = v.reshape(L, S)
    nb = nb.reshape(L, S)
    cum = nb.cumsum(dim=1)
    n0 = nb[:, 0::2]
    npair = n0 + nb[:, 1::2]
    vp = v[:, 0::2] | (v[:, 1::2] << n0)
    rel = cum[:, 1::2] - npair                   # lane-relative pair starts
    x = vp << (rel & 31)                         # <= 26 + 31 bits
    wi = rel >> 5
    ww = wwin(S)
    win = torch.zeros(L, ww + 1, dtype=torch.int64, device=data.device)
    win.scatter_add_(1, wi, x & 0xFFFFFFFF)
    win.scatter_add_(1, wi + 1, x >> 32)
    # int64 -> int32 keeps the low 32 bits: the u32 word's bit pattern.
    return win[:, :ww].to(torch.int32), cum[:, -1].to(torch.int32)


def assign_pack(data: torch.Tensor, lengths: torch.Tensor, C: int,
                t: TreeTables):
    """K1 on ``data``'s device: (win int32[L, wwin], chunk_bits int32[L]).

    ``data`` u8[B, N] zero-padded past ``lengths`` i32[B]; N % C == 0 and
    S = N / C a multiple of 8.  CPU tensors take ``assign_pack_plain``;
    CUDA tensors launch ``csrc/assign_pack.cu``.
    """
    B, N = data.shape
    if data.dtype != torch.uint8 or N % C or (N // C) % 8:
        raise ValueError("assign_pack needs u8[B, N] with (N / C) % 8 == 0")
    if data.device.type == "cpu":
        return assign_pack_plain(data, lengths, C, t)
    _build.require_cuda(data, lengths, t.lit_tok, t.len_tok)
    S = N // C
    L = B * C
    ww = wwin(S)
    data = data.contiguous()
    if data.data_ptr() % 8:  # the kernel loads 8 bytes at a time
        data = data.clone()
    lengths = _build.i32(lengths)
    win = torch.empty(L, ww, dtype=torch.int32, device=data.device)
    chunk_bits = torch.empty(L, dtype=torch.int32, device=data.device)
    if L == 0:
        return win, chunk_bits
    _build.launch(
        "assign_pack", data.device, data.data_ptr(), lengths.data_ptr(),
        t.lit_tok.data_ptr(), t.len_tok.data_ptr(), win.data_ptr(),
        chunk_bits.data_ptr(), B, N, C, ww)
    return win, chunk_bits
