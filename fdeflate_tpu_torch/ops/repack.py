"""K2 combine and K10 combine_grouped: lane windows -> linear stream words.

JAX counterparts: the TPU kernels ``fdeflate_tpu/ops/repack.py``
``_combine_kernel`` and ``_combine_kernel_grouped`` (via
``linear_from_rows`` with ``group=1`` and ``group > 1``, called by
``ops/ultrafast_kernel.py`` ``_pack_linear_words``), which place every lane
window at its stream bit offset.  The CUDA kernels are ``csrc/combine.cu``
(a warp per lane, each word stored once by the lane its first bit lies
in) and ``csrc/combine_grouped.cu`` (a warp per 1024-word output slab,
which finds the slab's lanes itself and stages their words);
``combine_plain`` is the plain version of both, and ``slab_lanes`` the
plain version of K10's lane search.

``pos0[lane]`` is the absolute bit at which lane ``b * C + k`` starts in
stream ``b``: the header bits plus the exclusive prefix sum of the stream's
``chunk_bits``.  Only a window's first ``ceil(chunk_bits / 32)`` words are
placed (the rest are zero).
"""

from __future__ import annotations

import torch

from .. import _build

SLAB = 1024          # words per output slab (K10's warp)
_MAX_GROUP = 32


def combine_plain(win: torch.Tensor, chunk_bits: torch.Tensor,
                  pos0: torch.Tensor, B: int, W: int) -> torch.Tensor:
    """Plain PyTorch K2: scatter-add of each shifted window word.

    Returns int32[B, W] payload words (u32 bit patterns).  Payload bits of
    different lanes are disjoint, so the add is the kernel's OR.
    """
    L, ww = win.shape
    C = L // B
    dev = win.device
    j = torch.arange(ww, device=dev)[None, :]
    used = j < ((chunk_bits.to(torch.int64) + 31) >> 5)[:, None]
    p = pos0.to(torch.int64)[:, None]
    x = torch.where(used, win.to(torch.int64) & 0xFFFFFFFF, 0) << (p & 31)
    row = torch.arange(L, device=dev)[:, None] // C
    flat = row * (W + 1) + (p >> 5) + j
    flat = torch.where(used, flat, 0)
    words = torch.zeros(B * (W + 1), dtype=torch.int64, device=dev)
    words.index_add_(0, flat.reshape(-1), (x & 0xFFFFFFFF).reshape(-1))
    words.index_add_(0, (flat + 1).reshape(-1), (x >> 32).reshape(-1))
    return words.reshape(B, W + 1)[:, :W].to(torch.int32)


def slab_lanes(chunk_bits: torch.Tensor, pos0: torch.Tensor, B: int,
               W: int):
    """(lo, hi) int32[B * nslabs]: the lanes [lo[s], hi[s]) that can touch
    1024-word output slab s (``nslabs = ceil(W / 1024)`` per stream), found
    by searches over the lanes' first and last payload words (JAX's
    ``searchsorted`` over origin slabs, ``repack.py:408-411``).  Lanes must
    start in order along each stream, as ``lane_starts`` gives them.  K10
    finds each slab's range on the card (``lanes.cuh`` ``slab_range``);
    this is its plain version."""
    L = pos0.shape[0]
    C = L // B
    dev = pos0.device
    nslabs = -(-W // SLAB)
    base = torch.arange(L, device=dev) // C * (nslabs * SLAB)
    p = pos0.to(torch.int64)
    first = base + (p >> 5)
    last = base + ((p + chunk_bits.to(torch.int64).clamp(min=1) - 1) >> 5)
    last = last.cummax(dim=0).values
    s0 = torch.arange(B * nslabs, device=dev) * SLAB
    lo = torch.searchsorted(last, s0, side="left")
    hi = torch.searchsorted(first, s0 + SLAB, side="left")
    return lo.to(torch.int32), hi.to(torch.int32)


def combine(win: torch.Tensor, chunk_bits: torch.Tensor, pos0: torch.Tensor,
            B: int, W: int, group: int = 1) -> torch.Tensor:
    """K2 (``group=1``) or K10 (``group > 1``) on ``win``'s device:
    int32[B, W] stream words, payload placed.

    ``win`` int32[L, wwin], ``chunk_bits`` / ``pos0`` int32[L], L = B * C.
    ``group`` is the counterpart of ``linear_from_rows(group=)``, validated
    as the TPU kernel's staging bounds it (1..32 lanes, two buffers of
    ``group * min(wwin, 1025)`` words within a block's 227 KiB); K10 stages
    the words that reach each slab, whatever ``group`` is.  Lanes start in
    order along each stream, each lane's payload ends at or before the next
    lane's start, and window bits past ``chunk_bits`` are zero, as
    ``lane_starts`` and K1 give them.  CPU tensors take ``combine_plain``; CUDA tensors launch
    ``csrc/combine.cu`` or ``csrc/combine_grouped.cu``, each of which writes
    every word once (no zero fill).
    """
    L, ww = win.shape
    if L % B or chunk_bits.shape != (L,) or pos0.shape != (L,):
        raise ValueError("combine needs win[B*C, wwin], chunk_bits/pos0[B*C]")
    if not 1 <= group <= _MAX_GROUP or 8 * group * min(ww, SLAB + 1) > 227 << 10:
        raise ValueError(f"combine: group {group} outside 1..{_MAX_GROUP} or "
                         "over the shared memory of a block")
    if win.device.type == "cpu":
        return combine_plain(win, chunk_bits, pos0, B, W)
    _build.require_cuda(win, chunk_bits, pos0)
    win = win.contiguous()
    chunk_bits = _build.i32(chunk_bits)
    pos0 = _build.i32(pos0)
    if group > 1:
        return combine_grouped(win, chunk_bits, pos0, B, W)
    if L == 0:
        return torch.zeros(B, W, dtype=torch.int32, device=win.device)
    words = torch.empty(B, W, dtype=torch.int32, device=win.device)
    _build.launch("combine", win.device, win.data_ptr(),
                  chunk_bits.data_ptr(), pos0.data_ptr(), words.data_ptr(), B,
                  L // B, ww, W)
    return words


def combine_grouped(win, chunk_bits, pos0, B: int, W: int):
    """K10 (``combine`` with ``group > 1`` on CUDA tensors, its checks
    done): one launch, a warp per 1024-word output slab, each finding the
    lanes that reach its slab on the card."""
    words = torch.empty(B, W, dtype=torch.int32, device=win.device)
    if words.numel() == 0:
        return words
    _build.launch("combine_grouped", win.device, win.data_ptr(),
                  chunk_bits.data_ptr(), pos0.data_ptr(), words.data_ptr(), B,
                  win.shape[0] // B, win.shape[1], W)
    return words
