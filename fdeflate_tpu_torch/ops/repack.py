"""K2 combine: lane windows -> linear stream words.

JAX counterpart: the TPU kernel ``fdeflate_tpu/ops/repack.py:_combine_kernel``
(via ``linear_from_rows``, called by ``ops/ultrafast_kernel.py``
``_pack_linear_words``), which places every lane window at its stream bit
offset.  The CUDA kernel is ``csrc/combine.cu``; ``combine_plain`` is its
plain version.

``pos0[lane]`` is the absolute bit at which lane ``b * C + k`` starts in
stream ``b``: the header bits plus the exclusive prefix sum of the stream's
``chunk_bits``.  Only a window's first ``ceil(chunk_bits / 32)`` words are
placed (the rest are zero).
"""

from __future__ import annotations

import torch

from .. import _build


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


def combine(win: torch.Tensor, chunk_bits: torch.Tensor, pos0: torch.Tensor,
            B: int, W: int) -> torch.Tensor:
    """K2 on ``win``'s device: int32[B, W] stream words, payload placed.

    ``win`` int32[L, wwin], ``chunk_bits`` / ``pos0`` int32[L], L = B * C.
    CPU tensors take ``combine_plain``; CUDA tensors launch
    ``csrc/combine.cu`` into a zeroed word buffer.
    """
    L, ww = win.shape
    if L % B or chunk_bits.shape != (L,) or pos0.shape != (L,):
        raise ValueError("combine needs win[B*C, wwin], chunk_bits/pos0[B*C]")
    if win.device.type == "cpu":
        return combine_plain(win, chunk_bits, pos0, B, W)
    _build.require_cuda(win, chunk_bits, pos0)
    win = win.contiguous()
    chunk_bits = chunk_bits.to(torch.int32).contiguous()
    pos0 = pos0.to(torch.int32).contiguous()
    words = torch.zeros(B, W, dtype=torch.int32, device=win.device)
    if L == 0:
        return words
    err = _build.library().fdt_combine(
        win.data_ptr(), chunk_bits.data_ptr(), pos0.data_ptr(),
        words.data_ptr(), B, L // B, ww, W,
        torch.cuda.current_stream(win.device).cuda_stream)
    _build.check(err, "combine")
    combine.launches += 1
    return words


combine.launches = 0
