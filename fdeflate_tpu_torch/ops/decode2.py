"""K3 decode2: fixed-geometry decode straight from linear stream words.

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
"""

from __future__ import annotations

import torch

from .. import _build
from ..trees import CLS_LEN, CLS_LIT, MAXL

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
    words = words.to(torch.int32).contiguous()
    chunk_starts = chunk_starts.to(torch.int32).contiguous()
    out = torch.empty(B, N, dtype=torch.uint8, device=words.device)
    bpos = torch.empty(B, C, dtype=torch.int32, device=words.device)
    if B * C == 0:
        return out, bpos
    err = _build.library().fdt_decode2(
        words.data_ptr(), chunk_starts.data_ptr(), dtab.data_ptr(),
        out.data_ptr(), bpos.data_ptr(), B, W, N, C,
        torch.cuda.current_stream(words.device).cuda_stream)
    _build.check(err, "decode2")
    decode2.launches += 1
    return out, bpos


decode2.launches = 0
