"""K9 pack_v1: packed byte tokens -> lane bit windows (the v1 pack).

JAX counterparts (``fdeflate_tpu/ops/pallas_pack.py``): ``pack_tokens``
:281 and the TPU kernel ``_kernel`` :35 (via ``pack_blocked_pallas`` :76),
the all-pairs pack the JAX package keeps for A/B beside the linear
``_kernel_v2`` (which the port has in K1).  The CUDA kernel is
``csrc/pack_v1.cu``, the same function as a linear scatter (each pair ORs
its two words into the window); ``pack_blocked_plain`` is its plain
version, the TPU kernel's all-pairs select-accumulate.

A token packs one byte's code bits, bit count and lane-relative bit offset
into one int32, ``v | nb << 13 | rel << 18``; ``rel`` has 13 bits, so a
lane holds at most 630 bytes.  Tokens are lane-major ``int32[L, S]`` (lane
``b * C + k``), the port's row layout, where JAX lays them out
``[LB, S, 8, 128]``.  The windows equal K1's at the same C
(``assign_pack``): bit 0 at the lane's first token, zeros past its last.
"""

from __future__ import annotations

import torch

from .. import _build
from ..trees import TreeTables
from .assign_pack import assign_tokens, wwin

_REL_BITS = 13
_MASK32 = 0xFFFFFFFF


def pack_tokens(v: torch.Tensor, nb: torch.Tensor, rel: torch.Tensor,
                C: int) -> torch.Tensor:
    """Per-byte tokens ``v | nb << 13 | rel << 18`` as int32[B * C, S].

    ``v``, ``nb``, ``rel`` are [B, N] (``rel`` lane-relative, as
    ``token_offsets`` gives it).  Raises ValueError where ``13 * S`` does
    not fit the 13 bits of ``rel`` (S > 630), where JAX asserts.
    """
    B, N = v.shape
    S = N // C
    if N % C or 13 * S >= 1 << _REL_BITS:
        raise ValueError("pack_tokens needs N % C == 0 and 13 * S < 8192 "
                         "(S <= 630): rel must fit 13 bits")
    rel = rel.to(torch.int64).clamp(0, (1 << _REL_BITS) - 1)
    tok = v.to(torch.int64) | (nb.to(torch.int64) << 13) | (rel << 18)
    return tok.to(torch.int32).reshape(B * C, S)


def token_offsets(nb: torch.Tensor, C: int) -> torch.Tensor:
    """int64[B, N] lane-relative start bit of every byte's token: the
    exclusive prefix sum of ``nb`` within each S-byte lane."""
    B, N = nb.shape
    lanes = nb.to(torch.int64).reshape(B * C, N // C)
    return (lanes.cumsum(dim=1) - lanes).reshape(B, N)


def encode_blocked_v1(data: torch.Tensor, lengths: torch.Tensor, C: int,
                      t: TreeTables):
    """The A/B encode: ``assign_tokens`` -> ``pack_tokens`` -> K9.

    Returns (win int32[L, wwin(S)], chunk_bits int32[L]), equal to K1's
    ``assign_pack(data, lengths, C, t)``; needs S = N / C <= 630.
    """
    B, N = data.shape
    v, nb, _ = assign_tokens(data, lengths, N // C, t)
    tok = pack_tokens(v, nb, token_offsets(nb, C), C)
    win = pack_blocked(tok, wwin(N // C))
    return win, nb.reshape(B * C, N // C).sum(dim=1).to(torch.int32)


def _pairs(tok: torch.Tensor):
    """(wi, lo, hi) int64[L, S/2] of every token pair (``fdt::pack_pair``):
    window word (-3 for an empty pair) and the pair's bits shifted to its
    offset, low and high word."""
    t = tok.to(torch.int64)
    t0, t1 = t[:, 0::2], t[:, 1::2]
    n0 = (t0 >> 13) & 0x1F
    n1 = (t1 >> 13) & 0x1F
    vp = ((t0 & 0x1FFF) | ((t1 & 0x1FFF) << n0)) & _MASK32
    rel = t0 >> 18
    sh = rel & 31
    lo = (vp << sh) & _MASK32
    hi = (vp >> 1) >> (31 - sh)
    wi = torch.where(n0 + n1 > 0, rel >> 5, -3)
    return wi, lo, hi


def pack_blocked_plain(tok: torch.Tensor, wwin: int) -> torch.Tensor:
    """Plain PyTorch K9: the same select-accumulate, one pair of every
    lane per iteration against all ``wwin`` words.  int32[L, wwin]."""
    L, S = tok.shape
    wi, lo, hi = _pairs(tok)
    w = torch.arange(wwin, device=tok.device)[None, :]
    win = torch.zeros(L, wwin, dtype=torch.int64, device=tok.device)
    for p in range(S // 2):
        win |= torch.where(wi[:, p : p + 1] == w, lo[:, p : p + 1], 0)
        win |= torch.where(wi[:, p : p + 1] == w - 1, hi[:, p : p + 1], 0)
    # int64 -> int32 keeps the low 32 bits: the u32 word's bit pattern.
    return win.to(torch.int32)


def pack_blocked(tok: torch.Tensor, wwin: int) -> torch.Tensor:
    """K9 on ``tok``'s device: int32[L, wwin] lane windows.

    ``tok`` int32[L, S] from ``pack_tokens`` (S even, at most 630).  Any
    ``wwin`` (JAX needs a multiple of 8 for its 8-word groups; the CUDA
    kernel has none).  CPU tensors take ``pack_blocked_plain``; CUDA
    tensors launch ``csrc/pack_v1.cu``.
    """
    L, S = tok.shape
    if S % 2 or 13 * S >= 1 << _REL_BITS or wwin < 1:
        raise ValueError("pack_blocked needs tok[L, S] with S even, "
                         "S <= 630, and wwin >= 1")
    if tok.device.type == "cpu":
        return pack_blocked_plain(tok, wwin)
    _build.require_cuda(tok)
    tok = tok.to(torch.int32).contiguous()
    win = torch.empty(L, wwin, dtype=torch.int32, device=tok.device)
    if L == 0:
        return win
    _build.launch("pack_v1", tok.device, tok.data_ptr(), win.data_ptr(), L,
                  S, wwin, tok.device.index)
    return win
