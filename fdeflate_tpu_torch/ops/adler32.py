"""Adler-32 for byte batches, in plain PyTorch.

JAX counterparts:
  * ``adler32_batch`` <- ``fdeflate_tpu/ops/adler32.py`` ``adler32_jax``
    (vmapped by ``ops/ultrafast_kernel.py`` ``adler32_batch``): the masked
    checksum of each stream's first ``lengths[b]`` bytes;
  * ``adler_lanes`` <- ``fdeflate_tpu/ops/pallas_decode2.py``
    ``adler_step_major``: the decode side's checksum from per-lane sums
    over ALL S bytes of every lane, folded in order.  Bytes past a stream's
    length are not masked: they count with weight ``length - g`` (mod
    65521), exactly as the JAX fold counts them, so corrupted decodes that
    write past the length give the same verdict in both.

Both use int64, where the JAX versions keep to int32 tile sums (a TPU
dtype limit, ``255 * S**2 < 2**31``); the results are identical.  Values
are returned as int64 tensors holding the u32 checksum.
"""

from __future__ import annotations

import torch

MOD = 65521


def adler32_batch(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """u8[B, N], i32[B] -> int64[B] Adler-32 of each stream's bytes."""
    B, N = data.shape
    length = lengths.to(torch.int64)[:, None]
    g = torch.arange(N, device=data.device, dtype=torch.int64)[None, :]
    d = torch.where(g < length, data.to(torch.int64), 0)
    a = (1 + d.sum(dim=1)) % MOD
    # (length - g) * d summed per row: <= 255 * N**2 / 2, far inside int64.
    b = (length[:, 0] + ((length - g) * d).sum(dim=1)) % MOD
    return (b << 16) | a


def adler_lanes(out: torch.Tensor, lengths: torch.Tensor, C: int) -> torch.Tensor:
    """Decode-side Adler-32 of u8[B, N] decoded bytes, N = C * S.

    Per lane (stream b, chunk k) the plain sum ``s`` and the weighted sum
    ``w = sum (S - i) * byte_i`` over all S bytes; the fold then weights
    lane k by ``(length - k*S - S) mod 65521``.
    """
    B, N = out.shape
    S = N // C
    d = out.reshape(B, C, S).to(torch.int64)
    s_k = d.sum(dim=2) % MOD
    wt = S - torch.arange(S, device=out.device, dtype=torch.int64)
    w_k = (d * wt).sum(dim=2) % MOD
    length = lengths.to(torch.int64)
    offs = torch.arange(C, device=out.device, dtype=torch.int64) * S
    coeff = (length[:, None] - offs[None, :] - S) % MOD
    a = (1 + s_k.sum(dim=1)) % MOD
    b = (length % MOD + ((coeff * s_k) % MOD + w_k).sum(dim=1)) % MOD
    return (b << 16) | a
