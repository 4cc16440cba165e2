"""Adler-32 for byte batches.

JAX counterparts:
  * ``adler32_batch`` <- ``fdeflate_tpu/ops/adler32.py`` ``adler32_jax``
    (vmapped by ``ops/ultrafast_kernel.py`` ``adler32_batch``): the masked
    checksum of each stream's first ``lengths[b]`` bytes.  On CUDA tensors
    it is one launch of K7 (``ops/adler32_pallas.adler32_checksums``),
    which folds its tile sums itself; CPU tensors take
    ``adler32_batch_plain``;
  * ``adler_lanes`` <- ``fdeflate_tpu/ops/pallas_decode2.py``
    ``adler_step_major``: the decode side's checksum from per-lane sums
    over ALL S bytes of every lane, folded in order.  Bytes past a stream's
    length are not masked: they count with weight ``length - g`` (mod
    65521), exactly as the JAX fold counts them, so corrupted decodes that
    write past the length give the same verdict in both;
  * the partial fold under the mesh's ``checksum_tree_reduce``
    (``parallel/shard.py``): ``combine`` is a copy of the host ``combine``
    (:30), ``combine_tensor`` the tensor twin of ``combine_jax`` (:40),
    ``adler32_partial`` of ``adler32_partial_jax`` (:115, its checksum from
    ``adler32_batch``, so K7 on CUDA tensors) and ``combine_partials`` of
    ``combine_partials_jax`` (:126).  A partial is ``(A, B, len)``: the
    checksum's low and high halves and the byte count, each int64.

The plain versions use int64, where the JAX versions keep to int32 tile sums (a TPU
dtype limit, ``255 * S**2 < 2**31``); the results are identical.  Values
are returned as int64 tensors holding the u32 checksum.
"""

from __future__ import annotations

import torch

from .adler32_pallas import MOD, adler32_checksums


def adler32_batch(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """u8[B, N], i32[B] -> int64[B] Adler-32 of each stream's first
    ``lengths[b]`` bytes: K7 on CUDA tensors, the plain version on CPU
    tensors."""
    if data.device.type == "cpu":
        return adler32_batch_plain(data, lengths)
    return adler32_checksums(data, lengths)


def adler32_batch_plain(data: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``adler32_batch``: int64 sums over a masked copy."""
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


def combine(a1: int, a2: int, len2: int) -> int:
    """Combine adler32(x) and adler32(y) into adler32(x ++ y), where
    ``len2 = len(y)`` (copy of ``fdeflate_tpu/ops/adler32.py:30``)."""
    rem = len2 % MOD
    s1a, s2a = a1 & 0xFFFF, (a1 >> 16) & 0xFFFF
    s1b, s2b = a2 & 0xFFFF, (a2 >> 16) & 0xFFFF
    s1 = (s1a + s1b - 1) % MOD
    s2 = (s2a + s2b + rem * (s1a - 1) - 0) % MOD
    return ((s2 % MOD) << 16) | s1


def combine_tensor(a1, a2, len2) -> torch.Tensor:
    """``combine`` on tensors (JAX ``combine_jax`` :40): u32 checksums and
    lengths below 2**32, held in int64; returns the int64 u32 checksum."""
    a1, a2, len2 = (torch.as_tensor(x).to(torch.int64) for x in (a1, a2, len2))
    rem = len2 % MOD
    s1a, s2a = a1 & 0xFFFF, (a1 >> 16) & 0xFFFF
    s1b, s2b = a2 & 0xFFFF, (a2 >> 16) & 0xFFFF
    s1 = (s1a + s1b + (MOD - 1)) % MOD
    s2 = (s2a + s2b + rem * ((s1a + (MOD - 1)) % MOD)) % MOD
    return (s2 << 16) | s1


def adler32_partial(data, length=None):
    """Partial state ``(A, B, len)`` of each row of u8[..., N] (JAX
    ``adler32_partial_jax`` :115, which takes one row): the checksum of the
    first ``length`` bytes (all N when None) split into its halves, and
    ``len``, each int64 of shape ``data.shape[:-1]``.  The checksum is
    ``adler32_batch``'s: one K7 launch on CUDA tensors."""
    data = torch.as_tensor(data).to(torch.uint8)
    shape, N = data.shape[:-1], data.shape[-1]
    rows = data.reshape(-1, N)
    n = torch.as_tensor(N if length is None else length,
                        device=data.device).to(torch.int64)
    n = n.expand(shape).reshape(-1)
    checksum = adler32_batch(rows, n.to(torch.int32))
    return ((checksum & 0xFFFF).reshape(shape), (checksum >> 16).reshape(shape),
            n.reshape(shape))


def combine_partials(p1, p2):
    """Associative combine of two ``(A, B, len)`` partial states (JAX
    ``combine_partials_jax`` :126), in int64."""
    a1, b1, n1 = p1
    a2, b2, n2 = p2
    a = (a1 + a2 - 1) % MOD
    cross = ((n2 % MOD) * ((a1 - 1 + MOD) % MOD)) % MOD
    return a, (b1 + b2 + cross) % MOD, n1 + n2
