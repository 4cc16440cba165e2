"""Adaptive trees: a Huffman tree built on the device for each batch.

JAX counterpart: ``fdeflate_tpu/ops/adaptive.py``.  The chain

    symbol histogram -> length-limited optimal code lengths (DP)
    -> canonical LSB-first codes -> encode tokens and the decode table

runs in torch on the tensors' device, with no host read (no ``.item()``,
no data-dependent shapes), as the JAX chain is one XLA program.  The
encode then runs K1 (``ops/assign_pack.py``) with the tree's tokens, and
the decode K3 (``ops/decode2.py``) with its 4096-entry table, both runtime
inputs: the same kernels as the trained tree's.

Twins: ``symbol_freqs`` (:235), ``code_lengths_dp`` (:62),
``canonical_codes`` (:127, in ``trees``), ``decode_meta`` (:173, the JAX
decode kernel's (meta, tabp) rows, which the port's decode table
replaces), ``trees.code_tables`` (the encode tables of
``_runtime_tables`` :209, with the decode table beside them) and
``encode_adaptive_blocked`` (:253).
"""

from __future__ import annotations

import torch

from ..trees import (
    MAXL,
    NSYM,
    TAB_PAD,
    canonical_codes,
    canonical_meta,
    code_tables,
)
from .adler32 import adler32_batch
from .assign_pack import assign_pack, token_symbols

INF = 1 << 30


def symbol_freqs(data: torch.Tensor, lengths: torch.Tensor, S: int,
                 lut_matmul: bool | None = None) -> torch.Tensor:
    """int32[286] batch-wide DEFLATE symbol histogram of the token grammar
    with runs cut at every S-byte lane boundary, plus one EOB per stream.
    ``lut_matmul`` (a TPU lookup strategy, same result) is ignored."""
    del lut_matmul
    sym = token_symbols(data, lengths, S).reshape(-1)
    freqs = torch.zeros(NSYM + 1, dtype=torch.int32, device=data.device)
    freqs.scatter_add_(0, torch.where(sym >= 0, sym, NSYM),
                       torch.ones_like(sym, dtype=torch.int32))
    freqs[256] += data.shape[0]
    return freqs[:NSYM]


def code_lengths_dp(freqs: torch.Tensor, max_len: int = MAXL) -> torch.Tensor:
    """Length-limited optimal code lengths, on ``freqs``' device.

    Twin of the JAX DP: frequencies scaled into [0, 2^16] in float32
    (``ceil(f32(freqs) * (65536 / f32(total)))``, the division first), then
    a forward pass over symbols of the minimum cost per used code space
    (2^max_len + 1 offsets) and a backward pass that picks, per symbol,
    the smallest length that reaches the optimum.  Every symbol is coded,
    the code is complete.  Returns int32[n] lengths in [1, max_len].
    """
    dev = freqs.device
    n = freqs.shape[0]
    P = 1 << max_len
    total = freqs.to(torch.int64).sum().clamp(min=1).to(torch.float32)
    scale = torch.tensor(65536.0, dtype=torch.float32, device=dev) / total
    f = torch.ceil(freqs.to(torch.float32) * scale).to(torch.int64)
    bits = torch.arange(1, max_len + 1, device=dev)
    od = 1 << (max_len - bits)                       # code space per length
    cost = f[:, None] * bits[None, :]                # [n, max_len]
    # rows[s] = min cost of symbols < s per used code space; column P + 1
    # is an always-INF slot for offsets below zero.
    rows = torch.full((n + 1, P + 2), INF, dtype=torch.int64, device=dev)
    rows[0, 0] = 0
    j = torch.arange(P + 1, device=dev)
    src = j[None, :] - od[:, None]
    src = torch.where(src >= 0, src, P + 1)          # [max_len, P + 1]
    for s in range(n):
        cand = (rows[s][src] + cost[s][:, None]).clamp(max=INF)
        rows[s + 1, : P + 1] = cand.amin(dim=0)
    # One-element index tensors throughout: indexing with a 0-d tensor
    # would read it on the host.
    lens = torch.empty(n, dtype=torch.int64, device=dev)
    off = torch.full((1,), P, dtype=torch.int64, device=dev)
    for s in range(n - 1, -1, -1):
        target = rows[s + 1][off]
        prev_at = off - od
        ok = prev_at >= 0
        tot = (rows[s][torch.where(ok, prev_at, P + 1)] + cost[s]).clamp(max=INF)
        hit = ok & (tot == target)
        first = torch.where(hit, bits, max_len + 1).amin(dim=0, keepdim=True)
        found = first <= max_len
        lens[s : s + 1] = torch.where(found, first, max_len)
        off = torch.where(found, off - od[(first - 1).clamp(max=max_len - 1)],
                          off)
    return lens.to(torch.int32)


def decode_meta(lens: torch.Tensor):
    """(meta int32[1, 32], tabp int32[1, 256]): the JAX decode kernel's
    runtime rows, from ``trees.canonical_meta`` — bounds at 0..12, kvals
    at 16..28, the (length, symbol)-ordered symbol table two 16-bit
    entries per int32."""
    bounds, kvals, packed = canonical_meta(lens)
    meta = torch.zeros(32, dtype=torch.int64, device=lens.device)
    meta[: MAXL + 1] = bounds
    meta[16 : 16 + MAXL + 1] = kvals
    tabp = packed[0::2] | (packed[1::2] << 16)
    return (meta.to(torch.int32).reshape(1, 32),
            tabp.to(torch.int32).reshape(1, TAB_PAD // 2))


def encode_adaptive_blocked(data: torch.Tensor, lengths: torch.Tensor,
                            num_chunks: int, lut_matmul: bool | None = None,
                            kernel_assign: bool | None = None):
    """Adaptive-tree, fixed-geometry encode into per-lane windows.

    Builds the length-limited optimal tree of THIS batch on the device,
    then encodes with it through K1.  Returns (win int32[L, wwin],
    chunk_bits int32[B, C], adler int64[B], lens int32[286], tables) where
    ``tables`` (a ``TreeTables``: tokens and decode table) takes the place
    of JAX's (meta, tabp); ``decode_meta(lens)`` gives those.  Lane
    ``b * C + k``'s window holds its payload bits from bit 0 (JAX's
    blocked windows, lane-major).  ``lut_matmul`` and ``kernel_assign``
    pick among the JAX package's XLA and Pallas paths (same windows); the
    port has one, K1, and ignores them.
    """
    del lut_matmul, kernel_assign
    B, N = data.shape
    C = num_chunks
    if N % C or (N // C) % 8:
        raise ValueError("encode_adaptive_blocked needs (N / C) % 8 == 0")
    freqs = symbol_freqs(data, lengths, N // C)
    lens = code_lengths_dp(freqs)
    codes = canonical_codes(lens)[0]
    t = code_tables(codes, lens)    # unframed: no header, no EOF token
    win, chunk_bits = assign_pack(data, lengths, C, t)
    return (win, chunk_bits.reshape(B, C), adler32_batch(data, lengths),
            lens, t)
