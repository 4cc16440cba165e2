"""K7 adler32_tiles: Adler-32 of one byte buffer by a tile-sum kernel.

JAX counterpart: ``fdeflate_tpu/ops/adler32_pallas.py`` ``adler32_pallas``,
whose TPU kernel ``_tile_kernel`` takes per-1024-byte-tile plain and
position-weighted sums (weight ``1024 - pos``; both fit int32).  The CUDA
kernel is ``csrc/adler32_tiles.cu``; ``adler32_tiles_plain`` is its plain
version.  The tiles fold into the checksum in int64 torch: tile t at
offset ``o_t`` contributes ``(length - o_t - 1024) * S_t + W_t`` (mod 65521)
to B, and ``S_t`` to A.  The JAX fold keeps int32 sums, which is why it
splits inputs above ``CHUNK_BYTES`` (32 MiB) into pieces joined by the
associative combine; in int64 one fold covers any size, so the port has no
such split and gives the same checksum.
"""

from __future__ import annotations

import torch

from .. import _build
from .adler32 import MOD

TILE = 1024


def adler32_tiles_plain(data: torch.Tensor, length: torch.Tensor):
    """Plain PyTorch K7: (sums int32[tiles], wsums int32[tiles]) of
    ``data`` u8[n] with bytes at or past ``length`` counted as zero."""
    n = data.shape[0]
    tiles = -(-n // TILE)
    pos = torch.arange(tiles * TILE, device=data.device)
    d = torch.zeros(tiles * TILE, dtype=torch.int64, device=data.device)
    d[:n] = data.to(torch.int64)
    d = torch.where(pos < length, d, 0).reshape(tiles, TILE)
    wt = TILE - torch.arange(TILE, device=data.device)
    return d.sum(dim=1).to(torch.int32), (d * wt).sum(dim=1).to(torch.int32)


def adler32_tiles(data: torch.Tensor, length: torch.Tensor):
    """K7 on ``data``'s device: (sums int32[tiles], wsums int32[tiles]).

    ``data`` u8[n], ``length`` int64[1] on the same device.  CPU tensors
    take ``adler32_tiles_plain``; CUDA tensors launch
    ``csrc/adler32_tiles.cu``.
    """
    if data.dim() != 1 or data.dtype != torch.uint8 or length.shape != (1,):
        raise ValueError("adler32_tiles needs data u8[n] and length [1]")
    if data.device.type == "cpu":
        return adler32_tiles_plain(data, length)
    _build.require_cuda(data, length)
    n = data.shape[0]
    tiles = -(-n // TILE)
    data = data.contiguous()
    if data.data_ptr() % 4:  # the kernel loads 4 bytes at a time
        data = data.clone()
    length = length.to(torch.int64).contiguous()
    sums = torch.empty(tiles, dtype=torch.int32, device=data.device)
    wsums = torch.empty(tiles, dtype=torch.int32, device=data.device)
    if tiles == 0:
        return sums, wsums
    _build.launch("adler32_tiles", data.device, data.data_ptr(), n,
                  length.data_ptr(), sums.data_ptr(), wsums.data_ptr(), tiles)
    adler32_tiles.launches += 1
    return sums, wsums


adler32_tiles.launches = 0


def fold_tiles(sums: torch.Tensor, wsums: torch.Tensor,
               length: torch.Tensor) -> torch.Tensor:
    """The checksum (int64 0-d tensor) from the tile sums, in int64."""
    s = sums.to(torch.int64) % MOD
    w = wsums.to(torch.int64) % MOD
    offs = torch.arange(s.shape[0], device=s.device) * TILE
    coeff = (length - offs - TILE) % MOD
    total_w = (((coeff * s) % MOD).sum() + w.sum()) % MOD
    a = (1 + s.sum()) % MOD
    b = (length[0] % MOD + total_w) % MOD
    return (b << 16) | a


def adler32_pallas(data: torch.Tensor, length=None) -> torch.Tensor:
    """Adler-32 of a 1-D uint8 tensor, on its device: K7, then the fold.

    ``length`` (an int or a tensor on ``data``'s device, in [0, n]) masks a
    zero-padded buffer; None checksums all n bytes.  Returns the int64
    0-d tensor holding the u32 checksum.
    """
    n = data.shape[0]
    if length is None:
        length = n
    length = torch.as_tensor(length, device=data.device).to(
        torch.int64).reshape(1)
    sums, wsums = adler32_tiles(data, length)
    return fold_tiles(sums, wsums, length)
