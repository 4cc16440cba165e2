"""K7 adler32_tiles: Adler-32 of byte rows, tile sums and fold in one kernel.

JAX counterpart: ``fdeflate_tpu/ops/adler32_pallas.py`` ``adler32_pallas``,
whose TPU kernel ``_tile_kernel`` takes per-1024-byte-tile plain and
position-weighted sums (weight ``1024 - pos``; both fit int32) and whose
XLA glue folds them into the checksum: tile t at offset ``o_t``
contributes ``(length - o_t - 1024) * S_t + W_t`` (mod 65521) to B, and
``S_t`` to A.  The JAX fold keeps int32 sums, which is why it splits
inputs above ``CHUNK_BYTES`` (32 MiB) into pieces joined by the
associative combine; the port folds in 64 bits and needs no split.

The CUDA kernel ``csrc/adler32_tiles.cu`` takes a batch of rows with their
lengths and computes the tile sums and the fold in the same launch, so one
launch is ``adler32_pallas`` (one row) or ``ops/adler32.adler32_batch``
(one checksum per stream, the encode's).  Its plain version is
``adler32_tiles_plain`` then ``fold_tiles``.
"""

from __future__ import annotations

import torch

from .. import _build

MOD = 65521
TILE = 1024


def adler32_tiles_plain(data: torch.Tensor, length: torch.Tensor):
    """Plain PyTorch K7's tile sums: (sums, wsums) int32[tiles] of ``data``
    u8[n] with ``length`` [1], or int32[B, tiles] of u8[B, n] rows with
    ``length`` [B]; bytes at or past a row's length count as zero."""
    rows = data.reshape(1, -1) if data.dim() == 1 else data
    B, n = rows.shape
    tiles = -(-n // TILE)
    dev = data.device
    d = torch.zeros(B, tiles * TILE, dtype=torch.int64, device=dev)
    d[:, :n] = rows.to(torch.int64)
    pos = torch.arange(tiles * TILE, device=dev)
    ln = length.to(device=dev, dtype=torch.int64).reshape(B, 1)
    d = torch.where(pos < ln, d, 0).reshape(B, tiles, TILE)
    wt = TILE - torch.arange(TILE, device=dev)
    sums = d.sum(dim=2).to(torch.int32)
    wsums = (d * wt).sum(dim=2).to(torch.int32)
    if data.dim() == 1:
        return sums[0], wsums[0]
    return sums, wsums


def fold_tiles(sums: torch.Tensor, wsums: torch.Tensor,
               length: torch.Tensor) -> torch.Tensor:
    """The checksums from the tile sums, in int64: a 0-d tensor from
    [tiles] sums and ``length`` [1], int64[B] from [B, tiles] and [B]."""
    s = sums.to(torch.int64) % MOD
    w = wsums.to(torch.int64) % MOD
    offs = torch.arange(s.shape[-1], device=s.device) * TILE
    ln = length.to(device=s.device, dtype=torch.int64).reshape(
        *s.shape[:-1], 1)
    coeff = (ln - offs - TILE) % MOD
    total_w = (((coeff * s) % MOD).sum(dim=-1) + w.sum(dim=-1)) % MOD
    a = (1 + s.sum(dim=-1)) % MOD
    b = (ln[..., 0] % MOD + total_w) % MOD
    return (b << 16) | a


_WORKSPACE: dict = {}


def _workspace(device: torch.device, B: int) -> torch.Tensor:
    """K7's zeroed sums and finish counter on ``device``'s current stream
    (int64[>= 2 B + 1]); each launch leaves them zero, so one buffer
    serves every launch queued on that stream."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < 2 * B + 1:
        ws = torch.zeros(max(2 * B + 1, 65), dtype=torch.int64, device=device)
        _WORKSPACE[key] = ws
    return ws


def _launch(data, B: int, n: int, lengths, length: int, sums, wsums):
    """One K7 launch over the rows of ``data`` (row stride in
    ``data.stride(0)``, bytes contiguous): int64[B] checksums."""
    dev = data.device
    out = torch.empty(B, dtype=torch.int64, device=dev)
    _build.launch(
        "adler32_tiles", dev, data.data_ptr(), data.stride(0), B, n,
        None if lengths is None else lengths.data_ptr(),
        int(lengths is not None and lengths.dtype == torch.int64), length,
        _workspace(dev, B).data_ptr(), out.data_ptr(),
        None if sums is None else sums.data_ptr(),
        None if wsums is None else wsums.data_ptr(), dev.index)
    return out


def adler32_checksums(data: torch.Tensor, lengths: torch.Tensor, sums=None,
                      wsums=None) -> torch.Tensor:
    """K7 on ``data``'s device: int64[B] Adler-32 of each row of ``data``
    u8[B, n] (any row stride) up to ``lengths[b]`` (int32 or int64[B], in
    [0, n], on the same device).  ``sums``/``wsums``, int32[B, ceil(n /
    1024)] given together, receive the tile sums.  CPU tensors take
    ``adler32_tiles_plain`` and ``fold_tiles``; CUDA tensors launch
    ``csrc/adler32_tiles.cu`` once, which folds the tiles itself."""
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError("adler32_checksums needs data u8[B, n]")
    B, n = data.shape
    tiles = (B, -(-n // TILE))
    if lengths.shape != (B,) or (sums is None) != (wsums is None) or (
            sums is not None and not all(
                x.shape == tiles and x.dtype == torch.int32
                and x.is_contiguous() for x in (sums, wsums))):
        raise ValueError("adler32_checksums needs lengths [B] and both or "
                         "neither of sums/wsums int32[B, ceil(n / 1024)]")
    if data.device.type == "cpu":
        s, w = adler32_tiles_plain(data, lengths)
        if sums is not None:
            sums.copy_(s)
            wsums.copy_(w)
        return fold_tiles(s, w, lengths)
    _build.require_cuda(data, lengths,
                        *(x for x in (sums, wsums) if x is not None))
    if n > 1 and data.stride(1) != 1:
        data = data.contiguous()
    if lengths.dtype not in (torch.int32, torch.int64) or not (
            lengths.is_contiguous()):
        lengths = lengths.to(torch.int64).contiguous()
    return _launch(data, B, n, lengths, 0, sums, wsums)


def adler32_tiles(data: torch.Tensor, length: torch.Tensor):
    """K7 with the TPU kernel's outputs: (sums int32[tiles], wsums
    int32[tiles]) of ``data`` u8[n], bytes at or past ``length`` (int64[1]
    on the same device) counted as zero.  CPU tensors take
    ``adler32_tiles_plain``; CUDA tensors launch ``csrc/adler32_tiles.cu``
    (which folds the checksum too; it is dropped here)."""
    if data.dim() != 1 or data.dtype != torch.uint8 or length.shape != (1,):
        raise ValueError("adler32_tiles needs data u8[n] and length [1]")
    if data.device.type == "cpu":
        return adler32_tiles_plain(data, length)
    _build.require_cuda(data, length)
    tiles = -(-data.shape[0] // TILE)
    sums = torch.empty(1, tiles, dtype=torch.int32, device=data.device)
    wsums = torch.empty(1, tiles, dtype=torch.int32, device=data.device)
    adler32_checksums(data[None], length, sums, wsums)
    return sums[0], wsums[0]


def adler32_pallas(data: torch.Tensor, length=None,
                   interpret: bool | None = None) -> torch.Tensor:
    """Adler-32 of a 1-D uint8 tensor, on its device: one K7 launch.

    ``length`` (an int, or a tensor on ``data``'s device, in [0, n]) masks a
    zero-padded buffer; None checksums all n bytes.  Returns the int64
    0-d tensor holding the u32 checksum.  ``interpret`` runs the JAX
    package's Pallas kernel in its interpreter; the port ignores it (CPU
    tensors take the plain version).
    """
    del interpret
    n = data.shape[0]
    if length is None:
        length = n
    if data.device.type == "cpu" or torch.is_tensor(length):
        ln = torch.as_tensor(length, device=data.device).reshape(1)
        return adler32_checksums(data[None], ln)[0]
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError("adler32_pallas needs data u8[n]")
    _build.require_cuda(data)
    if n > 1 and data.stride(0) != 1:
        data = data.contiguous()
    return _launch(data[None], 1, n, None, int(length), None, None)[0]
