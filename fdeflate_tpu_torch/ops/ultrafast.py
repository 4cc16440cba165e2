"""Fixed-geometry ultra-fast encoder: bytes -> standard zlib words + index.

JAX counterpart: ``fdeflate_tpu/ops/ultrafast_kernel.py``
``encode_ultrafast_batch(num_chunks=C, fixed_geometry=True,
return_eof=True)`` with ``_frame_words``, ``finalize_streams`` and
``compress_batch_ultra_fast``.  The chain is

    K1 assign_pack  (ops/assign_pack.py)  bytes -> lane windows, chunk bits
    pos0 = header bits + exclusive cumsum of chunk bits         (torch)
    K2 combine      (ops/repack.py)       windows -> linear words
    framing: header words and the EOF token                     (torch)
    Adler-32                              (ops/adler32.py)

Every stream is cut into C lanes of S = N / C bytes and zero runs are cut
at every lane boundary, so lane k decodes exactly S bytes from bit
``chunk_starts[b, k]``.  The output words equal the JAX encoder's up to
``ceil(total_bits / 32)`` and are zero past it; W is the JAX XLA path's.
``compress_batch_ultra_fast`` encodes each stream in one lane (C = 1), as
the JAX one does, and its index is the JAX symbol-boundary index
(``symbol_index``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..trees import TreeTables, trained_tables
from .adler32 import adler32_batch
from .assign_pack import assign_pack, assign_tokens
from .repack import combine


def device_of(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA on a machine without it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def stream_words(N: int, t: TreeTables) -> int:
    """Words per stream: 13 bits per byte at most, header, EOF, slack."""
    return (13 * N + t.header_bits + t.eof_bits + 31) // 32 + 2


def lane_starts(chunk_bits: torch.Tensor, B: int, C: int, header_bits: int):
    """(pos0 int64[B, C], eof_pos int64[B]): each lane's absolute start bit,
    the header bits plus the exclusive prefix sum of the stream's
    ``chunk_bits``, and the bit where the EOF token goes."""
    cb = chunk_bits.to(torch.int64).reshape(B, C)
    csum = cb.cumsum(dim=1)
    return header_bits + csum - cb, header_bits + csum[:, -1]


def frame_words(words: torch.Tensor, eof_pos: torch.Tensor,
                t: TreeTables) -> torch.Tensor:
    """OR the canned header and the EOF token into ``words`` (in place)."""
    nh = t.header.shape[0]
    words[:, :nh] |= t.header
    pos = eof_pos.to(torch.int64)
    x = t.eof_code << (pos & 31)                 # <= 12 + 31 bits
    rows = torch.arange(words.shape[0], device=words.device)
    wi = pos >> 5
    # int64 -> int32 keeps the low 32 bits: the u32 word's bit pattern.
    words[rows, wi] |= (x & 0xFFFFFFFF).to(torch.int32)
    words[rows, wi + 1] |= (x >> 32).to(torch.int32)
    return words


def encode_ultrafast_batch(data: torch.Tensor, lengths: torch.Tensor,
                           num_chunks: int, tables: TreeTables | None = None):
    """Encode B streams of padded length N in fixed geometry.

    Args:
      data: u8[B, N], zero past ``lengths``; N % num_chunks == 0 and
        S = N / num_chunks a multiple of 8.
      lengths: i32[B] logical lengths.
      tables: the tree's tables on ``data``'s device (default: trained).

    Returns (words int32[B, W], total_bits int32[B], adler int64[B],
    chunk_starts int32[B, C], eof_pos int32[B]); words hold u32 bit
    patterns and, with total_bits and adler, assemble into zlib streams
    (``finalize_streams``).
    """
    t = tables if tables is not None else trained_tables(str(data.device))
    return _encode(data, lengths, num_chunks, t, assign_pack, combine)


def _encode(data, lengths, C: int, t: TreeTables, k1, k2):
    """``encode_ultrafast_batch`` with K1 and K2 given: the kernel wrappers,
    or their plain versions to time them on the card."""
    B, N = data.shape
    win, chunk_bits = k1(data, lengths, C, t)
    pos0, eof_pos = lane_starts(chunk_bits, B, C, t.header_bits)
    total_bits = (eof_pos + t.eof_bits + 7) // 8 * 8
    words = k2(win, chunk_bits, pos0.reshape(-1).to(torch.int32), B,
               stream_words(N, t))
    words = frame_words(words, eof_pos, t)
    adler = adler32_batch(data, lengths)
    return (words, total_bits.to(torch.int32), adler,
            pos0.to(torch.int32), eof_pos.to(torch.int32))


def symbol_index(data: torch.Tensor, lengths: torch.Tensor, num_chunks: int,
                 eof_pos: torch.Tensor, t: TreeTables) -> torch.Tensor:
    """Chunk index int32[B, C] of a stream encoded in one lane (C = 1).

    Twin of the ``num_chunks`` index of ``encode_ultrafast_batch`` without
    fixed geometry: entry k is the bit of the first symbol that starts at or
    after byte k * (N // C), ``eof_pos`` past the last symbol; entry 0 is
    the header's end, where byte 0's symbol or the EOF token starts.  Plain
    torch, as the XLA computation it mirrors.
    """
    B, N = data.shape
    _v, nb, at_extra = assign_tokens(data, lengths, N, t)
    tok_pos = t.header_bits + nb.cumsum(dim=1) - nb
    sym_start = (nb > 0) & ~at_extra
    masked = torch.where(sym_start, tok_pos, eof_pos.to(torch.int64)[:, None])
    suffix_min = masked.flip(1).cummin(dim=1).values.flip(1)
    sample = torch.arange(num_chunks, device=data.device) * (N // num_chunks)
    return suffix_min[:, sample].to(torch.int32)


def finalize_streams(words, total_bits, adler) -> list[bytes]:
    """Assemble the zlib byte strings on the host (appends the checksums)."""
    words = torch.as_tensor(words).cpu().numpy().astype(np.uint32)
    total_bits = torch.as_tensor(total_bits).cpu().numpy()
    adler = torch.as_tensor(adler).cpu().numpy()
    out = []
    for b in range(words.shape[0]):
        raw = words[b].astype("<u4").tobytes()[: int(total_bits[b]) // 8]
        out.append(raw + int(adler[b]).to_bytes(4, "big"))
    return out


def compress_batch_ultra_fast(streams: list[bytes], with_index: int = 0, *,
                              device):
    """Host-facing batch API: ultra-fast-compress many streams on ``device``.

    The streams equal the JAX package's byte for byte: each is encoded in
    one lane (runs are not cut), padded to N, a multiple of 8.  With
    ``with_index=C`` the int32[B, C] index of exact symbol-boundary bits at
    N // C byte spacing (``symbol_index``) is returned too.  The
    fixed-geometry streams and index of the chunk-parallel decode come from
    ``zlib_encode_step``.
    """
    dev = device_of(device)
    lengths = np.array([len(s) for s in streams], dtype=np.int32)
    N = max(8, -(-int(lengths.max(initial=1)) // 8) * 8)
    buf = np.zeros((len(streams), N), dtype=np.uint8)
    for i, s in enumerate(streams):
        buf[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    data = torch.from_numpy(buf).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    t = trained_tables(str(dev))
    words, total_bits, adler, _starts, eof_pos = encode_ultrafast_batch(
        data, lens, 1, t)
    out = finalize_streams(words, total_bits, adler)
    if with_index:
        index = symbol_index(data, lens, int(with_index), eof_pos, t)
        return out, index.cpu().numpy()
    return out
