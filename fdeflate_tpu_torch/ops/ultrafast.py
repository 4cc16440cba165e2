"""Ultra-fast encoder: bytes -> standard zlib words + index.

JAX counterpart: ``fdeflate_tpu/ops/ultrafast_kernel.py``
``encode_ultrafast_batch`` (same signature and modes), ``_frame_words``,
``finalize_streams`` and ``compress_batch_ultra_fast``.  Its fixed-geometry
mode is ``encode_fixed``; the chain is

    K1 assign_pack  (ops/assign_pack.py)  bytes -> lane windows, chunk bits
    pos0 = header bits + exclusive cumsum of chunk bits         (torch)
    K2 combine      (ops/repack.py)       windows -> linear words
    framing: the tree's header words and EOF token              (torch)
    K7 Adler-32     (ops/adler32.py)      per-stream checksums

Every stream is cut into C lanes of S = N / C bytes and zero runs are cut
at every lane boundary, so lane k decodes exactly S bytes from bit
``chunk_starts[b, k]``.  The output words equal the JAX encoder's up to
``ceil(total_bits / 32)`` and are zero past it; W is the JAX XLA path's.
Without fixed geometry each stream is encoded in one lane (C = 1), as
JAX does, and its index is the JAX symbol-boundary index
(``symbol_index``).  ``encode_ultrafast_blocked`` (JAX
``encode_ultrafast_blocked`` :578) stops after K1: lane windows, chunk bits
and Adler-32, no linear words.
"""

from __future__ import annotations

import numpy as np
import torch

from ..trees import TreeTables, profile_tables, trained_tables
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


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the rows of int64 [B, n], as one flat scan
    less each row's start (on the card PyTorch's row scan of a few long
    rows runs ~15x slower than its flat scan)."""
    B, n = x.shape
    flat = x.reshape(-1).cumsum(0).reshape(B, n)
    base = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    return flat - base[:, None]


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


def encode_fixed(data: torch.Tensor, lengths: torch.Tensor, num_chunks: int,
                 tree=None):
    """Encode B streams of padded length N in fixed geometry (JAX
    ``encode_ultrafast_batch(num_chunks=C, fixed_geometry=True,
    return_eof=True, tree=)``).

    Args:
      data: u8[B, N], zero past ``lengths``; N % num_chunks == 0 and
        S = N / num_chunks a multiple of 8.
      lengths: i32[B] logical lengths.
      tree: an ``ops/septree.TreeProfile`` (codes of at most 12
        bits, its own canned header), as the JAX ``tree=``; None keeps the
        trained tree.

    Returns (words int32[B, W], total_bits int32[B], adler int64[B],
    chunk_starts int32[B, C], eof_pos int32[B]); words hold u32 bit
    patterns and, with total_bits and adler, assemble into zlib streams
    (``finalize_streams``).
    """
    return _encode(data, lengths, num_chunks, _tree_tables(data, tree),
                   assign_pack, combine)


def _tree_tables(data: torch.Tensor, tree) -> TreeTables:
    """The trained tree's tables, or ``tree``'s, on ``data``'s device."""
    dev = str(data.device)
    return trained_tables(dev) if tree is None else profile_tables(tree, dev)


def encode_ultrafast_batch(data: torch.Tensor, lengths: torch.Tensor,
                           lut_matmul=None, num_chunks: int = 0,
                           fixed_geometry: bool = False,
                           return_eof: bool = False, kernel_pack=None,
                           kernel_assign=None, tree=None):
    """JAX ``encode_ultrafast_batch``, its signature and returns.

    ``data`` u8[B, N] (N % 8 == 0), zero past ``lengths`` i32[B].  Returns
    (words int32[B, W], total_bits int32[B], adler int64[B]) and, when
    ``num_chunks`` C > 0, chunk_starts int32[B, C], then, with
    ``return_eof``, eof_pos int32[B]:
      * ``num_chunks=0``: each stream encoded in one lane (runs not cut);
      * ``num_chunks=C``: the same one-lane streams and their exact
        symbol-boundary index at N // C byte spacing (``symbol_index``);
      * ``num_chunks=C, fixed_geometry=True``: runs cut at every N / C
        byte boundary, lane k starting at chunk_starts[:, k]
        (``encode_fixed``).
    Words are the u32 patterns as int32 and adler the u32 checksum in
    int64 (JAX: uint32).  ``lut_matmul``, ``kernel_pack`` and
    ``kernel_assign`` pick among the JAX package's XLA and Pallas paths,
    which give the same words; the port has one path and ignores them.
    """
    del lut_matmul, kernel_pack, kernel_assign
    t = _tree_tables(data, tree)
    fixed = bool(num_chunks and fixed_geometry)
    words, total_bits, adler, starts, eof_pos = _encode(
        data, lengths, num_chunks if fixed else 1, t, assign_pack, combine)
    if not num_chunks:
        return words, total_bits, adler
    if not fixed:
        starts = symbol_index(data, lengths, num_chunks, eof_pos, t)
    out = (words, total_bits, adler, starts, eof_pos)
    return out if return_eof else out[:4]


def _encode(data, lengths, C: int, t: TreeTables, k1, k2):
    """``encode_fixed`` with K1 and K2 given: the kernel wrappers,
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


def encode_ultrafast_blocked(data: torch.Tensor, lengths: torch.Tensor,
                             num_chunks: int, lut_matmul=None,
                             kernel_pack=None, kernel_assign=None):
    """Fixed-geometry, lane-blocked encode with the trained tree: K1 only.

    Returns (win int32[B * C, wwin(S)], chunk_bits int32[B, C], adler
    int64[B]).  Lane ``b * C + k``'s window holds its payload bits from
    bit 0 and zeros past them: no zlib header, no EOF.  JAX returns
    ``[LB, blocked_wpad(S), 8, 128]`` windows; their extra words are zero.

    ``lut_matmul``, ``kernel_pack`` and ``kernel_assign`` pick among the
    JAX package's XLA and Pallas paths, which give the same windows; the
    port has one path (K1 on CUDA tensors, its plain version on CPU
    tensors) and accepts and ignores them.  None of them selects K9: JAX's
    ``kernel_pack=True`` is the linear pack ``pack_blocked_pallas_v2``,
    which K1 holds; the v1 pack (K9) is ``ops/pack.py``'s alone.
    """
    B, N = data.shape
    C = num_chunks
    if N % C or (N // C) % 8:
        raise ValueError("encode_ultrafast_blocked needs (N / C) % 8 == 0")
    win, chunk_bits = assign_pack(data, lengths, C,
                                  trained_tables(str(data.device)))
    return win, chunk_bits.reshape(B, C), adler32_batch(data, lengths)


def symbol_index(data: torch.Tensor, lengths: torch.Tensor, num_chunks: int,
                 eof_pos: torch.Tensor, t: TreeTables) -> torch.Tensor:
    """Chunk index int32[B, C] of a stream encoded in one lane (C = 1).

    Twin of the ``num_chunks`` index of ``encode_ultrafast_batch`` without
    fixed geometry: entry k is the bit of the first symbol that starts at or
    after byte k * (N // C), ``eof_pos`` past the last symbol; entry 0 is
    the header's end, where byte 0's symbol or the EOF token starts.  Plain
    torch, as the XLA computation it mirrors (a suffix minimum there: token
    positions rise along a stream, so here a binary search of the symbol
    starts finds the first at or after each sampled byte).
    """
    B, N = data.shape
    dev = data.device
    _v, nb, at_extra = assign_tokens(data, lengths, N, t)
    nb = nb.to(torch.int64)
    tok_pos = (t.header_bits + row_cumsum(nb) - nb).reshape(-1)
    starts = ((nb > 0) & ~at_extra).reshape(-1).nonzero().squeeze(1)
    rows = torch.arange(B, device=dev)[:, None]
    q = (rows * N + torch.arange(num_chunks, device=dev) * (N // num_chunks))
    k = torch.searchsorted(starts, q.reshape(-1)).reshape(B, num_chunks)
    eof = eof_pos.to(torch.int64)[:, None].expand(B, num_chunks)
    if starts.numel() == 0:
        return eof.to(torch.int32)
    at = starts[k.clamp(max=starts.numel() - 1)]
    hit = (k < starts.numel()) & (at // N == rows)
    return torch.where(hit, tok_pos[at], eof).to(torch.int32)


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
                              device="cuda"):
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
    enc = encode_ultrafast_batch(data, lens, num_chunks=int(with_index))
    out = finalize_streams(*enc[:3])
    if with_index:
        return out, enc[3].cpu().numpy()
    return out
