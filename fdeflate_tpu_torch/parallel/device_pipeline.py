"""Standard-zlib encode and decode legs, their fused roundtrip, the
blocked-layout roundtrip and the adaptive-tree roundtrip.

JAX counterpart: ``fdeflate_tpu/parallel/device_pipeline.py``
``zlib_encode_step``, ``zlib_decode_step``, ``fused_zlib_roundtrip``,
``fused_ultrafast_roundtrip_v2`` and ``fused_adaptive_roundtrip``, with the
same signatures and returns except
the decoded output: here it is u8[B, N] in standard byte order, where JAX
returns the TPU kernel's step-major ``out_sm i32[LB, T, 8, 128]``.

The decode leg runs K3 (ops/decode2.py) straight from the linear words —
or, for a ``tree=`` profile, K6 (ops/decode_sep.py) with that tree's own
(meta, vals) rows — then checks, as the JAX leg does:
  * ``bpos_ok[b]``: every full lane's exit bit equals its index difference
    ``diff(chunk_starts ++ eof_pos)`` (lanes the stream's length does not
    cover are not checked);
  * ``ck_ok[b]``: the decode-side Adler-32 (ops/adler32.adler_lanes) equals
    the encoder's.

``tree``: an ``ops/septree.TreeProfile`` (or any object with its
``lens``, ``codes``, ``header_bytes`` and ``header_bits``).  The encode
takes any tree of codes up to 12 bits; the decode needs a class-separated one
(``sep_profile()``) and raises ValueError for another at step
construction.  (The JAX decode leg decodes every profile with the
canonical kernel tree's rows; the port decodes with the tree it is given.)

``wwin``, ``U`` and ``R`` size the TPU kernels' windows and grid; the port
reads every lane straight from the words, so it accepts and ignores them.
"""

from __future__ import annotations

import torch

from ..ops.adaptive import encode_adaptive_blocked
from ..ops.adler32 import adler_lanes
from ..ops.decode2 import decode2, decode_blocked
from ..ops.decode_sep import decode_sep
from ..ops.ultrafast import (
    device_of,
    encode_ultrafast_batch,
    encode_ultrafast_blocked,
)
from ..trees import TreeTables, sep_tables, trained_tables


def zlib_encode_step(C: int, tree=None):
    """fn(data u8[B, N], lengths i32[B]) -> (words int32[B, W], total_bits
    int32[B], adler int64[B], chunk_starts int32[B, C], eof_pos int32[B])."""

    def step(data, lengths):
        return encode_ultrafast_batch(data, lengths, C, tree=tree)

    return step


def _checks(out, bp, lane_bits, lengths, adler, C: int):
    """(bpos_ok bool[B], ck_ok bool[B]) of a decode: full lanes' exit bits
    against ``lane_bits`` [B, C], the decode-side Adler-32 against the
    encoder's."""
    B, N = out.shape
    S = N // C
    offs = torch.arange(C, device=out.device) * S
    full = offs[None, :] + S <= lengths.to(torch.int64)[:, None]
    bpos_ok = ((bp == lane_bits) | ~full).all(dim=1)
    return bpos_ok, adler_lanes(out, lengths, C) == adler


def decode_verify(words, chunk_starts, eof_pos, adler, lengths, N: int,
                  C: int, t: TreeTables):
    """The trained-tree decode leg on ``words``' device: K3, then the two
    checks.  Returns (out u8[B, N], bpos_ok bool[B], ck_ok bool[B])."""
    return _decode_verify(words, chunk_starts, eof_pos, adler, lengths, C,
                          lambda w, s: decode2(w, s, t.dtab, N, C))


def _decode_verify(words, chunk_starts, eof_pos, adler, lengths, C: int,
                   decode):
    """A decode leg with its lane decoder given: ``decode(words,
    chunk_starts) -> (out, bpos)``, a kernel wrapper or, to time it on the
    card, its plain version."""
    out, bp = decode(words, chunk_starts)
    ends = torch.cat([chunk_starts[:, 1:], eof_pos[:, None]], dim=1)
    return (out, *_checks(out, bp, ends - chunk_starts, lengths, adler, C))


def zlib_decode_step(C: int, N: int, wwin: int | None = None, U: int = 32,
                     R: int | None = None, tree=None):
    """fn(words, chunk_starts, eof_pos, adler, lengths) ->
    (out u8[B, N], bpos_ok bool[B], ck_ok bool[B])."""
    if N % C:
        raise ValueError("N must divide into C chunks")
    sep = None if tree is None else sep_tables(tree.lens)

    def step(words, chunk_starts, eof_pos, adler, lengths):
        if sep is None:
            return decode_verify(words, chunk_starts, eof_pos, adler,
                                 lengths, N, C,
                                 trained_tables(str(words.device)))
        meta, vals = (x.to(words.device) for x in sep)
        return _decode_verify(
            words, chunk_starts, eof_pos, adler, lengths, C,
            lambda w, s: decode_sep(w, s, meta, vals, N, C))

    return step


def fused_zlib_roundtrip(C: int, N: int, wwin: int | None = None, U: int = 32,
                         R: int | None = None, tree=None, *, device="cuda"):
    """Encode -> decode -> verify on ``device``, through a standard zlib
    artifact.  fn(data u8[B, N], lengths i32[B]) -> (out, bpos_ok, ck_ok);
    numpy or tensor inputs are moved to ``device``."""
    dev = device_of(device)
    enc = zlib_encode_step(C, tree=tree)
    dec = zlib_decode_step(C, N, wwin, U=U, R=R, tree=tree)

    def step(data, lengths):
        data = torch.as_tensor(data).to(dev)
        lengths = torch.as_tensor(lengths).to(dev, torch.int32)
        words, _total_bits, adler, starts, eof = enc(data, lengths)
        return dec(words, starts, eof, adler, lengths)

    return step


def _blocked_roundtrip(C: int, N: int, encode, device, name: str):
    """The blocked-layout roundtrip step on ``device``: ``encode(data,
    lengths) -> (win, chunk_bits, adler, tables)`` into lane windows,
    ``decode_blocked`` (K3 on each window from bit 0, with ``tables``, or
    the trained tree's when None), then both checks, exit bits against
    ``chunk_bits``.  fn(data, lengths) -> (out u8[B, N], bpos_ok bool[B],
    ck_ok bool[B], chunk_bits int32[B, C])."""
    dev = device_of(device)
    if N % C or (N // C) % 8:
        raise ValueError(f"{name} needs (N / C) % 8 == 0")
    S = N // C

    def step(data, lengths):
        data = torch.as_tensor(data).to(dev)
        lengths = torch.as_tensor(lengths).to(dev, torch.int32)
        B = data.shape[0]
        win, chunk_bits, adler, tables = encode(data, lengths)
        out, bp = decode_blocked(win, S // 4, tables=tables)
        out = out.reshape(B, N)
        bpos_ok, ck_ok = _checks(out, bp.reshape(B, C), chunk_bits, lengths,
                                 adler, C)
        return out, bpos_ok, ck_ok, chunk_bits

    return step


def fused_ultrafast_roundtrip_v2(C: int, N: int, U: int = 32,
                                 R: int | None = None, *, device="cuda"):
    """Blocked-layout roundtrip on ``device``: ``encode_ultrafast_blocked``
    (K1 into lane windows), ``decode_blocked`` (K3 on each window from bit
    0), then both checks, exit bits against ``chunk_bits``.

    fn(data u8[B, N], lengths i32[B]) -> (out u8[B, N], bpos_ok bool[B],
    ck_ok bool[B]); JAX returns the kernel's step-major ``out_sm`` where
    ``out`` is in standard byte order.  A ragged stream's last lane decodes
    its zero-padded window to zero bytes (the trained tree's zero literal
    is the all-zero 2-bit code), so the checksum covers it exactly.
    """
    step = _blocked_roundtrip(
        C, N, lambda d, ln: (*encode_ultrafast_blocked(d, ln, C), None),
        device, "fused_ultrafast_roundtrip_v2")
    return lambda data, lengths: step(data, lengths)[:3]


def fused_adaptive_roundtrip(C: int, N: int, U: int = 8, *, device="cuda"):
    """Adaptive-tree roundtrip on ``device``: the batch's own tree built on
    the device, K1 into lane windows with its tokens, K3 on each window
    with its decode table, both checks.

    fn(data u8[B, N], lengths i32[B]) -> (out u8[B, N], bpos_ok bool[B],
    ck_ok bool[B], total_bits: the 0-d sum of the lanes' payload bits).
    Exit bits are held to ``chunk_bits``.  Bytes past a stream's length
    decode from zero bits, whose symbol in this tree need not be a zero
    byte, so ``ck_ok`` (unmasked, as in JAX) may fail for ragged streams.
    """

    def encode(data, lengths):
        win, chunk_bits, adler, _lens, t = encode_adaptive_blocked(
            data, lengths, C)
        return win, chunk_bits, adler, t

    step = _blocked_roundtrip(C, N, encode, device, "fused_adaptive_roundtrip")

    def roundtrip(data, lengths):
        out, bpos_ok, ck_ok, chunk_bits = step(data, lengths)
        return out, bpos_ok, ck_ok, chunk_bits.sum()

    return roundtrip
