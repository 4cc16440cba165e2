"""Standard-zlib encode and decode legs and their fused roundtrip.

JAX counterpart: ``fdeflate_tpu/parallel/device_pipeline.py``
``zlib_encode_step``, ``zlib_decode_step`` and ``fused_zlib_roundtrip``,
with the same signatures and returns except the decoded output: here it is
u8[B, N] in standard byte order, where JAX returns the TPU kernel's
step-major ``out_sm i32[LB, T, 8, 128]``.

The decode leg runs K3 (ops/decode2.py) straight from the linear words,
then checks, as the JAX leg does:
  * ``bpos_ok[b]``: every full lane's exit bit equals its index difference
    ``diff(chunk_starts ++ eof_pos)`` (lanes the stream's length does not
    cover are not checked);
  * ``ck_ok[b]``: the decode-side Adler-32 (ops/adler32.adler_lanes) equals
    the encoder's.

``wwin``, ``U`` and ``R`` size the TPU kernel's windows and grid; the port
reads every lane straight from the words, so it accepts and ignores them.
``tree`` (the septree profile) is not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.adler32 import adler_lanes
from ..ops.decode2 import decode2
from ..ops.ultrafast import device_of, encode_ultrafast_batch
from ..trees import TreeTables, trained_tables


def _no_tree(tree) -> None:
    if tree is not None:
        raise NotImplementedError("the septree profile is not ported yet")


def zlib_encode_step(C: int, tree=None):
    """fn(data u8[B, N], lengths i32[B]) -> (words int32[B, W], total_bits
    int32[B], adler int64[B], chunk_starts int32[B, C], eof_pos int32[B])."""
    _no_tree(tree)

    def step(data, lengths):
        return encode_ultrafast_batch(data, lengths, C)

    return step


def decode_verify(words, chunk_starts, eof_pos, adler, lengths, N: int,
                  C: int, t: TreeTables):
    """The decode leg on ``words``' device: K3, then the two checks.

    Returns (out u8[B, N], bpos_ok bool[B], ck_ok bool[B])."""
    return _decode_verify(words, chunk_starts, eof_pos, adler, lengths, N, C,
                          t, decode2)


def _decode_verify(words, chunk_starts, eof_pos, adler, lengths, N: int,
                   C: int, t: TreeTables, k3):
    """``decode_verify`` with K3 given: the kernel wrapper, or its plain
    version to time it on the card."""
    out, bp = k3(words, chunk_starts, t.dtab, N, C)
    S = N // C
    ends = torch.cat([chunk_starts[:, 1:], eof_pos[:, None]], dim=1)
    offs = torch.arange(C, device=words.device) * S
    full = offs[None, :] + S <= lengths.to(torch.int64)[:, None]
    bpos_ok = ((bp == ends - chunk_starts) | ~full).all(dim=1)
    ck_ok = adler_lanes(out, lengths, C) == adler
    return out, bpos_ok, ck_ok


def zlib_decode_step(C: int, N: int, wwin: int | None = None, U: int = 32,
                     R: int | None = None, tree=None):
    """fn(words, chunk_starts, eof_pos, adler, lengths) ->
    (out u8[B, N], bpos_ok bool[B], ck_ok bool[B])."""
    _no_tree(tree)
    if N % C:
        raise ValueError("N must divide into C chunks")

    def step(words, chunk_starts, eof_pos, adler, lengths):
        t = trained_tables(str(words.device))
        return decode_verify(words, chunk_starts, eof_pos, adler, lengths,
                             N, C, t)

    return step


def fused_zlib_roundtrip(C: int, N: int, wwin: int | None = None, U: int = 32,
                         R: int | None = None, tree=None, *, device):
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
