"""K13 materialize_records: a sequential round's K4 records -> bytes.

JAX counterpart: none on the device.  JAX's ``materialize``
(``fdeflate_tpu/ops/inflate.py``) is an XLA routine; the port's copy,
``ops/inflate.materialize``, expands any records by pointer doubling in ~60
torch ops.  The sequential path (``ops/inflate.decompress_sequential``)
hands it one lane a stream whose records follow the lane's 32 KiB window,
so every match copies bytes already final; the CUDA kernel
``csrc/materialize_records.cu`` walks them so, one launch a round.
``materialize_records_plain`` is its plain version: ``materialize`` over
``recs_to_records``.
"""

from __future__ import annotations

import torch

from .. import _build
from .inflate_host import WINDOW
from .inflate_records import recs_to_records

SMEM_BYTES = 232448   # a block's shared memory on sm_90 (227 KB)
_SCAN_BYTES = 128     # the kernel's scan scratch, before its working bytes


def materialize_records_plain(recs, window, produced, cap: int):
    """Plain K13: ``materialize(recs_to_records(recs), ...)`` on the
    tensors' device."""
    from .inflate import materialize

    return materialize(recs_to_records(recs), window, produced, cap)


def materialize_records(recs, window, produced, cap: int):
    """Expand K4's records into bytes: (out u8[L, cap], new window
    u8[L, 32768]).

    ``recs`` int32[K, L], step-major, as K4 writes them (records of at most
    two literals, a one-literal record's second byte zero); ``window``
    u8[L, 32768], each lane's prior output right-aligned (zero-filled on
    the left for a stream shorter than the window); ``produced`` int[L], the
    bytes each lane's records make (0 for a failed lane, which produces
    nothing); ``cap`` a multiple of 4.  ``out[l, i]`` is byte i of lane l's
    records for i < produced, else 0; the new window is the last 32 KiB of
    [window | out[:produced]].  Byte for byte ``materialize(recs_to_records(
    recs), window, produced, cap)``.  CPU tensors take
    ``materialize_records_plain``; CUDA tensors launch the kernel, one block
    a lane, with no wait on the device.
    """
    if recs.dim() != 2:
        raise ValueError("materialize_records: recs must be [K, L]")
    K, L = recs.shape
    if window.shape != (L, WINDOW) or window.dtype != torch.uint8:
        raise ValueError(f"materialize_records: window must be u8[{L}, "
                         f"{WINDOW}]")
    if produced.numel() != L:
        raise ValueError("materialize_records: produced needs one entry a "
                         "lane")
    if cap <= 0 or cap % 4:
        raise ValueError("materialize_records: cap must be a positive "
                         "multiple of 4")
    if recs.device.type == "cpu":
        return materialize_records_plain(recs, window, produced, cap)
    _build.require_cuda(recs, window, produced)
    dev = recs.device
    # The kernel's shared memory holds its scan sums and a list of 8 bytes a
    # record, and [window | out] when that fits too; else the wrapper gives
    # it a scratch row a lane in device memory.
    lists = _SCAN_BYTES + 8 * K
    if lists > SMEM_BYTES:
        raise ValueError(f"materialize_records: {K} records a lane do not "
                         "fit a block's shared memory")
    shared = lists + WINDOW + cap <= SMEM_BYTES
    recs = _build.i32(recs)
    window = window.contiguous()
    if window.data_ptr() % 4:
        window = window.clone()
    produced = _build.i64(produced)
    out = torch.empty(L, cap, dtype=torch.uint8, device=dev)
    new_window = torch.empty(L, WINDOW, dtype=torch.uint8, device=dev)
    if L == 0:
        return out, new_window
    scratch = None if shared else torch.empty(L, WINDOW + cap,
                                              dtype=torch.uint8, device=dev)
    _build.launch("materialize_records", dev, recs.data_ptr(),
                  window.data_ptr(), produced.data_ptr(), out.data_ptr(),
                  new_window.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), L, K, cap)
    return out, new_window
