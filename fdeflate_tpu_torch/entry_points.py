"""The entry points of the port, after ``__graft_entry__.py``.

JAX counterpart: ``__graft_entry__.py`` (``entry`` :16, ``entry_v1`` :46,
``dryrun_multichip`` :102 with ``_dryrun_foreign`` :209), with the same
steps, shapes and seeds, on ``device`` ("cuda" unless the caller asks for
"cpu"; without CUDA the default raises RuntimeError).

``entry()`` returns the flagship forward step (``fused_ultrafast_roundtrip_v2``
at C = 8, N = 4096) and its example arguments; ``entry_v1()`` the one-lane
encode and the symbol decode; ``dryrun_multichip(n)`` builds an n-rank
("streams", "seq") mesh and runs every sharded step of
``parallel/shard.py`` on tiny shapes, asserting each result.  With
``device="cpu"`` it spawns n gloo processes (JAX re-runs itself on n
virtual CPU devices); with ``"cuda"``, n GPUs, and a process group of n
ranks or more that already exists is used as it is.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.distributed as dist

from .ops.decode_symbols import decode_symbols
from .ops.inflate_host import (_HostBitReader, _parse_dynamic_lengths,
                               foreign_meta)
from .ops.inflate_records import TAB_PAIRS
from .ops.ultrafast import device_of, encode_ultrafast_batch
from .parallel import shard as S
from .parallel.device_pipeline import (fused_ultrafast_roundtrip_v2,
                                       trained_symbol_tables)
from .parallel.multihost import spawn_world
from .trees import STREAM_HEADER_BITS

# seconds a spawned dry-run world may take before its ranks are killed (the
# 4-rank CPU world needs ~30 s)
DRYRUN_TIMEOUT = 120.0

def _example(B: int, N: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's example batch: ``default_rng(0).choice([0, 0, 0, 7, 42])``."""
    rng = np.random.default_rng(0)
    data = rng.choice([0, 0, 0, 7, 42], size=(B, N)).astype(np.uint8)
    return (torch.from_numpy(data).to(dev),
            torch.full((B,), N, dtype=torch.int32, device=dev))


def entry(*, device="cuda"):
    """The flagship forward step and its example arguments: ``fwd(data,
    lengths)`` runs ``fused_ultrafast_roundtrip_v2(8, N=4096, U=32)`` and
    returns (the int32 sum of the decoded words, the count of ``bpos_ok``,
    the count of ``ck_ok``), each an int32 0-d tensor.  JAX sums its
    step-major ``out_sm``, the same little-endian words (its padding lanes
    decode to zero), wrapping in int32 as here."""
    dev = device_of(device)
    C, N = 8, 4096
    step = fused_ultrafast_roundtrip_v2(C, N=N, U=32, device=dev)

    def fwd(data, lengths):
        out, bpos_ok, ck_ok = step(data, lengths)
        words = out.contiguous().view(torch.int32).sum(dtype=torch.int64)
        return (((words + 2**31) % 2**32 - 2**31).to(torch.int32),
                bpos_ok.sum(dtype=torch.int32), ck_ok.sum(dtype=torch.int32))

    return fwd, _example(4, N, dev)


def entry_v1(*, device="cuda"):
    """The one-lane encode and the symbol decode: ``step(data, lengths)``
    encodes each stream in one lane (``encode_ultrafast_batch``: K1 at
    C = 1, K2, K7), decodes it with ``decode_symbols(max_steps=256)`` (K11,
    the full form) from bit ``STREAM_HEADER_BITS`` over the trained tree's
    tables (``trained_symbol_tables``), and returns (out_pos int32[B], status int8[B],
    adler int64[B]); the example is JAX's 4 x 256 batch."""
    dev = device_of(device)
    tables = trained_symbol_tables(str(dev))[:4]

    def step(data, lengths):
        words, total_bits, adler = encode_ultrafast_batch(data, lengths)
        B = data.shape[0]
        i32 = dict(dtype=torch.int32, device=words.device)
        _records, (_bpos, opos, status) = decode_symbols(
            words, torch.full((B,), STREAM_HEADER_BITS, **i32), total_bits,
            torch.zeros(B, **i32), torch.ones(B, dtype=torch.bool,
                                              device=words.device),
            torch.zeros(B, **i32), *tables, max_steps=256)
        return opos, status, adler

    return step, _example(4, 256, dev)


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """Build an n-rank ("streams", "seq") mesh (``seq = 2`` when n is even)
    and assert every sharded step on it: ``roundtrip_step`` with
    ``max_steps = N + 8``, v2, zlib and adaptive at ``chunks=4`` (each
    verifying all B * N bytes), ``checksum_tree_reduce`` against
    ``zlib.adler32`` and ``foreign_records_step`` on one zlib-6 dynamic
    block per lane-block (every real lane at EOB).

    Inside a process group of at least n ranks (or n = 1 on the card,
    which starts a one-process group) it runs in this process on ranks
    0..n-1; otherwise it spawns n ranks (``spawn_world``: gloo processes
    for ``device="cpu"``, one per GPU for ``"cuda"``, where n above
    ``torch.cuda.device_count()`` raises)."""
    dev = device_of(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                         f"GPUs, not {torch.cuda.device_count()}")
    in_group = dist.is_initialized() and dist.get_world_size() >= n_devices
    if in_group or (n_devices == 1 and dev.type == "cuda"):
        _dryrun(n_devices, dev.type)
    else:
        spawn_world(_dryrun, n_devices, (n_devices, dev.type),
                    device=dev.type, timeout=DRYRUN_TIMEOUT)


def _check(ok: bool, message: str) -> None:
    """A dry run's assertion, kept under ``python -O``."""
    if not ok:
        raise AssertionError(message)


def _dryrun(n_devices: int, device: str) -> None:
    seq = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = S.make_mesh((n_devices // seq, seq), list(range(n_devices)),
                       device=device)
    if mesh.get_coordinate() is None:
        return                      # a rank outside the mesh
    B = max(8, (n_devices // seq) * 2)
    N = 512
    rng = np.random.default_rng(0)
    data = rng.choice([0, 0, 0, 9], size=(B, N)).astype(np.uint8)

    _produced, _adler, total = S.roundtrip_step(mesh, max_steps=N + 8)(data)
    total = int(total.full_tensor())
    _check(total == B * N, f"roundtrip decoded {total} != {B * N}")
    for name, make in (("v2", S.roundtrip_step_v2),
                       ("zlib-artifact", S.roundtrip_step_zlib),
                       ("adaptive", S.roundtrip_step_adaptive)):
        total = int(make(mesh, chunks=4)(data)[2].full_tensor())
        _check(total == B * N, f"{name} roundtrip verified {total} != {B * N}")

    got = int(S.checksum_tree_reduce(mesh)(data).full_tensor()[0])
    want = zlib.adler32(data[0].tobytes())
    _check(got == want, f"sharded checksum {got:#x} != {want:#x}")
    _dryrun_foreign(mesh, n_devices)


def _dryrun_foreign(mesh, n_devices: int) -> None:
    """The foreign record step over LB = n lane-blocks, one real zlib-6
    dynamic block in lane 0 of each (padding lanes decode inert all-zero
    windows)."""
    LB = n_devices
    wwin, K = 64, 48
    rng = np.random.default_rng(5)
    win = np.zeros((LB, wwin, 8, 128), np.int32)
    pos0 = np.zeros((LB, 8, 128), np.int32)
    meta = np.zeros((LB, 64, 8, 128), np.int32)
    tab = np.zeros((LB, TAB_PAIRS, 8, 128), np.int32)
    for lb in range(LB):
        raw = rng.integers(0, 6, 64).astype(np.uint8).tobytes()
        payload = zlib.compress(raw, 6)[2:]
        r = _HostBitReader(payload)
        r.take(1)                                   # BFINAL
        _check(r.take(2) == 2, "dryrun corpus must produce a dynamic block")
        lengths, hlit = _parse_dynamic_lengths(r)
        m, t = foreign_meta(lengths[:hlit], lengths[288:320])
        sym_start = r.pos
        words = np.frombuffer(
            payload + bytes((-len(payload)) % 4) + bytes(4 * wwin), "<u4"
        ).astype(np.int32)
        w0 = sym_start >> 5
        win[lb, :, 0, 0] = words[w0:w0 + wwin]
        pos0[lb, 0, 0] = sym_start & 31
        meta[lb, :, 0, 0] = m
        tab[lb, :, 0, 0] = t

    _bpos, done, eob_total = S.foreign_records_step(mesh, K=K, U=16)(
        win, pos0, meta, tab)
    done_real = done.full_tensor()[:, 0, 0].cpu().numpy()
    eob_total = int(eob_total.full_tensor())
    _check(eob_total >= LB, f"foreign EOB lanes {eob_total} < {LB}")
    _check((done_real == 1).all(), f"foreign lanes not EOB: {done_real}")
