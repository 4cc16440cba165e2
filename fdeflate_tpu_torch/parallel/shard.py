"""Multi-GPU stream sharding on ``torch.distributed``: the ("streams",
"seq") mesh.

JAX counterpart: ``fdeflate_tpu/parallel/shard.py``, every function under
its name, positional order and keywords (``make_mesh`` adds a keyword-only
``device``).  Independent zlib streams shard data-parallel over the
``streams`` axis: each rank runs the port's single-device function on its
slice, shared tables are replicated, and outputs gather back in stream
order.  The ``seq`` axis shards the bytes of every stream for the checksum,
whose ``(A, B, len)`` partials fold in order (``ops/adler32``).

The JAX idioms and their counterparts here:
  * ``Mesh(grid, ("streams", "seq"))`` -> a ``DeviceMesh`` with
    ``mesh_dim_names=("streams", "seq")`` over global ranks, one rank per
    GPU (NCCL) or per CPU process (gloo);
  * ``PartitionSpec``s -> DTensor placements: ``P("streams", None)`` and
    ``P("streams")`` are ``ROWS``, ``P(None, "seq")`` is ``COLS``, the
    ``[K, B]`` records' ``P(None, "streams")`` is ``RECORDS`` and ``P()``
    is ``REPLICATED``;
  * ``shard_map``'s body -> the port's function on ``to_local()``.  A
    sharded function takes global tensors (numpy arrays too), which each
    rank slices with no communication (``src_data_rank=None``: every rank
    must hold the same values), or DTensors, which are redistributed to
    the placements above; it returns DTensors with JAX's out-specs, and
    ``full_tensor()`` gathers one in stream order;
  * ``psum(x, axis)`` -> ``all_reduce(SUM)`` over the axis' group;
    ``all_gather`` -> ``all_gather`` over the axis' group, put in the
    axis' mesh order; ``pmean`` -> ``all_reduce`` and a division by the
    axis' size.  JAX's ``pmean`` of an int32 ``psum`` is float32, so every
    mesh-wide ``total`` is a float32 0-d tensor here too.

JAX's ``jit(in_shardings=...)`` raises when B is not a multiple of the
``streams`` size and ``shard_map`` when N is not a multiple of ``seq``;
DTensor would shard unevenly, so the port raises ValueError instead.

Differences kept on purpose: words are int32 and checksums int64 where
JAX's are uint32 (the same bits); ``sharded_decode_symbols`` returns all
six record arrays of ``decode_symbols`` (JAX's out-specs name five, so its
jitted function raises a pytree error when called); the ``U`` knobs size
TPU grids and are accepted and ignored (ROADMAP "Call forms").
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..ops.adler32 import adler32_batch, adler32_partial, combine_partials
from ..ops.decode_symbols import decode_symbols
from ..ops.inflate_records import (DONE_BAD_LITLEN, DONE_EOB, NO_LIMIT,
                                   inflate_records, lanes_from_blocked)
from ..ops.ultrafast import device_of, encode_ultrafast_batch
from .device_pipeline import (fused_adaptive_roundtrip,
                              fused_ultrafast_roundtrip,
                              fused_ultrafast_roundtrip_v2,
                              fused_zlib_roundtrip)
from .multihost import local_rank

AXES = ("streams", "seq")
ROWS = (Shard(0), Replicate())           # P("streams", None), P("streams")
COLS = (Replicate(), Shard(1))           # P(None, "seq")
RECORDS = (Shard(1), Replicate())        # P(None, "streams"): [K, B]
REPLICATED = (Replicate(), Replicate())  # P()


def make_mesh(shape: tuple[int, int] | None = None, devices=None, *,
              device="cuda"):
    """A ("streams", "seq") ``DeviceMesh`` (JAX ``make_mesh`` :23).

    ``devices``: the global ranks of the mesh, all of them by default;
    ``shape`` (streams, seq), ``(len(devices), 1)`` by default.  With
    ``device="cuda"`` the ranks talk over NCCL, each on ``cuda:LOCAL_RANK``;
    with ``"cpu"`` over gloo.  Without CUDA the default raises
    RuntimeError.  When no process group exists, one of a single process
    is started (a ``HashStore``: no network, no environment variables),
    the counterpart of JAX's single-process default; an existing group
    whose backend does not serve ``device`` raises (NCCL never quietly
    becomes gloo).  Every rank of the group calls this together.
    """
    dev = device_of(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(local_rank())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif backend not in dist.get_backend():
        raise RuntimeError(f"make_mesh(device={device!r}) needs a {backend} "
                           f"process group, not {dist.get_backend()}")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    if shape is None:
        shape = (len(ranks), 1)
    if shape[0] * shape[1] != len(ranks):
        raise ValueError(f"mesh shape {shape} does not hold {len(ranks)} ranks")
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=AXES)


def _local(mesh, x, placements, name: str) -> torch.Tensor:
    """This rank's shard of ``x`` under ``placements``: a global tensor or
    array sliced with no communication, or a DTensor redistributed;
    raises ValueError where a sharded dimension does not divide."""
    for axis, p in enumerate(placements):
        if isinstance(p, Shard) and x.shape[p.dim] % mesh.size(axis):
            raise ValueError(f"{name}: dimension {p.dim} ({x.shape[p.dim]}) "
                             f"is not a multiple of the {AXES[axis]!r} size "
                             f"{mesh.size(axis)}")
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements).to_local().contiguous()
    if isinstance(x, np.ndarray) and x.dtype == np.uint32:
        x = x.view(np.int32)    # JAX's u32 words and tables: the same bits
    x = distribute_tensor(torch.as_tensor(x), mesh, placements,
                          src_data_rank=None)
    return x.to_local().contiguous()


def _global(mesh, local: torch.Tensor, placements) -> DTensor:
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _mesh_total(mesh, count: torch.Tensor) -> torch.Tensor:
    """JAX's ``pmean(psum(count, "streams"), "seq")`` of an int32 count:
    float32 0-d, the same on every rank."""
    t = count.reshape(1).to(torch.int32)
    dist.all_reduce(t, group=mesh.get_group("streams"))
    dist.all_reduce(t, group=mesh.get_group("seq"))
    return t.to(torch.float32).reshape(()) / mesh.size(1)


def _full_lengths(local: torch.Tensor) -> torch.Tensor:
    Bs, N = local.shape
    return torch.full((Bs,), N, dtype=torch.int32, device=local.device)


def sharded_encode_ultrafast(mesh):
    """Batch ultra-fast encode sharded over ``streams`` (JAX :38).

    fn(data u8[B, N], lengths i32[B]) -> (words int32[B, W], bits
    int32[B], adler int64[B]), each placed ``ROWS``: the port's
    ``encode_ultrafast_batch(data, lengths)`` on each shard (one lane per
    stream: K1 at C = 1, K2, K7)."""

    def fn(data, lengths):
        d = _local(mesh, data, ROWS, "data")
        n = _local(mesh, lengths, ROWS, "lengths")
        return tuple(_global(mesh, x, ROWS)
                     for x in encode_ultrafast_batch(d, n))

    return fn


def sharded_decode_symbols(mesh, max_steps: int):
    """Lane-per-stream symbol decode sharded over ``streams`` (JAX :58).

    fn(words, bit_pos, bit_end, out_pos, active, table_id, litlen,
    litlen_sec, dist, dist_sec) -> (records, (bit_pos, out_pos, status)):
    ``decode_symbols`` (K11's full form) on each shard; the tables are
    replicated, the six records ``[max_steps, B]`` placed ``RECORDS`` and
    the state ``ROWS``."""

    def fn(words, bit_pos, bit_end, out_pos, active, table_id, litlen,
           litlen_sec, dist, dist_sec):
        lanes = [_local(mesh, x, ROWS, name) for x, name in (
            (words, "words"), (bit_pos, "bit_pos"), (bit_end, "bit_end"),
            (out_pos, "out_pos"), (active, "active"),
            (table_id, "table_id"))]
        tables = [_local(mesh, x, REPLICATED, "tables")
                  for x in (litlen, litlen_sec, dist, dist_sec)]
        records, state = decode_symbols(*lanes, *tables, max_steps=max_steps)
        return (tuple(_global(mesh, r, RECORDS) for r in records),
                tuple(_global(mesh, s, ROWS) for s in state))

    return fn


def checksum_tree_reduce(mesh):
    """Sequence-parallel Adler-32 (JAX :91): fn(data u8[B, N]) -> int64[B]
    u32 checksums, replicated.

    N shards over ``seq`` (B is replicated over ``streams``); each rank's
    ``(A, B, len)`` partials of its ``[B, N / seq]`` slice (K7 on the
    card) are all-gathered over ``seq`` and folded in the axis' order
    (JAX's ``lax.scan`` at :108-118)."""

    def fn(data):
        local = _local(mesh, data, COLS, "data")
        a, b, n = adler32_partial(local)
        group = mesh.get_group("seq")
        parts = [torch.empty((3,) + a.shape, dtype=torch.int64,
                             device=a.device) for _ in range(mesh.size(1))]
        dist.all_gather(parts, torch.stack([a, b, n]), group=group)
        # group rank -> seq coordinate: this rank's row of the mesh lists
        # its seq group's global ranks in mesh order
        row = mesh.mesh[mesh.get_coordinate()[0]].tolist()
        members = dist.get_process_group_ranks(group)
        acc = (torch.ones_like(a), torch.zeros_like(b), torch.zeros_like(n))
        for r in row:
            acc = combine_partials(acc, tuple(parts[members.index(r)]))
        return _global(mesh, (acc[1] << 16) | acc[0], REPLICATED)

    return fn


def roundtrip_step(mesh, max_steps: int = 512, chunks: int = 4):
    """The sharded indexed codec step (JAX :131).

    fn(data u8[B, N]) -> (produced int32[B], adler int64[B], total float32):
    ``fused_ultrafast_roundtrip(chunks, max_steps, N)`` on each shard (K1,
    K2, K7, K11's live form, built once per (N, device)), the verified
    bytes summed over ``streams`` and averaged over ``seq``, and each
    stream's Adler-32 (K7)."""

    @functools.cache
    def build(N: int, device):
        return fused_ultrafast_roundtrip(chunks, max_steps=max_steps, N=N,
                                         device=device)

    def fn(data):
        local = _local(mesh, data, ROWS, "data")
        lengths = _full_lengths(local)
        step = build(local.shape[1], local.device)
        _out, produced, ok, ck_ok = step(local, lengths)
        total = _mesh_total(mesh, torch.where(ok & ck_ok, produced, 0).sum())
        adler = adler32_batch(local, lengths)
        return (_global(mesh, produced, ROWS), _global(mesh, adler, ROWS),
                _global(mesh, total, REPLICATED))

    return fn


def _verified_step(mesh, make, collectives: bool = True):
    """fn(data u8[B, N]) -> (bpos_ok bool[B], ck_ok bool[B], total): the
    roundtrip ``make(N, device)`` builds, on each shard; ``total`` counts
    N for each stream that passes both checks, mesh-wide (float32) or,
    without ``collectives``, this shard's (int32).  The roundtrip is built
    once per (N, device), as JAX's jit compiles once per shape."""
    build = functools.cache(make)

    def fn(data):
        local = _local(mesh, data, ROWS, "data")
        N = local.shape[1]
        bpos_ok, ck_ok = build(N, local.device)(local, _full_lengths(local))[1:3]
        count = torch.where(bpos_ok & ck_ok, N, 0).sum().to(torch.int32)
        total = _mesh_total(mesh, count) if collectives else count
        return (_global(mesh, bpos_ok, ROWS), _global(mesh, ck_ok, ROWS),
                _global(mesh, total, REPLICATED))

    return fn


def roundtrip_step_v2(mesh, chunks: int = 8, U: int | None = None,
                      collectives: bool = True):
    """The sharded blocked-layout step (JAX :176):
    ``fused_ultrafast_roundtrip_v2`` (K1 into lane windows, K3) on each
    shard.  fn(data u8[B, N]) -> (bpos_ok, ck_ok, total)."""
    del U
    return _verified_step(mesh, lambda N, dev: fused_ultrafast_roundtrip_v2(
        chunks, N=N, device=dev), collectives)


def roundtrip_step_zlib(mesh, chunks: int = 8, U: int | None = None,
                        collectives: bool = True):
    """The sharded standard-zlib step (JAX :219): ``fused_zlib_roundtrip``
    (K1, K2, K7, K3 on the linear words) on each shard.  JAX stages the
    words into windows of ``stage_wwin(S)``; the port reads them in place.
    fn(data u8[B, N]) -> (bpos_ok, ck_ok, total); ``collectives=False``
    keeps each shard's own count, to time the collectives against."""
    del U
    return _verified_step(mesh, lambda N, dev: fused_zlib_roundtrip(
        chunks, N, device=dev), collectives)


def roundtrip_step_adaptive(mesh, chunks: int = 4, U: int = 8):
    """The sharded adaptive-tree step (JAX :270): each shard builds its
    tree on its own slice (``fused_adaptive_roundtrip``).
    fn(data u8[B, N]) -> (bpos_ok, ck_ok, total)."""
    return _verified_step(mesh, lambda N, dev: fused_adaptive_roundtrip(
        chunks, N, U=U, device=dev))


def foreign_records_step(mesh, K: int = 48, U: int = 16):
    """Sharded foreign-block record decode (JAX :310), lane-blocks over
    ``streams``.

    fn(win i32[LB, wwin, 8, 128], pos0 i32[LB, 8, 128], meta
    i32[LB, 64, 8, 128], tab i32[LB, 160, 8, 128]) -> (bpos
    i32[LB, 8, 128], done i32[LB, 8, 128], eob_total float32), JAX's
    lane-blocked layout.  Each rank turns its lane-blocks into K4's flat
    form (``lanes_from_blocked``): lane i's window is its own run of words
    [i * wwin, (i + 1) * wwin), read from ``start = i * wwin * 32 + pos0``
    up to its end, with no ``bit_end`` or ``out0`` limit, and runs K4
    (``inflate_records``).  ``bpos`` counts bits from the window's start.
    ``done`` is JAX's: 0 out of slots, 1 EOB, 2 invalid; K4's exit codes
    map as 0 -> 0, 1 -> 1, 2 and 3 (an invalid literal/length or distance
    code) -> 2, and 4 and 5 (``bit_end``, ``out0``) cannot occur without
    limits.  ``eob_total`` counts the lanes with ``done == 1`` mesh-wide.
    ``U`` (steps per TPU grid cell) is accepted and ignored."""
    del U

    def fn(win, pos0, meta, tab):
        win, pos0, meta, tab = (_local(mesh, x, ROWS, name) for x, name in (
            (win, "win"), (pos0, "pos0"), (meta, "meta"), (tab, "tab")))
        LB, wwin = win.shape[:2]
        dev = win.device
        base = torch.arange(LB * 1024, dtype=torch.int64, device=dev) * wwin
        start = base * 32 + lanes_from_blocked(pos0[:, None])[:, 0]
        unlimited = torch.full_like(base, NO_LIMIT)
        _recs, bpos, _nout, done = inflate_records(
            lanes_from_blocked(win).reshape(-1), start, base + wwin,
            unlimited, unlimited, lanes_from_blocked(meta),
            lanes_from_blocked(tab), K)
        bpos = (bpos - base * 32).to(torch.int32).reshape(LB, 8, 128)
        done = done.clamp(max=DONE_BAD_LITLEN).reshape(LB, 8, 128)
        total = _mesh_total(mesh, (done == DONE_EOB).sum())
        return (_global(mesh, bpos, ROWS), _global(mesh, done, ROWS),
                _global(mesh, total, REPLICATED))

    return fn
