"""Multi-process glue: process-group start-up, batch partitioning and worlds
of processes on one host.

JAX counterpart: ``fdeflate_tpu/parallel/multihost.py``
(``initialize_if_needed`` :14, ``local_batch_slice`` :33, ``global_mesh``
:42).  One process drives one GPU (or, on gloo, one CPU process), so
JAX's processes-and-devices become ranks.  The settings are torchrun's
standard environment, in place of JAX's:

    JAX_COORDINATOR_ADDRESS  ->  MASTER_ADDR, MASTER_PORT (or
                                 ``coordinator="host:port"``)
    JAX_NUM_PROCESSES        ->  WORLD_SIZE
    JAX_PROCESS_ID           ->  RANK (and LOCAL_RANK, the GPU on this host)

Collectives run over NCCL on the card and gloo for CPU tensors, with no
custom transport.  ``spawn_world`` starts a world of fresh processes on
this host (``dryrun_multichip(n, device="cpu")`` and the tests' gloo
worlds), each joined through a file in a temporary directory, so no port
is claimed.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pathlib
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..ops.ultrafast import device_of


def local_rank() -> int:
    """This process's GPU on its host (``LOCAL_RANK``, 0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_if_needed(coordinator: str | None = None, *,
                         device="cuda") -> None:
    """Start the default process group from torchrun's environment when
    running multi-process (JAX :14).

    A no-op when a group exists or no multi-process setting is given
    (neither ``coordinator`` nor a ``WORLD_SIZE`` above 1).
    ``coordinator="host:port"`` becomes ``tcp://host:port``; otherwise
    ``MASTER_ADDR`` and ``MASTER_PORT`` are read (``env://``).  NCCL for
    ``device="cuda"`` (this rank on ``cuda:LOCAL_RANK``), gloo for
    ``"cpu"``; without CUDA the default raises RuntimeError."""
    dev = device_of(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized() or (coordinator is None and world <= 1):
        return
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        rank=int(os.environ.get("RANK", "0")), world_size=world)


def local_batch_slice(global_batch: int) -> slice:
    """This rank's contiguous slice of a globally sharded stream batch
    (JAX :33; one rank per GPU, so the slice is per rank)."""
    n, r = ((dist.get_world_size(), dist.get_rank()) if dist.is_initialized()
            else (1, 0))
    per = global_batch // n
    return slice(per * r, per * (r + 1))


def global_mesh(shape=None, *, device="cuda"):
    """A ("streams", "seq") mesh over every rank of the group (JAX :42)."""
    from .shard import make_mesh

    return make_mesh(shape, device=device)


def _rank_main(fn, rank: int, world_size: int, tmp: str, device: str,
               timeout: float, args) -> None:
    """One rank of ``spawn_world``: join the group, run ``fn(*args)``,
    leave; a failure's traceback goes to ``rank<r>.err`` for the parent."""
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        if device == "cuda":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)   # the ranks share the host's cores
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=pathlib.Path(tmp, "init").as_uri(), rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        pathlib.Path(tmp, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_world(fn, world_size: int, args=(), *, device="cuda",
                timeout: float = 600.0) -> None:
    """Run ``fn(*args)`` in ``world_size`` fresh processes of one process
    group: gloo for ``device="cpu"``, NCCL for ``"cuda"`` (rank r on
    ``cuda:r``; more ranks than GPUs raise).  ``fn`` must be importable
    by name (the processes are spawned).  Returns when every rank has
    finished; raises RuntimeError with the first failing rank's traceback
    as soon as one fails, and TimeoutError after ``timeout`` seconds; the
    other ranks are then killed, so a hung collective stops here."""
    dev = device_of(device)
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks need {world_size} GPUs, not "
                         f"{torch.cuda.device_count()}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, tmp, dev.type, timeout, tuple(args)))
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            running = list(procs)
            while running and time.monotonic() < deadline:
                multiprocessing.connection.wait(
                    [p.sentinel for p in running],
                    timeout=max(0.0, deadline - time.monotonic()))
                running = [p for p in running if p.exitcode is None]
                failed = [r for r, p in enumerate(procs) if p.exitcode]
                if failed:
                    err = pathlib.Path(tmp, f"rank{failed[0]}.err")
                    raise RuntimeError(
                        f"rank {failed[0]} of {world_size} exited with "
                        f"{procs[failed[0]].exitcode}:\n"
                        + (err.read_text() if err.exists() else ""))
            if running:
                raise TimeoutError(f"{len(running)} of {world_size} ranks "
                                   f"still running after {timeout} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
