"""Every sharded step of ``parallel/shard.py`` on a world of gloo processes,
for the CPU tests (``tests/test_torch_shard.py``).

``run_world(inputs, out_dir, shapes)`` spawns ``streams * seq`` ranks
(``multihost.spawn_world``) that load ``inputs`` (an ``.npz`` of global
arrays), build each mesh of ``shapes`` in turn and run on it:
``sharded_encode_ultrafast``, ``sharded_decode_symbols``,
``checksum_tree_reduce``, ``roundtrip_step``, ``roundtrip_step_v2`` (with
and without collectives, and once from a replicated DTensor),
``roundtrip_step_zlib``, ``roundtrip_step_adaptive`` and
``foreign_records_step``; and whether B and N that do not divide raise
ValueError.  Rank 0 saves the gathered outputs (``full_tensor()``) to
``<out_dir>/<streams>x<seq>.npz``; every rank saves its mesh coordinate
and its shard-local totals to ``<out_dir>/<streams>x<seq>.rank<r>.npz``.
The module imports nothing of JAX, so the spawned ranks load none.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, distribute_tensor

from ..parallel import shard as S
from ..parallel.multihost import spawn_world

DECODE_STEPS = 48       # sharded_decode_symbols' max_steps
FOREIGN_K = 48          # foreign_records_step's record slots


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _mesh_outputs(mesh, x: dict) -> tuple[dict, dict]:
    """(gathered outputs, this rank's local values) of every step."""
    out, mine = {}, {}

    def put(prefix, values):
        for i, v in enumerate(values):
            out[f"{prefix}{i}"] = v.full_tensor().numpy()

    data = x["data"]
    put("enc", S.sharded_encode_ultrafast(mesh)(data, x["lengths"]))
    records, state = S.sharded_decode_symbols(mesh, DECODE_STEPS)(
        *(x[f"ds_{k}"] for k in ("words", "bit_pos", "bit_end", "out_pos",
                                 "active", "table_id", "litlen", "litlen_sec",
                                 "dist", "dist_sec")))
    put("ds_rec", records)
    put("ds_state", state)
    out["ck"] = S.checksum_tree_reduce(mesh)(data).full_tensor().numpy()
    put("rt", S.roundtrip_step(mesh)(data))
    put("v2_", S.roundtrip_step_v2(mesh)(data))
    put("zlib", S.roundtrip_step_zlib(mesh)(data))
    put("adaptive", S.roundtrip_step_adaptive(mesh)(data))
    put("foreign", S.foreign_records_step(mesh, K=FOREIGN_K)(
        x["win"], x["pos0"], x["meta"], x["tab"]))
    whole = distribute_tensor(torch.from_numpy(data), mesh,
                              (Replicate(), Replicate()), src_data_rank=None)
    put("v2_dtensor", S.roundtrip_step_v2(mesh)(whole))
    for name, make in (("v2", S.roundtrip_step_v2),
                       ("zlib", S.roundtrip_step_zlib)):
        mine[f"{name}_local"] = make(mesh, collectives=False)(data)[2] \
            .to_local().numpy()
    mine["coordinate"] = np.array(mesh.get_coordinate())
    streams, seq = mesh.size(0), mesh.size(1)
    odd = data[: len(data) - streams + 1] if streams > 1 else None
    short = data[:, : data.shape[1] - 8 + 1] if seq > 1 else None
    out["raises_rows"] = np.array(odd is not None and _raises(
        lambda: S.roundtrip_step_v2(mesh)(odd)))
    out["raises_cols"] = np.array(short is not None and _raises(
        lambda: S.checksum_tree_reduce(mesh)(short)))
    return out, mine


def _rank(inputs: str, out_dir: str, shapes) -> None:
    x = dict(np.load(inputs))
    rank = dist.get_rank()
    for streams, seq in shapes:
        mesh = S.make_mesh((streams, seq), device="cpu")
        out, mine = _mesh_outputs(mesh, x)
        stem = pathlib.Path(out_dir, f"{streams}x{seq}")
        np.savez(f"{stem}.rank{rank}.npz", **mine)
        if rank == 0:
            np.savez(f"{stem}.npz", **out)


def run_world(inputs: str, out_dir: str, shapes, timeout: float = 120.0):
    """Run ``_rank`` on ``streams * seq`` gloo ranks (every shape has the
    same count)."""
    (n,) = {a * b for a, b in shapes}
    spawn_world(_rank, n, (inputs, out_dir, list(shapes)), device="cpu",
                timeout=timeout)
