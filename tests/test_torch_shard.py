"""The port's scale-out layer (``fdeflate_tpu_torch/parallel/shard.py``,
``parallel/multihost.py``, the Adler-32 partial fold) against the JAX
package.

The port runs on a world of 4 gloo processes (``tools/mesh_world``, one
spawn for the module) on the meshes (4, 1), (2, 2) and (1, 4), and its
gathered outputs (``full_tensor()``) are held exactly:
  * to JAX's sharded functions on the 8-device CPU mesh of
    tests/conftest.py, whose bodies are XLA here: ``sharded_encode_ultrafast``,
    ``checksum_tree_reduce`` (and ``zlib.adler32``) and ``roundtrip_step``
    (its float32 ``total`` too).  A sharded result does not depend on the
    mesh, so JAX's mesh of 8 and the port's of 4 agree.  JAX's
    ``sharded_decode_symbols`` raises when called (its out-specs name five
    record arrays, ``decode_symbols`` returns six), so the port's is held
    to JAX's unsharded ``decode_symbols``, jitted;
  * for the v2, zlib and adaptive steps, whose JAX bodies run Pallas in
    interpret mode here, to the port's single-process function on each
    shard (held to JAX by test_torch_blocked.py, test_torch_roundtrip.py
    and test_torch_adaptive.py);
  * for ``foreign_records_step``, lane by lane to
    ``pallas_inflate.decode_records_np``.
"""

from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdeflate_tpu.huffman import build_table as j_build_table
from fdeflate_tpu.models.ultrafast import STREAM_HEADER_BITS
from fdeflate_tpu.ops import adler32 as JA
from fdeflate_tpu.ops import inflate as JI
from fdeflate_tpu.ops import pallas_inflate as JPI
from fdeflate_tpu.parallel import shard as JS
from fdeflate_tpu.tables import (
    DEFAULT_DIST_TABLE_SIZE,
    DEFAULT_LITLEN_TABLE_SIZE,
    DISTANCE_TABLE_ENTRIES,
    HUFFMAN_LENGTHS,
    LITLEN_TABLE_ENTRIES,
)
from fdeflate_tpu_torch.ops import adler32 as PA
from fdeflate_tpu_torch.parallel import multihost as PM
from fdeflate_tpu_torch.parallel import shard as PS
from fdeflate_tpu_torch.parallel.device_pipeline import (
    fused_adaptive_roundtrip,
    fused_ultrafast_roundtrip_v2,
    fused_zlib_roundtrip,
)
from fdeflate_tpu_torch.tools import mesh_world as MW

B, N = 16, 512
SHAPES = [(4, 1), (2, 2), (1, 4)]
SHAPE_IDS = [f"{a}x{b}" for a, b in SHAPES]
LB, WWIN = 4, 64
INACTIVE = (4, 11)          # lanes of the symbol decode left inactive


def _data() -> tuple[np.ndarray, np.ndarray]:
    """16 x 512 bytes: runs of zeros and a few symbols, one random row, an
    all-zero row, ragged streams (zero past their lengths) for the encode."""
    rng = np.random.default_rng(13)
    data = rng.choice([0, 0, 0, 7, 42, 200], size=(B, N)).astype(np.uint8)
    data[1] = rng.integers(0, 256, N, dtype=np.uint8)
    data[2] = 0
    data[3, ::5] = 9
    lengths = np.full(B, N, np.int32)
    lengths[5], lengths[9] = 300, 1
    data[5, 300:] = 0
    data[9, 1:] = 0
    return data, lengths


def _v1_tables():
    """The trained litlen table and the one-code distance table (JAX
    ``entry_v1``'s), u32[1, ...]."""
    litlen = j_build_table(
        HUFFMAN_LENGTHS, LITLEN_TABLE_ENTRIES, DEFAULT_LITLEN_TABLE_SIZE,
        is_distance_table=False, double_literal=True)
    dl = np.zeros(32, np.int64)
    dl[0] = 1
    dist = j_build_table(dl, DISTANCE_TABLE_ENTRIES, DEFAULT_DIST_TABLE_SIZE,
                         is_distance_table=True, double_literal=False)
    sec = litlen.secondary if len(litlen.secondary) else np.zeros(1, np.uint16)
    return [x[None].astype(np.uint32) for x in
            (litlen.primary, sec, dist.primary, np.zeros(1, np.uint32))]


def _foreign_lane(kind: int, rng):
    """(window u32[WWIN], pos0, meta, tab) of one block: zlib-6 dynamic
    blocks of 64-700 bytes (the longer ones run out of K = 48 slots or past
    the window), a Z_FIXED block, and that block with a byte flipped where
    the decode then meets an invalid code (length 286-287 or distance
    30-31: a complete dynamic code has no invalid literal/length)."""
    if kind in (1, 7):
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
        z = co.compress(b"scale-out " * 9) + co.flush()
    else:
        n = [64, 150, 700, 90, 300][kind % 5]
        z = zlib.compress(
            rng.integers(0, 3 + kind, n).astype(np.uint8).tobytes(), 6)
    r = JI._HostBitReader(z[2:])
    r.take(1)
    if r.take(2) == 1:
        meta, tab = JI._fixed_foreign_meta()
    else:
        lengths, hlit = JI._parse_dynamic_lengths(r)
        meta, tab = JPI.foreign_meta(lengths[:hlit], lengths[288:320])
    words = np.frombuffer(z[2:] + bytes((-len(z[2:])) % 4) + bytes(4 * WWIN),
                          "<u4")
    w0 = r.pos >> 5
    win = words[w0:w0 + WWIN].copy()
    if kind == 7:
        for j in range(WWIN * 4):
            bad = win.copy()
            bad.view(np.uint8)[j] ^= 0xFF
            if JPI.decode_records_np(bad, r.pos & 31, meta, tab,
                                     MW.FOREIGN_K)[2] == 2:
                win = bad
                break
    return win, r.pos & 31, meta, tab


LANE_SPOTS = [(0, 0), (0, 1), (3, 77), (7, 127), (5, 3), (1, 64), (6, 100),
              (2, 2)]


def _foreign_inputs():
    """JAX's lane-blocked inputs [LB, rows, 8, 128], eight real lanes in
    each lane-block, the rest all zero."""
    rng = np.random.default_rng(21)
    win = np.zeros((LB, WWIN, 8, 128), np.int32)
    pos0 = np.zeros((LB, 8, 128), np.int32)
    meta = np.zeros((LB, 64, 8, 128), np.int32)
    tab = np.zeros((LB, JPI._TPAIRS, 8, 128), np.int32)
    for lb in range(LB):
        for kind, (s, l) in enumerate(LANE_SPOTS):
            w, p, m, t = _foreign_lane(kind, rng)
            win[lb, :, s, l] = w.view(np.int32)
            pos0[lb, s, l] = p
            meta[lb, :, s, l] = m
            tab[lb, :, s, l] = t
    return win, pos0, meta, tab


def _inputs() -> dict:
    data, lengths = _data()
    words, bits, _ = JS.sharded_encode_ultrafast(JS.make_mesh((8, 1)))(
        jnp.asarray(data), jnp.asarray(lengths))
    active = np.ones(B, bool)
    active[list(INACTIVE)] = False
    tables = _v1_tables()
    win, pos0, meta, tab = _foreign_inputs()
    return dict(
        data=data, lengths=lengths, ds_words=np.asarray(words),
        ds_bit_pos=np.full(B, STREAM_HEADER_BITS, np.int32),
        ds_bit_end=np.asarray(bits), ds_out_pos=np.zeros(B, np.int32),
        ds_active=active, ds_table_id=np.zeros(B, np.int32),
        ds_litlen=tables[0], ds_litlen_sec=tables[1], ds_dist=tables[2],
        ds_dist_sec=tables[3], win=win, pos0=pos0, meta=meta, tab=tab)



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: the tier runs
    several workers and spawned ranks on a few cores, where torch's
    threads spin against each other (the per-shard oracles took ~60x
    their single-process time with the default count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def inputs() -> dict:
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The port's outputs on the three meshes: {shape: (gathered, [rank
    values])}, from one world of 4 gloo ranks."""
    d = tmp_path_factory.mktemp("mesh_world")
    np.savez(d / "inputs.npz", **inputs)
    MW.run_world(str(d / "inputs.npz"), str(d), SHAPES, timeout=120)
    out = {}
    for a, b in SHAPES:
        gathered = dict(np.load(d / f"{a}x{b}.npz"))
        ranks = [dict(np.load(d / f"{a}x{b}.rank{r}.npz")) for r in range(4)]
        out[(a, b)] = (gathered, ranks)
    return out


@pytest.fixture(scope="module")
def jax_outputs(inputs):
    """JAX's sharded encode (mesh (8, 1)), checksum (mesh (1, 8)),
    roundtrip step (mesh (4, 2)) and unsharded decode_symbols."""
    data = jnp.asarray(inputs["data"])
    enc = JS.sharded_encode_ultrafast(JS.make_mesh((8, 1)))(
        data, jnp.asarray(inputs["lengths"]))
    ck = JS.checksum_tree_reduce(JS.make_mesh((1, 8)))(data)
    rt = JS.roundtrip_step(JS.make_mesh((4, 2)))(data)
    args = [jnp.asarray(inputs[f"ds_{k}"]) for k in (
        "words", "bit_pos", "bit_end", "out_pos", "active", "table_id",
        "litlen", "litlen_sec", "dist", "dist_sec")]
    ds = jax.jit(lambda *a: JI.decode_symbols(*a, max_steps=MW.DECODE_STEPS))(
        *args)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {"enc": to_np(enc), "ck": to_np(ck), "rt": to_np(rt),
            "ds": to_np(ds)}


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_encode_equals_jax(world, jax_outputs, shape):
    got, _ = world[shape]
    for i, want in enumerate(jax_outputs["enc"]):
        assert got[f"enc{i}"].shape == want.shape, i
        np.testing.assert_array_equal(_u32(got[f"enc{i}"]), _u32(want))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_decode_symbols_equals_jax(world, jax_outputs, shape):
    """Six [K, B] records sharded on B and the state, against JAX's
    ``decode_symbols`` on the whole batch; some lanes inactive, some out of
    steps, some at EOB."""
    got, _ = world[shape]
    records, state = jax_outputs["ds"]
    assert len(records) == 6
    for i, want in enumerate(records):
        assert got[f"ds_rec{i}"].shape == (MW.DECODE_STEPS, B)
        np.testing.assert_array_equal(_u32(got[f"ds_rec{i}"]), _u32(want),
                                      err_msg=str(i))
    for i, want in enumerate(state):
        np.testing.assert_array_equal(_u32(got[f"ds_state{i}"]), _u32(want),
                                      err_msg=str(i))
    status = got["ds_state2"]
    assert (got["ds_rec5"][:, list(INACTIVE)] == -1).all()
    assert {0, 1} <= set(status.tolist())


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_checksum_tree_reduce_equals_jax_and_zlib(world, jax_outputs, inputs,
                                                 shape):
    got, _ = world[shape]
    np.testing.assert_array_equal(got["ck"], _u32(jax_outputs["ck"]))
    assert got["ck"].tolist() == [zlib.adler32(r.tobytes())
                                  for r in inputs["data"]]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_roundtrip_step_equals_jax(world, jax_outputs, shape):
    """produced, adler and the float32 total (JAX's pmean of an int32
    psum) equal JAX's."""
    got, _ = world[shape]
    produced, adler, total = jax_outputs["rt"]
    np.testing.assert_array_equal(got["rt0"], produced)
    np.testing.assert_array_equal(got["rt1"], _u32(adler))
    assert total.dtype == got["rt2"].dtype == np.float32
    assert got["rt2"] == total == np.float32(B * N)


STEPS = {
    "v2": lambda d, n: fused_ultrafast_roundtrip_v2(8, N, device="cpu")(d, n),
    "zlib": lambda d, n: fused_zlib_roundtrip(8, N, device="cpu")(d, n),
    "adaptive": lambda d, n: fused_adaptive_roundtrip(4, N, U=8,
                                                      device="cpu")(d, n),
}


@pytest.fixture(scope="module")
def per_shard(inputs):
    """The port's single-process steps on each streams shard: {(step,
    streams): (bpos_ok, ck_ok)}; the adaptive step trains its tree on the
    shard alone, as each rank does."""
    data = torch.from_numpy(inputs["data"])
    lengths = torch.full((B,), N, dtype=torch.int32)
    out = {}
    for name, step in STEPS.items():
        for streams in sorted({a for a, _ in SHAPES}):
            parts = [step(d, n)[1:3] for d, n in
                     zip(data.chunk(streams), lengths.chunk(streams))]
            out[name, streams] = tuple(
                torch.cat([p[i] for p in parts]).numpy() for i in range(2))
    return out


@pytest.mark.parametrize("name", sorted(STEPS))
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_verified_steps_equal_the_port_per_shard(world, per_shard, shape,
                                                 name):
    got, _ = world[shape]
    bpos_ok, ck_ok = per_shard[name, shape[0]]
    key = "v2_" if name == "v2" else name
    np.testing.assert_array_equal(got[f"{key}0"], bpos_ok)
    np.testing.assert_array_equal(got[f"{key}1"], ck_ok)
    assert bpos_ok.all() and ck_ok.all()
    assert got[f"{key}2"].dtype == np.float32 and got[f"{key}2"] == B * N


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_collectives_false_keeps_the_shard_count(world, shape):
    """Without collectives each rank's total is its own shard's verified
    bytes (int32), JAX's shard-local sum."""
    _, ranks = world[shape]
    streams = shape[0]
    for rank, r in enumerate(ranks):
        row = int(r["coordinate"][0])
        assert tuple(r["coordinate"]) == divmod(rank, shape[1])
        for name in ("v2", "zlib"):
            assert r[f"{name}_local"].dtype == np.int32
            assert int(r[f"{name}_local"]) == (B // streams) * N, (row, name)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_dtensor_input_equals_global_input(world, shape):
    """A replicated DTensor is redistributed to the step's placements and
    gives what the global array gives."""
    got, _ = world[shape]
    for i in range(3):
        np.testing.assert_array_equal(got[f"v2_dtensor{i}"], got[f"v2_{i}"])


@pytest.fixture(scope="module")
def foreign_oracle(inputs):
    """``decode_records_np`` (bpos, done) of every lane, blocked; the
    all-zero padding lanes share one oracle call."""
    win, pos0, meta, tab = (inputs[k] for k in ("win", "pos0", "meta", "tab"))
    bpos = np.zeros((LB, 8, 128), np.int64)
    done = np.zeros((LB, 8, 128), np.int64)
    _r, pad_pos, pad_done = JPI.decode_records_np(
        np.zeros(WWIN, np.int32), 0, np.zeros(64, np.int32),
        np.zeros(JPI._TPAIRS, np.int32), MW.FOREIGN_K)
    bpos[:], done[:] = pad_pos, pad_done
    for lb in range(LB):
        for s, l in LANE_SPOTS:
            _r, bpos[lb, s, l], done[lb, s, l] = JPI.decode_records_np(
                win[lb, :, s, l], pos0[lb, s, l], meta[lb, :, s, l],
                tab[lb, :, s, l], MW.FOREIGN_K)
    return bpos, done


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_foreign_records_step_equals_decode_records_np(world, foreign_oracle,
                                                       shape):
    got, _ = world[shape]
    bpos, done = foreign_oracle
    np.testing.assert_array_equal(got["foreign0"], bpos)
    np.testing.assert_array_equal(got["foreign1"], done)
    assert got["foreign2"].dtype == np.float32
    assert got["foreign2"] == (done == 1).sum()
    real = done[:, [s for s, _ in LANE_SPOTS], [l for _, l in LANE_SPOTS]]
    assert {0, 1, 2} <= set(real.ravel().tolist())


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_indivisible_shapes_raise(world, shape):
    """B not a multiple of ``streams`` and N not a multiple of ``seq``
    raise ValueError, where JAX's jit and shard_map raise."""
    got, _ = world[shape]
    assert bool(got["raises_rows"]) == (shape[0] > 1)
    assert bool(got["raises_cols"]) == (shape[1] > 1)


def test_jax_sharded_decode_symbols_names_five_records(inputs):
    """JAX's ``sharded_decode_symbols`` raises when called: its out-specs
    name five record arrays where ``decode_symbols`` returns six.  The
    port returns all six; this test fails once the reference is fixed, so
    the port's test can move to JAX's sharded function."""
    fn = JS.sharded_decode_symbols(JS.make_mesh((8, 1)), 8)
    args = [jnp.asarray(inputs[f"ds_{k}"]) for k in (
        "words", "bit_pos", "bit_end", "out_pos", "active", "table_id",
        "litlen", "litlen_sec", "dist", "dist_sec")]
    with pytest.raises(ValueError, match="length 5"):
        fn(*args)


# ---- the partial fold against JAX --------------------------------------

def _partials(seed: int, n: int):
    """Random (A, B, len) partials; lengths include 0, 1 and values above
    65521."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, JA.MOD, n).astype(np.int32)
    b = rng.integers(0, JA.MOD, n).astype(np.int32)
    ln = rng.integers(0, 1 << 24, n).astype(np.int32)
    ln[:4] = [0, 1, JA.MOD, JA.MOD + 1]
    return a, b, ln


@pytest.mark.parametrize("seed", range(3))
def test_combine_partials_equals_jax(seed):
    p1, p2 = _partials(seed, 64), _partials(seed + 10, 64)
    want = JA.combine_partials_jax(*[tuple(jnp.asarray(x) for x in p)
                                     for p in (p1, p2)])
    got = PA.combine_partials(*[tuple(torch.from_numpy(x).to(torch.int64)
                                      for x in p) for p in (p1, p2)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_combine_tensor_equals_jax(seed):
    rng = np.random.default_rng(seed)
    a1 = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    a2 = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    ln = rng.integers(0, 1 << 31, 64).astype(np.uint32)
    ln[:4] = [0, 1, JA.MOD, JA.MOD + 7]
    want = np.asarray(JA.combine_jax(jnp.asarray(a1), jnp.asarray(a2),
                                     jnp.asarray(ln)))
    got = PA.combine_tensor(*(torch.from_numpy(x.astype(np.int64))
                              for x in (a1, a2, ln)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    host = [PA.combine(int(x), int(y), int(z)) for x, y, z in zip(a1, a2, ln)]
    np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("length", [None, 0, 1, 1000, 4096])
def test_adler32_partial_equals_jax(length):
    """Each row's (A, B, len) equals JAX's ``adler32_partial_jax`` of that
    row; the fold of two halves is the whole row's checksum."""
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (3, 4096), dtype=np.uint8)
    got = PA.adler32_partial(torch.from_numpy(data), length)
    for r in range(3):
        want = JA.adler32_partial_jax(jnp.asarray(data[r]), length)
        assert [int(g[r]) for g in got] == [int(w) for w in want]
    halves = [PA.adler32_partial(torch.from_numpy(h))
              for h in (data[:, :1500], data[:, 1500:])]
    a, b, n = PA.combine_partials(*halves)
    assert ((b << 16) | a).tolist() == [zlib.adler32(r.tobytes())
                                        for r in data]
    assert n.tolist() == [4096] * 3


# ---- one process, no world ----------------------------------------------

def test_make_mesh_starts_a_one_process_group(inputs):
    """Without a group, ``make_mesh(device="cpu")`` starts one of a single
    process (no network) and the steps run on its (1, 1) mesh; a CUDA mesh
    on that gloo group raises instead of falling back."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = PS.make_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1) and dist.get_world_size() == 1
        data = inputs["data"][:4]
        _ok, _ck, total = PS.roundtrip_step_v2(mesh)(data)
        assert int(total.full_tensor()) == 4 * N
        assert PM.local_batch_slice(B) == slice(0, B)
        PM.initialize_if_needed(device="cpu")          # a no-op: group exists
        assert tuple(PM.global_mesh(device="cpu").shape) == (1, 1)
        with pytest.raises(ValueError, match="does not hold"):
            PS.make_mesh((2, 1), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.slow  # JAX's v2 body runs its Pallas kernels in interpret mode
def test_roundtrip_step_v2_equals_jax_on_one_device(inputs):
    """The sharded blocked step on a (1, 1) mesh in both packages: JAX's
    ``roundtrip_step_v2`` on one CPU device and the port's on a one-process
    gloo group give the same checks and the same float32 total."""
    import torch.distributed as dist

    data = inputs["data"][:4]
    jmesh = JS.make_mesh((1, 1), jax.devices()[:1])
    want = [np.asarray(x) for x in
            JS.roundtrip_step_v2(jmesh, chunks=4)(jnp.asarray(data))]
    assert not dist.is_initialized()
    try:
        got = [x.full_tensor().numpy() for x in
               PS.roundtrip_step_v2(PS.make_mesh((1, 1), device="cpu"),
                                    chunks=4)(data)]
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert float(got[2]) == 4 * N


def test_make_mesh_refuses_a_gloo_group_for_cuda(monkeypatch):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(RuntimeError, match="needs a nccl process group"):
            PS.make_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


def test_multihost_without_a_group(monkeypatch):
    """No group and no multi-process setting: ``initialize_if_needed`` is a
    no-op and this process holds the whole batch."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    PM.initialize_if_needed(device="cpu")
    assert not dist.is_initialized()
    assert PM.local_batch_slice(10) == slice(0, 10)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert PM.local_rank() == 3


DEFAULT_DEVICE_CALLS = {
    "make_mesh": lambda: PS.make_mesh(),
    "global_mesh": lambda: PM.global_mesh(),
    "initialize_if_needed": lambda: PM.initialize_if_needed("localhost:1"),
    "spawn_world": lambda: PM.spawn_world(print, 2),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CALLS))
def test_scale_out_defaults_to_the_card(monkeypatch, name):
    """Without CUDA the default ``device="cuda"`` raises; nothing becomes
    gloo or the CPU."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[name]()
    assert not dist.is_initialized()
