"""The port's indexed chunk-parallel decode against the JAX package.

``decode_symbols`` (its plain version, the body K11 runs on the card),
``materialize`` with eight-literal records, ``indexed_materialize``,
``stitch_and_materialize``, ``indexed_decode_step``,
``fused_ultrafast_roundtrip`` and ``decompress_batch_indexed`` are held to
``fdeflate_tpu/ops/inflate.py`` and ``fdeflate_tpu/parallel/
device_pipeline.py`` on the CPU, on the same inputs: the indexed lanes of
tests/test_device_codec.py's fused roundtrip data, a dynamic block with
15-bit codes (``test_crafted_streams.lopsided_lengths``), K11's edge inputs
(``tools/edges.k11_edge_case``: truncation, invalid codes, distances too
far back, inactive lanes, stacked tables, ``stream_row``, exhausted
steps), speculative lanes started off symbol boundaries, and
tests/test_device_codec.py's indexed batch (capacity growth, empty and
tiny streams).  ``materialize`` is held to JAX through its front and
``materialize_flat`` on flat record lists built here; the consumers of
K11's live form (``indexed_materialize`` with ``steps``,
``decompress_batch_indexed``) read records whose rows past each lane's
step count hold garbage, as the card leaves them, and still give JAX's
(out, produced, ok), bytes and error classes.  Every output is an integer
or a byte: all comparisons are exact.  The JAX calls sit in module
fixtures.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdeflate_tpu import errors as JE
from fdeflate_tpu.ops import inflate as JI
from fdeflate_tpu.ops.ultrafast_kernel import (
    compress_batch_ultra_fast as jax_compress_batch,
    encode_ultrafast_batch,
)
from fdeflate_tpu.parallel import device_pipeline as JD
from fdeflate_tpu_torch import errors as PE
from fdeflate_tpu_torch.ops.decode_symbols import decode_symbols
from fdeflate_tpu_torch.ops import decode_symbols as DS
from fdeflate_tpu_torch.ops.inflate import materialize, materialize_flat
from fdeflate_tpu_torch.ops.ultrafast import encode_ultrafast_batch as P_encode
from fdeflate_tpu_torch.parallel import device_pipeline as PD
from fdeflate_tpu_torch.tools.edges import K11_KINDS, k11_edge_case
from fdeflate_tpu_torch.utils import profiling
from test_crafted_streams import emit_dynamic_block, lopsided_lengths
from test_torch_inflate import _records

B, N, C = 4, 32768, 8
STEPS = 8192


def _fused_data() -> np.ndarray:
    """tests/test_device_codec.py TestIndexedFusedPipeline's batch."""
    rng = np.random.default_rng(123)
    data = np.zeros((B, N), np.uint8)
    data[0] = rng.integers(0, 256, N, dtype=np.uint8)
    data[1, ::5] = 9
    data[3, :50] = 3
    return data


def _np(x) -> np.ndarray:
    """A JAX or torch array as numpy, u32 read as int32 bit patterns."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _equal(got, want, label=""):
    got, want = list(got), list(want)
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (label, i, g.shape, w.shape)
        assert g.dtype == w.dtype, (label, i, g.dtype, w.dtype)
        bad = np.argwhere(g != w)
        assert bad.size == 0, f"{label}: output {i} differs at {bad[:5].tolist()}"


def _jax_decode(kw: dict):
    """JAX ``decode_symbols`` on ``decode_symbols`` keywords (tensors or
    numpy), jitted."""
    kw = dict(kw)
    steps, chain = kw.pop("max_steps"), kw.pop("chain")
    static = {k: kw.pop(k) for k in ("bit_stop", "stream_row", "litlen_first")}
    args = [jnp.asarray(np.asarray(kw[k])) for k in (
        "words", "bit_pos", "bit_end", "out_pos", "active", "table_id",
        "litlen", "litlen_sec", "dist", "dist_sec")]
    args[0] = args[0].view(jnp.uint32) if args[0].dtype == jnp.int32 else args[0]
    opt = {k: None if v is None else jnp.asarray(np.asarray(v))
           for k, v in static.items()}
    fn = jax.jit(lambda *a, **o: JI.decode_symbols(
        *a, max_steps=steps, chain=chain, **o))
    return fn(*args, **opt)


@pytest.fixture(scope="module")
def indexed():
    """The fused data encoded by both packages, their index, and the
    ``decode_symbols`` keywords of its chunk lanes."""
    data = _fused_data()
    lengths = np.full(B, N, np.int32)
    jw, jtb, jad, jidx = jax.jit(
        lambda d, ln: encode_ultrafast_batch(d, ln, num_chunks=C))(
            jnp.asarray(data), jnp.asarray(lengths))
    pw, ptb, pad, pidx = P_encode(torch.from_numpy(data),
                                  torch.from_numpy(lengths), num_chunks=C)
    starts, bits_l, stops, srow, active = PD.chunk_lanes(ptb, pidx)
    t = PD._trained_tables()
    kw = dict(words=pw, bit_pos=starts, bit_end=bits_l,
              out_pos=torch.full_like(starts, 1 << 30), active=active,
              table_id=torch.zeros_like(starts), litlen=t[0],
              litlen_sec=t[1], dist=t[2], dist_sec=t[3], bit_stop=stops,
              stream_row=srow, litlen_first=t[4], max_steps=STEPS)
    return dict(data=data, lengths=lengths, jax=(jw, jtb, jad, jidx),
                port=(pw, ptb, pad, pidx), kw=kw)


def test_encode_indexed_equals_jax(indexed):
    jw, jtb, jad, jidx = indexed["jax"]
    pw, ptb, pad, pidx = indexed["port"]
    _equal((pw, ptb, pad.to(torch.int64), pidx),
           (jw, jtb, np.asarray(jad).astype(np.int64), jidx), "encode")


def test_trained_tables_equal_jax():
    for got, want in zip(PD._trained_tables(), JD._trained_tables()):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def chains(indexed):
    """JAX ``decode_symbols`` on the indexed lanes at chain 1, 2 and 4."""
    return {c: _jax_decode(dict(indexed["kw"], chain=c)) for c in (1, 2, 4)}


@pytest.mark.parametrize("chain", [1, 2, 4])
def test_decode_symbols_indexed_lanes(indexed, chains, chain):
    got = decode_symbols(**indexed["kw"], chain=chain)
    want = chains[chain]
    _equal(got[0] + got[1], tuple(want[0]) + tuple(want[1]), f"chain {chain}")
    assert set(got[1][2].tolist()) <= {1, 2}


@pytest.mark.parametrize("kind", K11_KINDS)
def test_decode_symbols_edges(kind):
    case = k11_edge_case(kind)
    got = decode_symbols(**case)
    want = _jax_decode(case)
    _equal(got[0] + got[1], tuple(want[0]) + tuple(want[1]), kind)


@pytest.mark.parametrize("chain", [1, 4])
def test_decode_symbols_secondary_block(chain):
    """A dynamic block with codes of up to 15 bits, decoded from its first
    symbol, from random bits and with bit_end inside it."""
    lengths = lopsided_lengths()
    rng = np.random.default_rng(7)
    symbols = [int(s) for s in rng.choice([0, 1, 2, 5, 9, 13, 14], 300)]
    z, _raw = emit_dynamic_block(lengths, np.zeros(30, np.int64), symbols)
    r = JI._HostBitReader(z, 16)
    r.take(3)
    tables = JI._parse_dynamic_header(r)
    assert len(tables[1]) > 1          # secondary entries exist
    from fdeflate_tpu_torch.ops.decode_symbols import stack_tables

    litlen, lsec, dist, dsec = stack_tables([tables])
    padded = z + bytes((-len(z)) % 4) + bytes(8)
    words = torch.from_numpy(np.frombuffer(padded, "<u4").view(np.int32)[None].copy())
    L = 12
    pos = np.concatenate([[r.pos] * 4, rng.integers(16, len(z) * 8, L - 4)])
    end = np.full(L, len(z) * 8)
    end[1] = r.pos + 200
    col = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    kw = dict(words=words, bit_pos=col(pos), bit_end=col(end),
              out_pos=col(np.full(L, 1 << 20)), active=torch.ones(L, dtype=torch.bool),
              table_id=col(np.zeros(L)), litlen=litlen, litlen_sec=lsec,
              dist=dist, dist_sec=dsec, bit_stop=None, stream_row=col(np.zeros(L)),
              litlen_first=None, max_steps=400, chain=chain)
    got = decode_symbols(**kw)
    want = _jax_decode(kw)
    _equal(got[0] + got[1], tuple(want[0]) + tuple(want[1]), "lopsided")
    assert int(got[1][2][0]) == JI._EOB


def _jax_records(chains):
    rl, rlh, rc, rn, rd, rp = chains[4][0]
    return rl, rlh, rc, rn, rd, rp


def test_materialize_eight_literals(indexed, chains):
    """Each lane's records as a stream of their own, after a random window
    that the lanes' distances reach into; the new window included."""
    recs = _jax_records(chains)
    rc, rn = np.asarray(recs[2]), np.asarray(recs[3])
    produced = (rc.astype(np.int32) + rn).sum(axis=0)
    cap = 1 << int(np.ceil(np.log2(produced.max())))
    L = rc.shape[1]
    window = np.random.default_rng(5).integers(0, 256, (L, JI.WINDOW),
                                               dtype=np.uint8)
    want = JI.materialize(tuple(recs[:5]), jnp.asarray(window),
                          jnp.asarray(produced), out_capacity=cap)
    got = materialize(tuple(torch.from_numpy(_np(x).copy()) for x in recs[:5]),
                      torch.from_numpy(window), torch.from_numpy(produced), cap)
    _equal(got, want, "materialize")


def test_indexed_materialize(indexed, chains):
    recs = _jax_records(chains)
    status = np.asarray(chains[4][1][2])
    starts = np.asarray(indexed["kw"]["bit_pos"])
    want = JD.indexed_materialize(tuple(recs), jnp.asarray(status),
                                  jnp.asarray(starts), C, out_capacity=N)
    got = PD.indexed_materialize(tuple(torch.from_numpy(_np(x)) for x in recs),
                                 torch.from_numpy(status),
                                 torch.from_numpy(starts), C, N)
    _equal(got, want, "indexed_materialize")
    assert got[2].all() and torch.equal(got[0], torch.from_numpy(indexed["data"]))


@pytest.mark.parametrize("shift", [0, 3])
def test_stitch_and_materialize(indexed, shift):
    """Chain-1 lanes started ``shift`` bits before their index entry (off
    symbol boundaries for shift > 0, so a lane syncs after a few steps),
    stopped at the next lane's entry."""
    kw = dict(indexed["kw"], chain=1)
    starts = kw["bit_pos"].clone()
    k = torch.arange(starts.numel()) % C
    kw["bit_pos"] = torch.where(k > 0, starts - shift, starts)
    recs, (bpos, _opos, status) = _jax_decode(kw)
    payload = indexed["port"][3][:, 0]
    want = JD.stitch_and_materialize(
        tuple(recs), bpos, status, jnp.asarray(kw["bit_pos"].numpy()),
        jnp.asarray(payload.numpy()), C, out_capacity=N)
    got = PD.stitch_and_materialize(
        tuple(torch.from_numpy(_np(x)) for x in recs),
        torch.from_numpy(_np(bpos)), torch.from_numpy(_np(status)),
        kw["bit_pos"], payload, C, N)
    _equal(got, want, f"stitch, shift {shift}")
    if shift == 0:
        assert got[2].all()


def test_indexed_decode_step(indexed):
    pw, ptb, _pad, pidx = indexed["port"]
    jw, jtb, _jad, jidx = indexed["jax"]
    want = jax.jit(JD.indexed_decode_step(C, STEPS, N))(jw, jtb, jidx)
    got = PD.indexed_decode_step(C, STEPS, N)(pw, ptb, pidx)
    _equal(got, want, "indexed_decode_step")


def test_fused_ultrafast_roundtrip(indexed):
    data, lengths = indexed["data"], indexed["lengths"]
    want = jax.jit(JD.fused_ultrafast_roundtrip(C, max_steps=STEPS, N=N))(
        jnp.asarray(data), jnp.asarray(lengths))
    got = PD.fused_ultrafast_roundtrip(C, STEPS, N, device="cpu")(data, lengths)
    _equal(got, want, "fused_ultrafast_roundtrip")
    out, produced, ok, ck_ok = got
    assert ok.all() and ck_ok.all() and (produced == N).all()
    assert torch.equal(out, torch.from_numpy(data))


@pytest.fixture(scope="module")
def batch():
    """tests/test_device_codec.py TestIndexedBatchAPI's streams, encoded
    by the port (they equal JAX's, tests/test_torch_roundtrip.py) and by
    JAX, with the JAX package's decode."""
    rng = np.random.default_rng(123)
    datas = [
        rng.choice([0] * 7 + [40, 90], 60_000).astype(np.uint8).tobytes(),
        bytes(200_000),
        rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
        b"small",
        b"",
    ]
    streams, index = jax_compress_batch(datas, with_index=8)
    return datas, streams, index, JD.decompress_batch_indexed(streams, index)


def _fallbacks() -> int:
    return profiling.counts().get("indexed.fallback", 0)


def test_decompress_batch_indexed(batch):
    datas, streams, index, want = batch
    from fdeflate_tpu_torch import compress_batch_ultra_fast

    pstreams, pindex = compress_batch_ultra_fast(datas, with_index=8,
                                                 device="cpu")
    assert pstreams == streams and np.array_equal(pindex, index)
    before = _fallbacks()
    got = PD.decompress_batch_indexed(streams, index, device="cpu")
    assert got == want == datas
    assert _fallbacks() == before


def _jax_error(fn):
    try:
        fn()
    except JE.DecompressionError as e:
        return type(e).__name__
    return None


@pytest.fixture(scope="module")
def small_batch():
    """A few short indexed streams for the error cases (a rejected stream
    is decoded again by ``decompress_batch``, whose plain K4 costs ~0.6 ms
    a record on the CPU)."""
    rng = np.random.default_rng(9)
    datas = [b"small", bytes(5000),
             rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()]
    streams, index = jax_compress_batch(datas, with_index=8)
    return datas, streams, index


def _port_error(fn):
    try:
        fn()
    except PE.DecompressionError as e:
        return type(e).__name__
    return None


def test_decompress_batch_indexed_errors(small_batch):
    datas, streams, index = small_batch
    assert PD.decompress_batch_indexed(streams, index, device="cpu") == datas
    s = streams[2]
    cases = {
        # the stream decodes, its Adler-32 does not match
        "flipped checksum": (s[:-4] + bytes(b ^ 0xFF for b in s[-4:]), 0),
        # the last lanes find no bits and no EOB: rejected, decoded by
        # decompress_batch instead, which raises its error class
        "truncated": (s[: len(s) // 2] + s[-4:], 1),
        # the EOB is overwritten: no lane reaches it
        "end zeroed": (s[:-8] + bytes(4) + s[-4:], 1),
    }
    for label, (bad_s, fallbacks) in cases.items():
        bad = streams[:2] + [bad_s]
        want = _jax_error(lambda: JD.decompress_batch_indexed(bad, index))
        before = _fallbacks()
        got = _port_error(
            lambda: PD.decompress_batch_indexed(bad, index, device="cpu"))
        assert got == want and got is not None, (label, got, want)
        assert _fallbacks() == before + fallbacks, label
    assert _jax_error(lambda: JD.decompress_batch_indexed(
        streams[:2] + [cases["flipped checksum"][0]], index)) == "WrongChecksum"


def _flat_lists(recs):
    """Records [K, B] in numpy as ``materialize_flat``'s flat lists, built
    independently of the port's front: every record with literals or a
    length, in (row, step) order, its start after the window."""
    rl, rlh, rc, rn, rd = (np.asarray(_np(x)).astype(np.int64) for x in recs)
    adv = rc + rn
    start = JI.WINDOW + np.cumsum(adv, axis=0) - adv
    step, row = np.nonzero((rc > 0) | (adv > 0))
    order = np.lexsort((step, row))
    step, row = step[order], row[order]
    return [torch.from_numpy(a) for a in (
        row, start[step, row], rl[step, row], rlh[step, row], rc[step, row],
        rn[step, row], rd[step, row])]


@pytest.mark.parametrize("kind", ["two literals", "eight literals"])
def test_materialize_flat_and_front_equal_jax(chains, kind):
    """K4-style records of two literals (random, with dist-1 spans, copies
    that overlap and reach into the window) and K11's records of eight
    (the indexed lanes: every match a dist-1 span) after a random window;
    the last row holds two rows' records one after the other (the others
    padded with empty records), and ``out_capacity`` is the next multiple
    of 4 above the other rows' bytes, so the last row's second half starts
    past it."""
    if kind == "two literals":
        recs = _records(21, 4, 300, True)
    else:
        recs = tuple(np.asarray(_np(x))[:, 8:14] for x in
                     _jax_records(chains)[:5])
    recs = tuple(np.concatenate([x, np.zeros_like(x)]) for x in recs)
    K = recs[0].shape[0] // 2
    for x in recs:
        x[K:, -1] = x[:K, -2]
    adv = recs[2].astype(np.int64) + recs[3]
    produced = adv.sum(axis=0).astype(np.int32)
    cap = 4 * (int(produced[:-1].max()) // 4 + 1)
    starts = np.cumsum(adv[:, -1]) - adv[:, -1]
    assert (starts[adv[:, -1] > 0] >= cap).sum() > 2, produced
    B = recs[0].shape[1]
    window = np.random.default_rng(6).integers(0, 256, (B, JI.WINDOW),
                                               dtype=np.uint8)
    want = JI.materialize(tuple(jnp.asarray(x) for x in recs),
                          jnp.asarray(window), jnp.asarray(produced),
                          out_capacity=cap)
    win_t, prod_t = torch.from_numpy(window), torch.from_numpy(produced)
    got = materialize(tuple(torch.from_numpy(x.astype(np.int64))
                            for x in recs), win_t, prod_t, cap)
    _equal(got, want, f"materialize, {kind}")
    flat = materialize_flat(*_flat_lists(recs), win_t, prod_t, cap)
    _equal(flat, want, f"materialize_flat, {kind}")


def _poison(records, steps):
    """K11's live form as the card leaves it: every slot at or past a
    lane's step count holds garbage (positive counts, lengths, distances
    and positions: any of them read would change the output)."""
    past = (torch.arange(records[0].shape[0])[:, None]
            >= steps[None, :].to(torch.int64))
    return tuple(torch.where(past, torch.full_like(r, 0x5A if r.dtype ==
                                                   torch.int8 else 0x5A5A5A5A),
                             r) for r in records)


def test_indexed_materialize_live_form(indexed, chains):
    """The indexed lanes' live records (rows past ``steps`` garbage) give
    JAX's ``indexed_materialize`` of the full records."""
    recs = _jax_records(chains)
    status = np.asarray(chains[4][1][2])
    starts = np.asarray(indexed["kw"]["bit_pos"])
    want = JD.indexed_materialize(tuple(recs), jnp.asarray(status),
                                  jnp.asarray(starts), C, out_capacity=N)
    got_recs, (_b, _o, got_status), steps = DS._decode_symbols_live(
        **indexed["kw"], chain=4)
    assert torch.equal(steps, (torch.from_numpy(_np(recs[5])) >= 0).sum(
        0, dtype=torch.int32))
    live = _poison(got_recs, steps)
    got = PD.indexed_materialize(live, got_status, None, C, N, steps=steps)
    _equal(got, want, "indexed_materialize, live form")


def _poisoned_live(*args, **kwargs):
    records, state, steps = _LIVE(*args, **kwargs)
    return _poison(records, steps), state, steps


_LIVE = DS._decode_symbols_live


@pytest.mark.parametrize("case", ["clean", "flipped checksum", "truncated",
                                  "end zeroed"])
def test_indexed_live_form_on_error_streams(small_batch, monkeypatch, case):
    """``indexed_decode_step`` and ``decompress_batch_indexed`` on the live
    form with garbage past each lane's steps: JAX's (out, produced, ok) on
    the staged streams, its bytes or error class, and the fallback counted
    where the stream is rejected."""
    datas, streams, index = small_batch
    s = streams[2]
    bad, fallbacks = {
        "clean": (s, 0),
        "flipped checksum": (s[:-4] + bytes(b ^ 0xFF for b in s[-4:]), 0),
        "truncated": (s[: len(s) // 2] + s[-4:], 1),
        "end zeroed": (s[:-8] + bytes(4) + s[-4:], 1),
    }[case]
    batch = streams[:2] + [bad]
    monkeypatch.setattr(DS, "_decode_symbols_live", _poisoned_live)
    words, total_bits, chunk_starts, cap = PD.stage_indexed(batch, index,
                                                            "cpu")
    steps = max(2048, cap // index.shape[1])
    want = jax.jit(JD.indexed_decode_step(index.shape[1], steps, cap))(
        jnp.asarray(words.numpy().view(np.uint32)),
        jnp.asarray(total_bits.numpy()), jnp.asarray(chunk_starts.numpy()))
    got = PD.indexed_decode_step(index.shape[1], steps, cap)(
        words, total_bits, chunk_starts)
    _equal(got, want, case)
    assert bool(np.asarray(want[2])[2]) == (fallbacks == 0), case
    before = _fallbacks()
    got_err = _port_error(
        lambda: PD.decompress_batch_indexed(batch, index, device="cpu"))
    want_err = _jax_error(lambda: JD.decompress_batch_indexed(batch, index))
    assert got_err == want_err, (case, got_err, want_err)
    assert (got_err is None) == (case == "clean"), case
    assert _fallbacks() == before + fallbacks, case

