"""The port's spans and counters (``utils/profiling``) and where the
inflate path opens and counts them, on the CPU.

A span outside a profile is the shared null context; inside one it is a
``record_function`` on the profiler's timeline.  Block discovery opens its
stage spans in order and counts streams, lanes, the headers it drops for
their trees and each stream it leaves, by reason; ``_build.launch`` counts
launches.  Streams stay small: the plain K4 takes one loop iteration per
record.
"""

from __future__ import annotations

import functools
import json
import sys
import threading
import zlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fdeflate_tpu_torch import _build, compress_batch_ultra_fast
from fdeflate_tpu_torch.ops import header_tables as HT
from fdeflate_tpu_torch.ops import inflate as PI
from fdeflate_tpu_torch.parallel import device_pipeline as DP
from fdeflate_tpu_torch.parallel import discovery as PD
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.utils import profiling

STEPS = 256   # max_steps: 1024 record slots, enough for 1000-byte blocks


def _corpus(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return np.where(rng.integers(0, 4, n) > 0, rng.integers(-8, 8, n),
                    0).astype(np.uint8).tobytes()


def _split(data: bytes, step: int, flush=zlib.Z_BLOCK) -> bytes:
    """zlib-6 stream whose blocks end every ``step`` input bytes."""
    co = zlib.compressobj(6)
    cuts = range(0, len(data), step)
    out = b"".join(co.compress(data[i: i + step])
                   + (co.flush(flush) if i + step < len(data) else b"")
                   for i in cuts)
    return out + co.flush()


DATA = _corpus(2000, 1)
GOOD = _split(DATA, 1000)
OTHER = _split(_corpus(1500, 2), 500)
THIRD = _split(_corpus(1500, 5), 500)
BAD = {
    "header": (b"\x00\x01" + GOOD[2:], None),
    "first_block": (zlib.compress(DATA, 0), DATA),
    "tables": (THIRD, None),   # with ``block_tables`` failing (see below)
    "chain": (_split(DATA, 1000, zlib.Z_SYNC_FLUSH), DATA),
    "checksum": (GOOD[:-4] + bytes(4), None),
}
FALSE_HEADER = 1302677   # a false header of image 20 (``_image20``)


@functools.lru_cache(maxsize=1)
def _image20() -> bytes:
    """bench.py's image 20 at zlib 6.  K5 takes the bits at FALSE_HEADER
    for a complete dynamic header (a code 16 after a zero run repeats the
    last plain length there); the host's parse repeats 0, as RFC 1951
    does, and reads a literal/length code whose Kraft sum is 0.961."""
    return zlib.compress(make_idat_corpus(21, 1 << 20, 0)[20], 6)


def _with_false_header(stream: bytes) -> bytes:
    """``stream`` with image 20's false header copied after its trailer,
    where no chain goes (zlib ignores what follows the trailer)."""
    return stream + _image20()[FALSE_HEADER // 8:][:120]


def _refuse(monkeypatch, stream: bytes, which=slice(None)) -> None:
    """Make the table build fail for ``stream``'s headers ``which`` alone
    (K5 refuses incomplete trees, so no small stream reaches the failure by
    itself: this stands for a header K5 let through).  The plain K12
    builds each header's tables through ``HT.block_tables``."""
    lanes = PD._parse_lanes(
        stream, PD.find_block_boundaries(stream, device="cpu")[0])[0]
    refused = {lane[3].tobytes() for lane in lanes[which]}
    build = HT.block_tables

    def incomplete(lengths, hlit):
        if lengths.tobytes() in refused:
            raise ValueError("tree must be exactly complete")
        return build(lengths, hlit)

    monkeypatch.setattr(HT, "block_tables", incomplete)


def _delta(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in profiling.counts().items()
            if n != before.get(k, 0)}


@pytest.fixture
def opened(monkeypatch):
    """The names of the spans discovery and the sequential path open, in
    order (``span`` replaced in both modules)."""
    names: list[str] = []

    def span(name):
        names.append(name)
        return profiling._NULL

    monkeypatch.setattr(PD, "span", span)
    monkeypatch.setattr(PI, "span", span)
    return names


# -- the module ------------------------------------------------------------

def test_span_off_is_the_shared_null_context(monkeypatch):
    def fail(name):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", fail)
    assert not torch.autograd._profiler_enabled()
    before = profiling.span_seconds()
    with profiling.span("a") as s:
        assert s is None
    assert profiling.span("b") is profiling.span("c") is profiling._NULL
    assert profiling.span_seconds() == before


def test_span_under_trace_nests_in_its_parent(tmp_path):
    before = profiling.span_seconds()
    with profiling.trace(str(tmp_path)):
        with profiling.span("test.outer"):
            with profiling.span("test.inner"):
                torch.arange(100).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    iv = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
          if e.get("name", "").startswith("test.")}
    assert iv["test.outer"][0] <= iv["test.inner"][0]
    assert iv["test.inner"][1] <= iv["test.outer"][1]
    after = profiling.span_seconds()
    grew = {k: after[k] - before.get(k, 0.0) for k in ("test.outer",
                                                         "test.inner")}
    assert 0 < grew["test.inner"] <= grew["test.outer"]


def test_counts_returns_a_copy():
    profiling.count("test.copy")
    got = profiling.counts()
    got["test.copy"] += 100
    got["test.other"] = 1
    assert profiling.counts()["test.copy"] == got["test.copy"] - 100
    assert "test.other" not in profiling.counts()
    assert profiling.span_seconds() is not profiling.span_seconds()


def test_count_loses_no_update_across_threads():
    before = profiling.counts().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            profiling.count("test.threads", 2) for _ in range(2000)])
            for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counts()["test.threads"] - before == 16 * 2000 * 2


def test_launch_counts_each_launch_of_a_kernel(monkeypatch):
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 7 if args[0] == "fail" else 0

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 0,
                        raising=False)
    before = profiling.counts()
    dev = torch.device("cuda", 0)
    _build.launch("inflate_records", dev, "ok")
    _build.launch("inflate_records", dev, "ok")
    _build.launch("validate_headers", dev, "ok")
    with pytest.raises(RuntimeError, match="cudaError_t 7"):
        _build.launch("combine", dev, "fail")
    assert _delta(before) == {"launch.inflate_records": 2,
                              "launch.validate_headers": 1}


# -- the inflate path ------------------------------------------------------

# ``discovery.tables`` twice: the lanes' rows taken (``lane_layout``), then
# their per-lane inputs uploaded (``lane_inputs``).
STAGES = ["discovery.stage1", "discovery.validate", "discovery.parse",
          "discovery.tables", "discovery.tables", "discovery.records",
          "discovery.chain", "discovery.stitch"]


def test_try_foreign_counts_and_opens_the_stages_in_order(opened):
    before = profiling.counts()
    assert PD.try_foreign(GOOD, max_steps=STEPS, device="cpu") == DATA
    assert opened == STAGES
    got = _delta(before)
    assert got["discovery.streams"] == 1
    assert got["discovery.lanes"] >= got["discovery.lanes_chained"] == 2
    assert not any(k.startswith("discovery.fallback") for k in got)


def test_try_foreign_batch_counts_and_opens_the_stages_in_order(opened):
    before = profiling.counts()
    got = PD.try_foreign_batch([GOOD, OTHER], max_steps=STEPS, device="cpu")
    assert got == [DATA, zlib.decompress(OTHER)]
    assert opened == ["discovery.stage1"] * 2 + STAGES[1:]
    n = _delta(before)
    assert n["discovery.streams"] == 2
    assert n["discovery.lanes"] >= n["discovery.lanes_chained"] == 2 + 3
    assert not any(k.startswith("discovery.fallback") for k in n)


@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("reason", list(BAD))
def test_a_stream_discovery_leaves_counts_its_reason(reason, batch,
                                                    monkeypatch):
    stream, _ = BAD[reason]
    if reason == "tables":
        _refuse(monkeypatch, stream)
    before = profiling.counts()
    if batch:
        got = PD.try_foreign_batch([GOOD, stream], max_steps=STEPS,
                                   device="cpu")
        # A stream's incomplete trees cost that stream alone.
        assert got == [DATA, None]
    else:
        assert PD.try_foreign(stream, max_steps=STEPS, device="cpu") is None
    n = _delta(before)
    assert n["discovery.streams"] == 1 + batch
    assert {k: v for k, v in n.items()
            if k.startswith("discovery.fallback.")} == {
        f"discovery.fallback.{reason}": 1}


@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch"])
def test_a_chain_that_needs_a_dropped_header_leaves_by_tables(batch,
                                                              monkeypatch):
    _refuse(monkeypatch, THIRD, slice(1, 2))   # its second block's header
    before = profiling.counts()
    if batch:
        got = PD.try_foreign_batch([GOOD, THIRD, OTHER], max_steps=STEPS,
                                   device="cpu")
        assert got == [DATA, None, zlib.decompress(OTHER)]
    else:
        assert PD.try_foreign(THIRD, max_steps=STEPS, device="cpu") is None
    n = _delta(before)
    assert n["discovery.lanes_dropped"] == 1
    assert {k: v for k, v in n.items()
            if k.startswith("discovery.fallback.")} == {
        "discovery.fallback.tables": 1}


@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch"])
def test_a_header_off_the_chain_whose_trees_fail_is_dropped(batch):
    stream = _with_false_header(GOOD)
    before = profiling.counts()
    if batch:
        got = PD.try_foreign_batch([stream, OTHER], max_steps=STEPS,
                                   device="cpu")
        assert got == [DATA, zlib.decompress(OTHER)]
    else:
        assert PD.try_foreign(stream, max_steps=STEPS, device="cpu") == DATA
    n = _delta(before)
    assert n["discovery.lanes_dropped"] == 1
    assert n["discovery.lanes_chained"] == 2 + 3 * batch
    assert not any(k.startswith("discovery.fallback") for k in n)


@pytest.mark.parametrize("name", ["confirmed", "first_block", "chain",
                                  "checksum"])
def test_one_stream_takes_the_batch_pipeline(name, monkeypatch):
    """``try_foreign`` is the batch pipeline (``_discover``) on one stream:
    the stream twice in a batch gives each copy its result, and every
    discovery counter rises twice as much."""
    stream = GOOD if name == "confirmed" else BAD[name][0]
    sizes = []
    discover = PD._discover
    monkeypatch.setattr(PD, "_discover", lambda streams, *a: (
        sizes.append(len(streams)) or discover(streams, *a)))

    def discovery_counts(before):
        return {k: n for k, n in _delta(before).items()
                if k.startswith("discovery.")}

    before = profiling.counts()
    one = PD.try_foreign(stream, max_steps=STEPS, device="cpu")
    n_one = discovery_counts(before)
    before = profiling.counts()
    two = PD.try_foreign_batch([stream, stream], max_steps=STEPS,
                               device="cpu")
    n_two = discovery_counts(before)
    assert sizes == [1, 2]
    assert one == (DATA if name == "confirmed" else None)
    assert two == [one, one]
    assert n_one["discovery.streams"] == 1
    assert n_two == {k: 2 * n for k, n in n_one.items()}


def test_discovery_builds_each_headers_tables_once(monkeypatch):
    built = []
    build = HT.block_tables

    def counted(lengths, hlit):
        built.append(hlit)
        return build(lengths, hlit)

    monkeypatch.setattr(HT, "block_tables", counted)
    before = profiling.counts()
    got = PD.try_foreign_batch([_with_false_header(GOOD), OTHER],
                               max_steps=STEPS, device="cpu")
    assert got == [DATA, zlib.decompress(OTHER)]
    n = _delta(before)
    assert len(built) == n["discovery.lanes"] + n["discovery.lanes_dropped"]
    assert n["discovery.headers"] == len(built)   # none skipped here


def test_parse_lanes_drops_image20s_false_header():
    z = _image20()
    offsets = np.array([16, FALSE_HEADER])
    good, _ends = PD.validate_stage2_device(z, offsets, device="cpu")
    assert good.tolist() == [16, FALSE_HEADER]   # K5 takes both
    before = profiling.counts()
    lanes, tables, dropped = PD._parse_lanes(z, offsets)
    assert [lane[0] for lane in lanes] == [16] and len(tables) == 1
    assert dropped == {FALSE_HEADER}
    assert _delta(before) == {}   # the plain helper counts nothing
    # K12's plain version drops it too, under the same contract.
    words = PD.stage_words(z, device="cpu")
    info, _meta, _tab = HT.header_tables(
        words, torch.from_numpy(offsets), torch.full((2,), words.numel()),
        torch.full((2,), len(z) * 8))
    assert info[0].tolist() == [HT.LANE, HT.DROPPED]


def test_decompress_batch_leaves_streams_to_the_sequential_span(
        opened, monkeypatch):
    monkeypatch.setattr(PD, "_PARALLEL_MIN", 0)
    tiny = zlib.compress(b"hello world" * 3, 6)
    stored, raw = BAD["first_block"]
    before = profiling.counts()
    got = PD.decompress_batch([tiny, stored, GOOD], max_steps=STEPS,
                              device="cpu")
    assert got == [b"hello world" * 3, raw, DATA]
    seq = opened.index("inflate.sequential")
    assert opened[0] == "inflate.batch" and "discovery.stitch" in opened[:seq]
    assert opened[seq + 1:] and all(n.startswith("sequential.")
                                    for n in opened[seq + 1:])
    n = _delta(before)
    assert n["inflate.calls"] == 1 and n["discovery.streams"] == 3
    assert n["discovery.fallback.first_block"] == 2


def test_the_sequential_span_nests_in_the_batch_span(tmp_path):
    tiny = zlib.compress(b"hello world" * 3, 6)
    with profiling.trace(str(tmp_path)):
        assert PD.decompress_batch([tiny], device="cpu") == [b"hello world" * 3]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    iv = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
          if e.get("name") in ("inflate.batch", "inflate.sequential")}
    assert iv["inflate.batch"][0] <= iv["inflate.sequential"][0]
    assert iv["inflate.sequential"][1] <= iv["inflate.batch"][1]


# -- the sequential path ---------------------------------------------------

SEQ_RAW = _corpus(300, 9)


def _fixed(data: bytes) -> bytes:
    co = zlib.compressobj(6, strategy=zlib.Z_FIXED)
    return co.compress(data) + co.flush()


def _seq_batch():
    """GOOD (two dynamic blocks), one fixed block, one stored block: the
    first launch takes GOOD's first block and the fixed one, the second
    GOOD's second; the host copies the 300 stored bytes."""
    batch = [GOOD, _fixed(SEQ_RAW), zlib.compress(SEQ_RAW, 0)]
    # BFINAL and BTYPE of each first block: dynamic, fixed final, stored final.
    assert [z[2] & 7 for z in batch] == [0b100, 0b011, 0b001]
    return batch, [DATA, SEQ_RAW, SEQ_RAW]


SEQ_ROUND = ["sequential.parse", "sequential.records",
             "sequential.materialize"]


def test_the_sequential_stages_open_in_order(opened):
    """The streams' framing parsed, then per launch its tables, K4, the
    bytes; after a launch in which a stream reached its EOB, its next
    header."""
    batch, want = _seq_batch()
    assert PI.decompress_sequential(batch, max_steps=STEPS,
                                    device="cpu") == want
    assert opened == ["inflate.sequential", "sequential.parse",
                      *SEQ_ROUND, "sequential.parse",
                      *SEQ_ROUND, "sequential.parse"]


def test_the_sequential_counters_rise_by_blocks_launches_and_stored_bytes():
    """GOOD's two dynamic headers both parsed by K12, none by the host; the
    first launch takes GOOD's and the fixed block's lanes, the second
    GOOD's alone."""
    batch, want = _seq_batch()
    before = profiling.counts()
    assert PI.decompress_sequential(batch, max_steps=STEPS,
                                    device="cpu") == want
    assert {k: v for k, v in _delta(before).items()
            if k.startswith("sequential.")} == {
        "sequential.streams": 3, "sequential.launches": 2,
        "sequential.lanes": 3,
        "sequential.blocks.dynamic": 2, "sequential.blocks.fixed": 1,
        "sequential.headers.device": 2,
        "sequential.stored_bytes": 300, "sequential.window_host": 2}


def test_windows_stay_on_the_device_while_no_stream_leaves_its_block(opened):
    """16 record slots a launch: a block takes many launches, each counted
    once per block; the windows go through the host only for the first
    launch and after each of the two launches in which a block ended."""
    batch, want = _seq_batch()
    before = profiling.counts()
    assert PI.decompress_sequential(batch[:2], max_steps=4,
                                    device="cpu") == want[:2]
    n = _delta(before)
    assert n["sequential.blocks.dynamic"] == 2
    assert n["sequential.blocks.fixed"] == 1
    assert n["sequential.window_host"] == 3
    assert n["sequential.launches"] > 20
    assert "sequential.stored_bytes" not in n
    assert opened.count("sequential.records") == n["sequential.launches"]


def test_the_sequential_stage_spans_lie_in_its_span_apart(tmp_path):
    batch, want = _seq_batch()
    with profiling.trace(str(tmp_path)):
        assert PD.decompress_batch(batch, max_steps=STEPS,
                                   device="cpu") == want
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    iv = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                if e.get("ph") == "X" and e.get("name") in (
                    "inflate.sequential", *SEQ_ROUND))
    (lo, hi, outer), stages = iv[0], iv[1:]
    assert outer == "inflate.sequential"
    assert [n for _s, _t, n in stages] == [
        "sequential.parse", *SEQ_ROUND, "sequential.parse", *SEQ_ROUND,
        "sequential.parse"]
    assert all(lo <= s and t <= hi for s, t, _n in stages)
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))


def test_sequential_spans_and_counts_change_no_output_and_no_tensor_work():
    batch, want = _seq_batch()
    runs = []
    for traced in (False, True):
        with _Ops() as mode:
            if traced:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]):
                    got = PI.decompress_sequential(batch, max_steps=STEPS,
                                                   device="cpu")
            else:
                got = PI.decompress_sequential(batch, max_steps=STEPS,
                                               device="cpu")
        assert got == want
        runs.append(mode.names)
    assert runs[0] == runs[1] and runs[0]


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not str(func).startswith("profiler."):
            self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_spans_and_counts_add_no_tensor_work():
    """The same torch operations (so no copy to the host and no wait) run
    with the spans on, under a profile, and off."""
    small = _split(_corpus(600, 3), 300)
    runs = []
    for traced in (False, True):
        with _Ops() as mode:
            if traced:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]):
                    got = PD.try_foreign(small, max_steps=STEPS, device="cpu")
            else:
                got = PD.try_foreign(small, max_steps=STEPS, device="cpu")
        assert got == zlib.decompress(small)
        runs.append(mode.names)
    assert runs[0] == runs[1] and runs[0]


# -- the indexed decode ----------------------------------------------------

INDEXED = ["indexed.batch", "indexed.stage", "indexed.decode",
           "indexed.readback", "indexed.verify"]


@functools.lru_cache(maxsize=1)
def _indexed_batch():
    """A 1 KiB image, whose chunks past its last symbol start hold no
    lane, and 16 KiB of zeros, whose output outgrows the first capacity
    (sized from the image's stream, the longer): one regrowth."""
    datas = [make_idat_corpus(1, 1 << 10, 2)[0].tobytes(), bytes(1 << 14)]
    streams, index = compress_batch_ultra_fast(datas, with_index=8,
                                               device="cpu")
    return datas, streams, index


def test_decompress_batch_indexed_opens_its_spans_in_order(monkeypatch):
    names: list[str] = []

    def span(name):
        names.append(name)
        return profiling._NULL

    monkeypatch.setattr(DP, "span", span)
    datas, streams, index = _indexed_batch()
    assert DP.decompress_batch_indexed(streams, index, device="cpu") == datas
    assert names == INDEXED


def test_the_indexed_stage_spans_lie_in_the_batch_span_apart(tmp_path):
    datas, streams, index = _indexed_batch()
    with profiling.trace(str(tmp_path)):
        got = DP.decompress_batch_indexed(streams, index, device="cpu")
    assert got == datas
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    iv = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
          if e.get("name") in INDEXED and e.get("ph") == "X"]
    assert sorted(n for _s, _t, n in iv) == sorted(INDEXED)
    iv.sort()
    (lo, hi, outer), stages = iv[0], iv[1:]
    assert outer == "indexed.batch"
    assert [n for _s, _t, n in stages] == INDEXED[1:]
    assert all(lo <= s and t <= hi for s, t, _n in stages)
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))


def test_decompress_batch_indexed_counts_calls_streams_lanes_regrowths():
    datas, streams, index = _indexed_batch()
    words, total_bits, chunk_starts, _cap = DP.stage_indexed(streams, index,
                                                             "cpu")
    active = int(DP.chunk_lanes(total_bits, chunk_starts)[4].sum())
    assert active < index.size   # the image's last chunks hold no lane
    before = profiling.counts()
    assert DP.decompress_batch_indexed(streams, index, device="cpu") == datas
    assert {k: v for k, v in _delta(before).items()
            if k.startswith("indexed.")} == {
        "indexed.calls": 1, "indexed.streams": 2, "indexed.lanes": active,
        "indexed.regrow": 1}


def test_indexed_spans_and_counts_change_no_output_and_no_tensor_work():
    datas, streams, index = _indexed_batch()
    runs = []
    for traced in (False, True):
        with _Ops() as mode:
            if traced:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]):
                    got = DP.decompress_batch_indexed(streams, index,
                                                      device="cpu")
            else:
                got = DP.decompress_batch_indexed(streams, index, device="cpu")
        assert got == datas
        runs.append(mode.names)
    assert runs[0] == runs[1] and runs[0]
