"""Fast-mode streams read without their chunk index, on the CPU.

``compress_batch_ultra_fast`` writes each stream as one dynamic block
(BFINAL on its first header).  A stream of 49,152 bytes or more goes from
``decompress_batch`` to block discovery, whose lane at bit 16 runs out of
record slots (``DONE_SLOTS``) long before the block's EOB: discovery
leaves the stream by ``discovery.fallback.budget``, and the sequential
path decodes all of it, one K4 launch a round (``sequential.lanes``
counts each launch's lanes).  A chain that breaks anywhere else still
counts ``chain``.

The plain K4 takes one loop iteration per record, so the fast stream is
kept near the threshold: 34,000 bytes the trained tree codes in 12 bits
each, ~17,000 records, decoded once for the module (~15 s).
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest

from fdeflate_tpu_torch import compress_batch_ultra_fast
from fdeflate_tpu_torch.ops import inflate as PI
from fdeflate_tpu_torch.ops.inflate_records import (
    DONE_BAD_DIST,
    DONE_EOB,
    DONE_SLOTS,
    DONE_TRUNCATED,
)
from fdeflate_tpu_torch.parallel import discovery as PD
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.utils import profiling

STEPS = 256   # max_steps: 1024 record slots a discovery lane and a round


def _delta(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in profiling.counts().items()
            if n != before.get(k, 0)}


def _fallbacks(n: dict) -> dict:
    return {k: v for k, v in n.items() if k.startswith("discovery.fallback.")}


def _split(data: bytes, step: int, flush=zlib.Z_BLOCK) -> bytes:
    """zlib-6 stream whose blocks end every ``step`` input bytes."""
    co = zlib.compressobj(6)
    cuts = range(0, len(data), step)
    out = b"".join(co.compress(data[i: i + step])
                   + (co.flush(flush) if i + step < len(data) else b"")
                   for i in cuts)
    return out + co.flush()


@pytest.fixture(scope="module")
def fast():
    """One fast-mode stream over the threshold through ``decompress_batch``:
    (image, stream, answers, the counters' rise, each sequential launch's
    lanes, seen at K4's call in ``ops/inflate``)."""
    rng = np.random.default_rng(27)
    image = rng.integers(64, 192, 34000).astype(np.uint8).tobytes()
    stream = compress_batch_ultra_fast([image], device="cpu")[0]
    lanes: list[int] = []
    launch = PI.inflate_records

    def counted(words, start, *rest):
        lanes.append(int(start.numel()))
        return launch(words, start, *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PI, "inflate_records", counted)
        before = profiling.counts()
        got = PD.decompress_batch([stream], max_steps=STEPS, device="cpu")
        n = _delta(before)
    return image, stream, got, n, lanes


def test_a_single_block_fast_stream_over_the_threshold_equals_zlib(fast):
    image, stream, got, _n, _lanes = fast
    assert len(stream) >= PD._PARALLEL_MIN
    assert stream[2] & 7 == 0b101   # BFINAL 1, BTYPE 2: the only block
    assert got == [zlib.decompress(stream)] == [image]


def test_discovery_leaves_it_by_budget_and_the_sequential_path_takes_it(fast):
    _image, _stream, _got, n, lanes = fast
    assert n["discovery.streams"] == n["discovery.lanes"] == 1
    assert _fallbacks(n) == {"discovery.fallback.budget": 1}
    assert "discovery.fallback.chain" not in n
    assert n["sequential.streams"] == n["sequential.blocks.dynamic"] == 1
    # ~17,000 records in rounds of 1024, the window on the device between.
    assert n["sequential.launches"] == len(lanes) >= 16
    assert n["sequential.window_host"] == 1


def test_sequential_lanes_is_the_sum_of_each_launchs_lanes(fast):
    *_, n, lanes = fast
    assert n["sequential.lanes"] == sum(lanes) == len(lanes)


def test_sequential_lanes_counts_a_batch_whose_lanes_end_apart(monkeypatch):
    """Three streams of 1, 2 and 4 blocks at 16 record slots a launch: the
    launches lose lanes as the streams end."""
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 8, 600 * k).astype(np.uint8).tobytes()
              for k in (1, 2, 4)]
    streams = [_split(im, 600) for im in images]
    lanes: list[int] = []
    launch = PI.inflate_records

    def counted(words, start, *rest):
        lanes.append(int(start.numel()))
        return launch(words, start, *rest)

    monkeypatch.setattr(PI, "inflate_records", counted)
    before = profiling.counts()
    assert PI.decompress_sequential(streams, max_steps=4,
                                    device="cpu") == images
    n = _delta(before)
    assert n["sequential.launches"] == len(lanes)
    assert n["sequential.lanes"] == sum(lanes)
    assert set(lanes) == {1, 2, 3}


def test_a_zlib6_multi_block_corpus_stream_counts_no_budget():
    """The corpus at zlib 6, a block every 4 KiB: each block fits its lane,
    the chain is whole, and discovery leaves nothing."""
    image = make_idat_corpus(1, 160 << 10, 0)[0].tobytes()
    stream = _split(image, 4096)
    assert len(stream) >= PD._PARALLEL_MIN
    before = profiling.counts()
    assert PD.decompress_batch([stream], max_steps=1024,
                               device="cpu") == [image]
    n = _delta(before)
    assert n["discovery.lanes_chained"] == 40
    assert _fallbacks(n) == {}
    assert "sequential.streams" not in n


def _chain_breaks(kind: str) -> bytes:
    data = np.random.default_rng(1).integers(0, 8, 2000).astype(
        np.uint8).tobytes()
    if kind == "no_lane":    # an empty stored block after the first block
        return _split(data, 1000, zlib.Z_SYNC_FLUSH)
    stream = _split(data, 1000)
    return stream[:-12]      # the last lane runs off the stream's end


@pytest.mark.parametrize("kind", ["no_lane", "truncated"])
def test_a_chain_that_breaks_elsewhere_still_counts_chain(kind):
    stream = _chain_breaks(kind)
    before = profiling.counts()
    assert PD.try_foreign(stream, max_steps=STEPS, device="cpu") is None
    assert _fallbacks(_delta(before)) == {"discovery.fallback.chain": 1}


# (offset, stream bit where the walk stopped, K4 exit of each lane, dropped)
_LANES = [(16, False, 100), (900, False, 1000), (2000, True, 2100)]


@pytest.mark.parametrize("cur, done, dropped, reason", [
    (16, [DONE_SLOTS, DONE_EOB, DONE_EOB], set(), "budget"),
    (900, [DONE_EOB, DONE_SLOTS, DONE_EOB], set(), "budget"),
    (900, [DONE_EOB, DONE_TRUNCATED, DONE_EOB], set(), "chain"),
    (2000, [DONE_EOB, DONE_EOB, DONE_BAD_DIST], set(), "chain"),
    (1500, [DONE_EOB, DONE_EOB, DONE_SLOTS], set(), "chain"),
    (1500, [DONE_EOB, DONE_EOB, DONE_SLOTS], {1500}, "tables"),
], ids=["first", "second", "truncated", "bad", "no_lane", "dropped"])
def test_the_broken_reason_names_where_the_walk_stopped(cur, done, dropped,
                                                        reason):
    assert PD._broken_reason(_LANES, 0, 3, np.array(done), cur,
                             dropped) == reason
