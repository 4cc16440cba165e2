"""The port's matched encoder, whole: ``compress_batch_matched`` and
``compress_batch_device`` against the JAX package's bytes and zlib.

JAX's ``compress_batch_matched(streams, depth=4, min_match=4)`` (level 1's
configuration; it compiles its three stages, ~30 s on the CPU) runs once,
in a module fixture, on the five stream shapes of the JAX package's
``TestMatchscan._streams``; the port must give its bytes for every stream.
Levels 2 and 3 differ from level 1 only in the probe depth, which
tests/test_torch_matchscan.py holds to JAX stage by stage at depths 8 and
16; here they are held to ``compress_batch_matched`` at their
``DEVICE_LEVELS`` and to zlib.  Every port stream is decoded twice: by
``zlib.decompress`` and by the port's own ``decompress_batch``.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

from fdeflate_tpu.ops import matchscan as J
from fdeflate_tpu_torch import decompress_batch
from fdeflate_tpu_torch.ops import matchscan as P


def _streams():
    rng = np.random.default_rng(0)
    idat = np.where(
        rng.integers(0, 4, 8000) > 0, rng.integers(-8, 8, 8000), 0
    ).astype(np.uint8).tobytes()
    words = [b"the", b"quick", b"brown", b"fox"]
    text = b" ".join(words[i] for i in rng.integers(0, 4, 2000))
    low = ((rng.integers(0, 16, 8000, dtype=np.uint8) * 2) - 16).astype(
        np.uint8
    ).tobytes()
    pat = np.tile(rng.integers(1, 256, 100, dtype=np.uint8), 50).tobytes()
    rand = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    return [idat, text, low, pat, rand]


STREAMS = _streams()
NAMES = ["idat", "text", "low", "pattern", "random"]
TINY = [b"", b"x", b"ab" * 6, bytes(24)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops on these ~40k-element batches split over every core
    by default; under the suite's parallel workers that oversubscribes
    the host many times over.  One thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_level1():
    return J.compress_batch_matched(STREAMS, depth=4, min_match=4)


@pytest.fixture(scope="module")
def port_levels():
    """The port's streams at levels 1-3 (``compress_batch_device``)."""
    return {lvl: P.compress_batch_device(STREAMS, lvl, device="cpu")
            for lvl in (1, 2, 3)}


@pytest.fixture(scope="module")
def port_level1():
    return P.compress_batch_matched(STREAMS, depth=4, min_match=4,
                                    device="cpu")


@pytest.mark.parametrize("i", range(len(STREAMS)), ids=NAMES)
def test_matched_equals_jax(jax_level1, port_level1, i):
    assert port_level1[i] == jax_level1[i]
    assert zlib.decompress(port_level1[i]) == STREAMS[i]


def test_matched_positional_call_form(port_levels):
    """JAX's positional form (streams, depth, min_match, backext, passes)."""
    assert P.compress_batch_matched(STREAMS, 4, 4, True, 2,
                                    device="cpu") == port_levels[1]


@pytest.mark.parametrize("level", [1, 2, 3])
def test_device_level_is_its_matched_configuration(port_levels, level):
    want = P.compress_batch_matched(STREAMS, **P.DEVICE_LEVELS[level],
                                    device="cpu")
    assert port_levels[level] == want


@pytest.mark.parametrize("level", [1, 2, 3])
def test_device_levels_roundtrip(port_levels, level):
    out = port_levels[level]
    assert [zlib.decompress(o) for o in out] == STREAMS
    assert decompress_batch(out, device="cpu") == STREAMS


def test_deeper_levels_are_no_larger_in_sum(port_levels):
    sizes = {lvl: sum(map(len, out)) for lvl, out in port_levels.items()}
    assert sizes[3] <= sizes[2] <= sizes[1], sizes


@pytest.mark.parametrize("level", [-1, 0, 4, 5, 9])
def test_levels_map_as_jax(monkeypatch, port_levels, level):
    """JAX's ``max(1, min(level, 3))``: the same configuration in both
    packages (JAX's map read through a stub of its encoder), and the
    port's bytes of the level it maps to."""
    seen = {}
    monkeypatch.setattr(J, "compress_batch_matched",
                        lambda streams, **kw: seen.setdefault("jax", kw))
    J.compress_batch_device(STREAMS[:1], level)
    real = P.compress_batch_matched

    def port_matched(streams, **kw):
        seen["port"] = kw
        return real(streams, **kw)

    monkeypatch.setattr(P, "compress_batch_matched", port_matched)
    out = P.compress_batch_device(STREAMS, level, device="cpu")
    port_kw = dict(seen["port"])
    assert port_kw.pop("device") == "cpu"
    assert port_kw == seen["jax"]
    assert out == port_levels[max(1, min(level, 3))]


@pytest.mark.parametrize("data", TINY, ids=["empty", "1B", "12B", "24B"])
def test_empty_and_tiny_roundtrip(data):
    """JAX's own tiny-stream test is ``slow``; on the port, alone and in a
    batch with a full-size stream.  The empty stream's one-symbol
    literal/length code is left to the next test."""
    alone = P.compress_batch_matched([data], device="cpu")[0]
    assert zlib.decompress(alone) == data
    if data:
        assert decompress_batch([alone], device="cpu") == [data]
    batch = P.compress_batch_device([STREAMS[0], data], 1, device="cpu")
    assert [zlib.decompress(o) for o in batch] == [STREAMS[0], data]
    assert decompress_batch(batch[:1], device="cpu") == STREAMS[:1]


def test_empty_stream_decodes_as_in_jax():
    """The encoder gives an empty stream a literal/length code of one 1-bit
    symbol (EOB).  zlib takes that incomplete code; the decoders of both
    packages, after the reference's, refuse it with the same error class
    (a defect of the JAX package that the port keeps, ROADMAP Queue 3)."""
    from fdeflate_tpu.ops.inflate import decompress_batch as jax_decompress

    out = P.compress_batch_matched([b""], device="cpu")
    assert zlib.decompress(out[0]) == b""
    got = decompress_batch(out, device="cpu")[0]
    want = jax_decompress(out)[0]
    assert type(got).__name__ == type(want).__name__ == "BadCodeLengthHuffmanTree"


def test_single_pass_and_no_backext_roundtrip():
    for kw in (dict(passes=0), dict(passes=1), dict(backext=False)):
        out = P.compress_batch_matched(STREAMS, depth=2, **kw, device="cpu")
        assert [zlib.decompress(o) for o in out] == STREAMS, kw
