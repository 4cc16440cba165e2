"""Thumbnails of the benchmark's RGB kind held to the plain reference, on
the CPU: seeded 8-bit RGB images with real PNG rows
(``portbench/thumbnails.make_rgb_thumbnails``: each row's filter type
first, the filter chosen per row) compressed by Python's zlib and decoded
by ``decompress_batch``, against ``portbench/reference.inflate``.  Every
stream is under block discovery's threshold, so the sequential path
decodes them all.  Images stay small (32 x 32) but one, at the published
128 x 128: the plain K4 takes one loop iteration per record.

The sequential path parses its dynamic headers with K12; a header K12 does
not make a lane of, or whose trees the host's rule refuses, ends its stream
with the host parse's error class: thumbnails beside streams with crafted
bad headers (``edges.bad_header_streams``) give the answers of the JAX
package's sequential path.
"""

from __future__ import annotations

import zlib

import pytest

from fdeflate_tpu.ops import inflate as JI
from fdeflate_tpu_torch.ops import header_tables as HT
from fdeflate_tpu_torch.ops import inflate as PI
from fdeflate_tpu_torch.parallel import discovery as PD
from fdeflate_tpu_torch.tools.edges import bad_header_streams
from fdeflate_tpu_torch.utils import profiling
from portbench import reference as R
from portbench.thumbnails import make_rgb_thumbnails


def _thumbs(n: int, px: int, seed: int) -> list[bytes]:
    return [r.tobytes() for r in make_rgb_thumbnails(n, px, px, seed)]


def _decode(streams: list[bytes]) -> tuple[list, dict]:
    """``decompress_batch`` on the CPU, and the counters' rise."""
    before = profiling.counts()
    got = PD.decompress_batch(streams, device="cpu")
    after = profiling.counts()
    return got, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


@pytest.mark.parametrize("seed", [0, 7])
def test_small_thumbnails_give_the_references_bytes(seed):
    images = _thumbs(4, 32, seed)
    streams = [zlib.compress(im, 6) for im in images]
    got, n = _decode(streams)
    assert got == [R.inflate(z) for z in streams] == images
    assert "discovery.streams" not in n
    assert n["sequential.streams"] == 4
    assert n["sequential.blocks.dynamic"] >= 4


def test_a_published_size_thumbnail_gives_the_references_bytes():
    """128 x 128: 49,280 bytes of rows, two dynamic blocks at level 6, the
    second reaching back into the first across a launch."""
    image = _thumbs(1, 128, 3)[0]
    z = zlib.compress(image, 6)
    assert len(image) == 49280 and len(z) < PD._PARALLEL_MIN
    got, n = _decode([z])
    assert got == [R.inflate(z)] == [image]
    assert "discovery.streams" not in n
    assert n["sequential.blocks.dynamic"] == 2
    assert n["sequential.launches"] >= 2


def _every_kind(images: list[bytes]) -> list[bytes]:
    """Dynamic (level 6), fixed (``Z_FIXED``) and stored (level 0) streams
    of the first three images, and the fourth's with a stored block between
    two dynamic ones."""
    fixed = zlib.compressobj(6, strategy=zlib.Z_FIXED)
    mixed = zlib.compressobj(6)
    half = len(images[3]) // 2
    return [
        zlib.compress(images[0], 6),
        fixed.compress(images[1]) + fixed.flush(),
        zlib.compress(images[2], 0),
        (mixed.compress(images[3][:half]) + mixed.flush(zlib.Z_FULL_FLUSH)
         + mixed.compress(images[3][half:]) + mixed.flush()),
    ]


def test_dynamic_fixed_and_stored_streams_in_one_batch():
    """Every block kind of the sequential path in one call: dynamic (level
    6), fixed (``Z_FIXED``) and stored (level 0) thumbnails, and a stored
    block between two compressed ones."""
    images = _thumbs(4, 32, 11)
    streams = _every_kind(images)
    got, n = _decode(streams)
    assert got == [R.inflate(z) for z in streams] == images
    assert "discovery.streams" not in n
    assert n["sequential.blocks.dynamic"] >= 3
    assert n["sequential.blocks.fixed"] >= 1
    # The stored image, and Z_FULL_FLUSH's empty stored block.
    assert n["sequential.stored_bytes"] == len(images[2])


def test_a_truncated_thumbnail_keeps_its_error_class_beside_good_ones():
    images = _thumbs(3, 32, 2)
    streams = [zlib.compress(im, 6) for im in images]
    streams[1] = streams[1][: len(streams[1]) // 2]
    got, _n = _decode(streams)
    assert got[0] == images[0] and got[2] == images[2]
    with pytest.raises(zlib.error):
        R.inflate(streams[1])
    assert type(got[1]).__name__ == "InsufficientInput"


# -- dynamic headers on K12, the host's parse only for a bad one's class -----

def _bad_streams() -> dict[str, tuple[bytes, str]]:
    return bad_header_streams(_thumbs(1, 32, 4)[0][:400])


def _good_streams() -> dict[str, bytes]:
    names = ("dynamic", "fixed", "stored", "dynamic, stored, dynamic")
    return dict(zip(names, _every_kind(_thumbs(4, 32, 26))))


def _no_lanes(words, offs, wend, bit_end):
    """``header_tables`` as if K12 made a lane of no header."""
    info, meta, tab = HT.header_tables_plain(words, offs, wend, bit_end)
    info[0], info[3] = HT.SKIPPED, 0
    return info, meta.zero_(), tab.zero_()


def _sequential(streams):
    before = profiling.counts()
    got = PI.decompress_sequential(streams, device="cpu")
    after = profiling.counts()
    return got, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


@pytest.fixture(scope="module")
def answers():
    """A good stream beside each bad one, in one batch: the port's answers
    and counts, and the JAX package's sequential path's answers."""
    cases = {**_good_streams(),
             **{name: z for name, (z, _cls) in _bad_streams().items()}}
    streams = list(cases.values())
    port, n = _sequential(streams)
    jax = JI._decompress_batch_sequential(streams, max_steps=8192)
    return dict(zip(cases, port)), n, dict(zip(cases, jax))


@pytest.mark.parametrize("name", [*_good_streams(), *_bad_streams()])
def test_sequential_answers_equal_the_host_parse_and_jax(answers, name):
    """Each stream's bytes, or its error class, are the JAX package's
    sequential path's; a good stream's bytes are zlib's, a bad one's class
    the one the host parse raises for its header."""
    port, _n, jax = answers
    got, want = port[name], jax[name]
    if isinstance(want, bytes):
        assert got == want == zlib.decompress(_good_streams()[name])
    else:
        assert (type(got).__name__ == type(want).__name__
                == _bad_streams()[name][1])


def test_good_headers_go_to_k12_and_each_bad_one_to_the_host(answers):
    """``sequential.headers.device`` counts every good dynamic header (the
    bad streams' first blocks included), ``.host`` one a bad stream, and
    only K12's headers enter a dynamic block."""
    _port, n, _jax = answers
    assert n["sequential.headers.host"] == len(_bad_streams())
    # the good streams' 1 + 2 dynamic headers, and 6 prefixes' + 2 cut ones'
    assert n["sequential.headers.device"] == 3 + 8
    assert n["sequential.blocks.dynamic"] == n["sequential.headers.device"]


def test_a_good_header_k12_refuses_is_an_internal_error(monkeypatch):
    """The host's parse only gives a refused header its error class: a good
    header that K12 made no lane of raises, and is not decoded on the host."""
    monkeypatch.setattr(PI, "header_tables", _no_lanes)
    with pytest.raises(RuntimeError, match="K12 refused"):
        PI.decompress_sequential([_good_streams()["dynamic"]], device="cpu")
