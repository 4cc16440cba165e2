"""Thumbnails of the benchmark's RGB kind held to the plain reference, on
the CPU: seeded 8-bit RGB images with real PNG rows
(``portbench/thumbnails.make_rgb_thumbnails``: each row's filter type
first, the filter chosen per row) compressed by Python's zlib and decoded
by ``decompress_batch``, against ``portbench/reference.inflate``.  Every
stream is under block discovery's threshold, so the sequential path
decodes them all.  Images stay small (32 x 32) but one, at the published
128 x 128: the plain K4 takes one loop iteration per record.
"""

from __future__ import annotations

import zlib

import pytest

from fdeflate_tpu_torch.parallel import discovery as PD
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


def test_dynamic_fixed_and_stored_streams_in_one_batch():
    """Every block kind of the sequential path in one call: dynamic (level
    6), fixed (``Z_FIXED``) and stored (level 0) thumbnails, and a stored
    block between two compressed ones."""
    images = _thumbs(4, 32, 11)
    fixed = zlib.compressobj(6, strategy=zlib.Z_FIXED)
    mixed = zlib.compressobj(6)
    half = len(images[3]) // 2
    streams = [
        zlib.compress(images[0], 6),
        fixed.compress(images[1]) + fixed.flush(),
        zlib.compress(images[2], 0),
        (mixed.compress(images[3][:half]) + mixed.flush(zlib.Z_FULL_FLUSH)
         + mixed.compress(images[3][half:]) + mixed.flush()),
    ]
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
