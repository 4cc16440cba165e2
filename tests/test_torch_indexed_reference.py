"""The indexed decode held to the plain reference, on the CPU: images of
the benchmark's kind (``portbench/corpus.make_idat_corpus``: 8-bit gray,
Sub-filtered, 1024-px rows) encoded by ``compress_batch_ultra_fast(with_index=C)``
and read back by ``decompress_batch_indexed``, against Python's zlib on
the same streams and against the images.  Streams stay small (4 x 16 KiB
at C = 8): the plain K11 steps every lane once per symbol.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest

from fdeflate_tpu_torch import compress_batch_ultra_fast
from fdeflate_tpu_torch.errors import WrongChecksum
from fdeflate_tpu_torch.parallel import device_pipeline as PD
from fdeflate_tpu_torch.utils import profiling
from portbench.corpus import make_idat_corpus

B, N, C = 4, 1 << 14, 8


def _fallbacks() -> int:
    return profiling.counts().get("indexed.fallback", 0)


def _encode(seed: int):
    images = [im.tobytes() for im in make_idat_corpus(B, N, seed)]
    streams, index = compress_batch_ultra_fast(images, with_index=C,
                                               device="cpu")
    return images, streams, index


@pytest.mark.parametrize("seed", [0, 7])
def test_indexed_decode_gives_zlibs_bytes_and_the_image(seed):
    images, streams, index = _encode(seed)
    assert index.shape == (B, C)
    before = _fallbacks()
    got = PD.decompress_batch_indexed(streams, index, device="cpu")
    assert got == [zlib.decompress(s) for s in streams] == images
    assert _fallbacks() == before


def test_a_stream_with_a_lost_index_falls_back_to_zlibs_bytes():
    """An index whose entries all lie at the stream's end decodes no lane:
    the stream leaves the index, is counted, and ``decompress_batch``
    gives zlib's bytes."""
    image = make_idat_corpus(1, 1 << 12, 3)[0].tobytes()
    streams, index = compress_batch_ultra_fast([image], with_index=C,
                                               device="cpu")
    lost = np.full_like(index, (len(streams[0]) - 4) * 8)
    before = _fallbacks()
    got = PD.decompress_batch_indexed(streams, lost, device="cpu")
    assert got == [zlib.decompress(streams[0])] == [image]
    assert _fallbacks() == before + 1


def test_another_streams_index_never_gives_wrong_bytes():
    """Another stream's index row starts lanes inside symbols.  The decode
    either rejects the stream, which then falls back (counted) to zlib's
    bytes, or takes it and the host's Adler-32 refuses its bytes
    (``WrongChecksum``, nothing counted): no wrong bytes come back.  The
    lanes' exits are not held to the next entry (as in the JAX package),
    so on these images every row is taken and refused by the checksum."""
    images, streams, index = _encode(0)
    for i in range(B):
        before = _fallbacks()
        try:
            got = PD.decompress_batch_indexed(
                [streams[i]], index[[(i + 1) % B]], device="cpu")
        except WrongChecksum:
            assert _fallbacks() == before
            continue
        assert got == [zlib.decompress(streams[i])] == [images[i]]
        assert _fallbacks() == before + 1
