"""The port's ``adler32_pallas`` (K7's plain version + the int64 fold)
against the JAX ``adler32_pallas`` (its Pallas tile kernel in interpret
mode) and ``zlib.adler32``, at tests/test_adler32.py's sizes, masked
lengths included.  Checksums are integers: every comparison is exact.
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdeflate_tpu.ops import adler32_pallas as J
import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.adler32_pallas import (
    TILE,
    adler32_tiles,
    adler32_tiles_plain,
)
from fdeflate_tpu_torch.utils import profiling


def _launches(name: str) -> int:
    return profiling.counts().get("launch." + name, 0)


def _bytes(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("n", [1, 7, 1023, 1024, 4097, 65533, 65536, 65537,
                               200001])
def test_matches_jax_and_zlib(n):
    data = _bytes(n, n)
    got = P.adler32_pallas(torch.from_numpy(data))
    assert got.dtype == torch.int64 and got.dim() == 0
    want = int(np.asarray(J.adler32_pallas(jnp.asarray(data))))
    assert int(got) == want == zlib.adler32(data.tobytes())


@pytest.mark.parametrize("n,length", [(5000, 3001), (2048, 1024), (1024, 0),
                                      ((1 << 16) * 3 + 4096,
                                       (1 << 16) * 2 + 100)])
def test_length_masks_a_padded_buffer(n, length):
    data = _bytes(n, length)
    got = P.adler32_pallas(torch.from_numpy(data), length)
    want = int(np.asarray(J.adler32_pallas(jnp.asarray(data),
                                           jnp.int32(length))))
    assert int(got) == want == zlib.adler32(data[:length].tobytes())
    as_tensor = P.adler32_pallas(torch.from_numpy(data), torch.tensor(length))
    assert int(as_tensor) == want


def test_no_split_equals_the_chunked_reference(monkeypatch):
    """JAX folds int32 tile sums, so it splits inputs above CHUNK_BYTES and
    joins the pieces; the port's int64 fold needs no split and gives the
    same checksum."""
    monkeypatch.setattr(J, "CHUNK_BYTES", 1 << 16)
    data = _bytes(200001, 3)
    want = int(np.asarray(J.adler32_pallas(jnp.asarray(data),
                                           jnp.int32(190000))))
    assert int(P.adler32_pallas(torch.from_numpy(data), 190000)) == want


def test_empty_buffer():
    assert int(P.adler32_pallas(torch.zeros(0, dtype=torch.uint8))) == 1


@pytest.mark.parametrize("n,length", [(3000, 3000), (3000, 1500), (4096, 9)])
def test_tile_sums_are_the_per_tile_sums(n, length):
    data = _bytes(n, 5)
    ln = torch.tensor([length])
    sums, wsums = adler32_tiles_plain(torch.from_numpy(data), ln)
    d = np.zeros(-(-n // TILE) * TILE, np.int64)
    d[:length] = data[:length]
    d = d.reshape(-1, TILE)
    np.testing.assert_array_equal(sums.numpy(), d.sum(1))
    np.testing.assert_array_equal(wsums.numpy(),
                                  (d * (TILE - np.arange(TILE))).sum(1))
    before = _launches("adler32_tiles")
    got = adler32_tiles(torch.from_numpy(data), ln)
    assert torch.equal(got[0], sums) and torch.equal(got[1], wsums)
    assert _launches("adler32_tiles") == before
