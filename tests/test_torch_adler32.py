"""Port Adler-32 (fdeflate_tpu_torch.ops.adler32) against the JAX package.

Checksums are integers: every comparison is exact.
"""

from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdeflate_tpu.ops.adler32 import adler32_jax
from fdeflate_tpu.ops.pallas_decode2 import adler_step_major
from fdeflate_tpu_torch.ops.adler32 import adler32_batch, adler_lanes


def _batch(seed: int, B: int, N: int):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (B, N), dtype=np.uint8)
    data[rng.random((B, N)) < 0.4] = 0
    lengths = rng.integers(0, N + 1, B).astype(np.int32)
    lengths[0] = N
    return data, lengths


@pytest.mark.parametrize("seed,B,N", [(0, 3, 4096), (1, 5, 10000), (2, 2, 64)])
def test_adler32_batch_matches_jax_and_zlib(seed, B, N):
    data, lengths = _batch(seed, B, N)
    for b in range(B):
        data[b, lengths[b]:] = 0
    got = adler32_batch(torch.from_numpy(data), torch.from_numpy(lengths))
    want = np.asarray(jax.vmap(adler32_jax)(jnp.asarray(data),
                                            jnp.asarray(lengths)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for b in range(B):
        assert int(got[b]) == zlib.adler32(data[b, : lengths[b]].tobytes())


def _step_major(out: np.ndarray, C: int) -> np.ndarray:
    """u8[B, N] bytes -> the TPU kernel's i32[LB, T, 8, 128] output."""
    B, N = out.shape
    T = N // C // 4
    L = B * C
    LB = -(-L // 1024)
    rows = np.zeros((LB * 1024, T), np.int32)
    rows[:L] = out.reshape(L, T * 4).view(np.int32)
    return rows.reshape(LB, 8, 128, T).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("seed,B,C,S", [(3, 3, 8, 256), (4, 2, 4, 2048),
                                        (5, 4, 16, 64)])
def test_adler_lanes_matches_adler_step_major(seed, B, C, S):
    """Bytes past ``length`` are NOT masked: garbage there must give the
    same (wrong) checksum as the JAX fold, so corrupted decodes get the
    same verdict in both."""
    data, lengths = _batch(seed, B, C * S)
    got = adler_lanes(torch.from_numpy(data), torch.from_numpy(lengths), C)
    want = np.asarray(adler_step_major(jnp.asarray(_step_major(data, C)),
                                       B, C, S, jnp.asarray(lengths)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_adler_lanes_is_adler32_when_tail_is_zero():
    data, lengths = _batch(6, 3, 2048)
    for b in range(3):
        data[b, lengths[b]:] = 0
    got = adler_lanes(torch.from_numpy(data), torch.from_numpy(lengths), 8)
    for b in range(3):
        assert int(got[b]) == zlib.adler32(data[b, : lengths[b]].tobytes())


@pytest.mark.parametrize("seed,N", [(7, 5000), (8, 2049), (9, 1023),
                                    (10, 7 * 1024 + 1), (11, 1)])
def test_k7_plain_batch_matches_jax_and_zlib(seed, N):
    """K7's plain version over a batch (``adler32_tiles_plain`` per row,
    then ``fold_tiles``; what ``adler32_checksums`` returns for CPU
    tensors) and ``adler32_batch``'s plain body, on ragged lengths 0, 1,
    1023, 1025 and N with N not a multiple of 1024 and noise past each
    length, against JAX ``ultrafast_kernel.adler32_batch``, ``adler32_jax``
    per row and zlib.adler32; the tile sums against their definition."""
    from fdeflate_tpu.ops.ultrafast_kernel import adler32_batch as jax_batch
    from fdeflate_tpu_torch.ops.adler32 import adler32_batch_plain
    from fdeflate_tpu_torch.ops.adler32_pallas import (TILE,
                                                       adler32_checksums,
                                                       adler32_tiles_plain,
                                                       fold_tiles)

    rng = np.random.default_rng(seed)
    lens = [x for x in (0, 1, 1023, 1025, N) if x <= N]
    lens += list(rng.integers(0, N + 1, 2))
    data = rng.integers(0, 256, (len(lens), N), dtype=np.uint8)
    lengths = np.asarray(lens, np.int32)
    d, ln = torch.from_numpy(data), torch.from_numpy(lengths)
    sums, wsums = adler32_tiles_plain(d, ln)
    T = -(-N // TILE)
    pad = np.zeros((len(lens), T * TILE), np.int64)
    for b, n in enumerate(lens):
        pad[b, :n] = data[b, :n]
    pad = pad.reshape(len(lens), T, TILE)
    np.testing.assert_array_equal(sums.numpy(), pad.sum(2))
    np.testing.assert_array_equal(
        wsums.numpy(), (pad * (TILE - np.arange(TILE))).sum(2))
    got = fold_tiles(sums, wsums, ln)
    assert torch.equal(got, adler32_checksums(d, ln))
    assert torch.equal(got, adler32_batch_plain(d, ln))
    assert torch.equal(got, adler32_batch(d, ln))
    want = np.asarray(jax_batch(jnp.asarray(data), jnp.asarray(lengths)))
    np.testing.assert_array_equal(got.numpy(),
                                  want.astype(np.int64) & 0xFFFFFFFF)
    for b, n in enumerate(lens):
        row = int(np.asarray(adler32_jax(jnp.asarray(data[b]), jnp.int32(n))))
        assert int(got[b]) == row & 0xFFFFFFFF == zlib.adler32(
            data[b, :n].tobytes())
