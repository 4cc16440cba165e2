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
