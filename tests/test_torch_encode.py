"""Port encode (K1 + K2 plain versions, framing, Adler-32) against JAX.

The JAX reference is ``encode_ultrafast_batch(..., fixed_geometry=True,
return_eof=True)`` on the CPU, which takes the XLA token path.  Outputs are
compared exactly: words up to ``ceil(total_bits / 32)`` (zero past it),
``total_bits``, ``adler``, ``chunk_starts`` and ``eof_pos``; every stream
must also ``zlib.decompress`` back to its input.  The cases are those of
tests/test_pallas_assign.py plus empty and incompressible rows.
"""

from __future__ import annotations

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdeflate_tpu as F
from fdeflate_tpu.ops import ultrafast_kernel as UK
from fdeflate_tpu_torch import compress_batch_ultra_fast, finalize_streams
from fdeflate_tpu_torch.ops.assign_pack import assign_pack, wwin
from fdeflate_tpu_torch.ops.ultrafast import encode_ultrafast_batch
from fdeflate_tpu_torch.trees import trained_tables


@functools.lru_cache(maxsize=None)
def _jax_encoder(C: int):
    return jax.jit(functools.partial(
        UK.encode_ultrafast_batch, num_chunks=C, fixed_geometry=True,
        return_eof=True))


def _mixed_zeros_small_chunks():
    rng = np.random.default_rng(2)
    d = rng.integers(0, 256, (2, 1024)).astype(np.uint8)
    d[rng.random((2, 1024)) < 0.5] = 0
    return d, np.full(2, 1024, np.int32), 4


def _long_runs_and_no_zeros():
    rng = np.random.default_rng(3)
    d = np.zeros((2, 2048), np.uint8)
    d[0, 100] = 7
    d[0, 700] = 9
    d[1] = rng.integers(1, 256, 2048)
    return d, np.full(2, 2048, np.int32), 4


def _tails_1_to_6_and_258_boundaries():
    rng = np.random.default_rng(4)
    d = np.zeros((2, 2048), np.uint8)
    d[0, :] = rng.integers(1, 256, 2048)
    for k, tail in enumerate([1, 2, 3, 4, 5, 6]):
        s = 60 * k + 16
        d[0, s : s + tail + 1] = 0
    d[1, :] = rng.integers(1, 256, 2048)
    d[1, 500:1100] = 0
    d[1, 1100:1103] = 0
    return d, np.full(2, 2048, np.int32), 4


def _exact_258_multiples():
    d = np.ones((1, 2048), np.uint8)
    d[0, 100 : 100 + 259] = 0    # run1 = 258: k=1, tail=0
    d[0, 600 : 600 + 517] = 0    # run1 = 516: k=2, tail=0
    d[0, 1400 : 1400 + 263] = 0  # tail=4
    return d, np.full(1, 2048, np.int32), 4


def _ragged_lengths_with_empty():
    rng = np.random.default_rng(5)
    d = rng.integers(0, 256, (4, 2048)).astype(np.uint8)
    d[rng.random((4, 2048)) < 0.6] = 0
    lengths = np.array([2048, 1037, 264, 0], np.int32)
    for b in range(4):
        d[b, lengths[b]:] = 0
    return d, lengths, 4


def _runs_across_lane_boundaries():
    rng = np.random.default_rng(6)
    d = np.zeros((2, 2048), np.uint8)
    d[1, :] = rng.integers(1, 256, 2048)
    for e in (254, 255, 256, 257, 510, 511, 512):
        d[1, e] = 0
    d[1, 248:258] = 0
    d[1, 1530:1560] = 0   # crosses the S=512 boundary at 1536
    d[0, 1000:1030] = 7
    return d, np.full(2, 2048, np.int32), 4


def _density_sweep():
    rng = np.random.default_rng(12)
    B, N = 8, 2048
    d = np.zeros((B, N), np.uint8)
    for i, dens in enumerate([0.0, 0.3, 0.5, 0.8, 0.95, 0.99, 1.0, 0.9]):
        row = rng.integers(1, 256, N).astype(np.uint8)
        row[rng.random(N) < dens] = 0
        d[i] = row
    lengths = np.full(B, N, np.int32)
    lengths[3] = 1544
    lengths[6] = 777
    for b in range(B):
        d[b, lengths[b]:] = 0
    return d, lengths, 8


def _incompressible():
    rng = np.random.default_rng(13)
    d = rng.integers(0, 256, (2, 4096), dtype=np.uint8)
    return d, np.full(2, 4096, np.int32), 16


CASES = {
    "mixed_zeros_small_chunks": _mixed_zeros_small_chunks,
    "long_runs_and_no_zeros": _long_runs_and_no_zeros,
    "tails_1_to_6_and_258_boundaries": _tails_1_to_6_and_258_boundaries,
    "exact_258_multiples": _exact_258_multiples,
    "ragged_lengths_with_empty": _ragged_lengths_with_empty,
    "runs_across_lane_boundaries": _runs_across_lane_boundaries,
    "density_sweep": _density_sweep,
    "incompressible": _incompressible,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_matches_jax(case):
    data, lengths, C = CASES[case]()
    ref = [np.asarray(x) for x in
           _jax_encoder(C)(jnp.asarray(data), jnp.asarray(lengths))]
    got = encode_ultrafast_batch(torch.from_numpy(data),
                                 torch.from_numpy(lengths), C)
    words, total_bits, adler, starts, eof = (x.numpy() for x in got)

    words = words.view(np.uint32)
    for b in range(data.shape[0]):
        nw = -(-int(total_bits[b]) // 32)
        np.testing.assert_array_equal(words[b, :nw], ref[0][b, :nw])
        assert not words[b, nw:].any()
    np.testing.assert_array_equal(total_bits, ref[1])
    np.testing.assert_array_equal(adler, ref[2].astype(np.int64))
    np.testing.assert_array_equal(starts, ref[3])
    np.testing.assert_array_equal(eof, ref[4])

    for b, s in enumerate(finalize_streams(*got[:3])):
        assert zlib.decompress(s) == data[b, : lengths[b]].tobytes(), b


@pytest.mark.parametrize("case", ["density_sweep", "ragged_lengths_with_empty"])
def test_windows_hold_each_lane_alone(case):
    """K1's window of lane k holds exactly the lane's bits of the stream,
    from bit 0, zeros past ``chunk_bits``."""
    data, lengths, C = CASES[case]()
    B, N = data.shape
    t = trained_tables()
    win, bits = assign_pack(torch.from_numpy(data), torch.from_numpy(lengths),
                            C, t)
    words, _tb, _ad, starts, eof = encode_ultrafast_batch(
        torch.from_numpy(data), torch.from_numpy(lengths), C)
    assert win.shape == (B * C, wwin(N // C))
    ends = torch.cat([starts[:, 1:], eof[:, None]], dim=1)
    np.testing.assert_array_equal(bits.numpy(), (ends - starts).reshape(-1))
    stream = np.unpackbits(words.numpy().view(np.uint8), axis=1,
                           bitorder="little")
    lanes = np.unpackbits(win.numpy().view(np.uint8), axis=1,
                          bitorder="little")
    for lane in range(B * C):
        b, k = divmod(lane, C)
        s, n = int(starts[b, k]), int(bits[lane])
        np.testing.assert_array_equal(lanes[lane, :n], stream[b, s : s + n])
        assert not lanes[lane, n:].any()


def test_compress_batch_single_chunk_matches_jax_and_host():
    rng = np.random.default_rng(21)
    streams = [rng.integers(0, 4, n, dtype=np.uint8).tobytes()
               for n in (0, 9, 1000, 3001)]
    streams.append(bytes(777))
    got = compress_batch_ultra_fast(streams, device="cpu")
    ref = UK.compress_batch_ultra_fast(streams)
    assert got == ref
    assert got == [F.compress_to_vec_ultra_fast(s) for s in streams]


def _index_streams(seed: int, sizes):
    rng = np.random.default_rng(seed)
    return [np.where(rng.random(n) < 0.5, 0,
                     rng.integers(0, 256, n)).astype(np.uint8).tobytes()
            for n in sizes]


def _assert_batch_matches_jax(streams, C: int):
    got, index = compress_batch_ultra_fast(streams, with_index=C, device="cpu")
    ref_streams, ref_index = UK.compress_batch_ultra_fast(streams, with_index=C)
    assert got == ref_streams
    np.testing.assert_array_equal(index, ref_index)
    assert index.shape == (len(streams), C)
    assert [zlib.decompress(s) for s in got] == streams


def test_compress_batch_with_index_roundtrips():
    _assert_batch_matches_jax(_index_streams(22, (5000, 123, 4096)), 4)


def _index_case(name):
    if name == "runs_over_sample_points":
        # Long zero runs and 258-splits straddle the N // C sample bytes.
        d = np.ones(6000, np.uint8)
        d[700:1900] = 0
        d[2990:3010] = 0
        d[4497:4503] = 0
        return [d.tobytes(), bytes(3000), b"", d[:1501].tobytes()], 4
    if name == "c_not_dividing_n":
        return _index_streams(23, (999, 2000, 37)), 7
    if name == "run_tails_at_sample_points":
        # A 12-byte zero run at every offset before sample byte 1500: some
        # sample bytes land on a run tail's extra-bits token.
        rows = []
        for start in range(1480, 1501):
            d = np.ones(6000, np.uint8)
            d[start:start + 12] = 0
            rows.append(d.tobytes())
        return rows, 4
    return _index_streams(24, (64, 10, 64)), 16     # many chunks, short rows


@pytest.mark.parametrize("name", ["runs_over_sample_points", "c_not_dividing_n",
                                  "many_chunks", "run_tails_at_sample_points"])
def test_compress_batch_index_matches_jax(name):
    """``with_index`` gives the JAX package's streams and symbol index."""
    _assert_batch_matches_jax(*_index_case(name))
