"""Port decode (K3 plain version + checks) and the whole slice against JAX.

The JAX decode reference runs its Pallas kernel in interpret mode, about
20 s per geometry on the CPU, so it runs ONCE, in a module fixture, at one
small geometry (B=3 ragged rows plus a corrupted copy of row 0, N=2048,
C=8, U=8 as in tests/test_repack.py).  Every other case is held against the
JAX package's numpy oracles (``stage_blocked_np`` + ``decode_chunk_np``)
and the input bytes.  All outputs are integers: comparisons are exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_idat_corpus
from fdeflate_tpu.ops import ultrafast_kernel as UK
from fdeflate_tpu.ops.pallas_decode2 import decode_chunk_np
from fdeflate_tpu.ops.repack import stage_blocked_np, stage_wwin
from fdeflate_tpu.parallel import device_pipeline as JDP
from fdeflate_tpu_torch import fused_zlib_roundtrip, zlib_decode_step
from fdeflate_tpu_torch.ops.decode2 import decode2
from fdeflate_tpu_torch.ops.ultrafast import encode_fixed
from fdeflate_tpu_torch.trees import trained_tables

B, N, C = 3, 2048, 8
S = N // C
LENGTHS = np.array([N, N - 700, 9], np.int32)


def _corpus(rng, B, N):   # tests/test_repack.py's corpus
    data = np.where(
        rng.integers(0, 5, (B, N)) > 0, rng.integers(-8, 8, (B, N)), 0
    ).astype(np.uint8)
    data[0, : N // 3] = 0
    data[1] = rng.integers(0, 256, N, dtype=np.uint8)
    return data


@functools.lru_cache(maxsize=None)
def _jax_encoder(C: int):
    return jax.jit(functools.partial(
        UK.encode_ultrafast_batch, num_chunks=C, fixed_geometry=True,
        return_eof=True))


def _corrupt(words: np.ndarray, starts: np.ndarray, b: int) -> np.ndarray:
    """A copy of stream b with one payload word flipped (inside lane 1)."""
    row = words[b].copy()
    row[(int(starts[b, 1]) >> 5) + 3] ^= np.uint32(0x00F0F0F0)
    return row


@pytest.fixture(scope="module")
def ref():
    data = _corpus(np.random.default_rng(42), B, N)
    for b in range(B):
        data[b, LENGTHS[b]:] = 0
    words, tb, adler, starts, eof = (
        np.asarray(x) for x in _jax_encoder(C)(jnp.asarray(data),
                                               jnp.asarray(LENGTHS)))
    # Row 3: row 0 with a flipped payload word, same index and checksum.
    words4 = np.concatenate([words, _corrupt(words, starts, 0)[None]])
    starts4 = np.concatenate([starts, starts[:1]])
    eof4 = np.concatenate([eof, eof[:1]])
    adler4 = np.concatenate([adler, adler[:1]])
    len4 = np.concatenate([LENGTHS, LENGTHS[:1]])
    step = JDP.zlib_decode_step(C, N, stage_wwin(S), U=8)
    out_sm, bpos_ok, ck_ok = step(jnp.asarray(words4), jnp.asarray(starts4),
                                  jnp.asarray(eof4), jnp.asarray(adler4),
                                  jnp.asarray(len4))
    out = np.asarray(out_sm)                 # [LB, T, 8, 128], as in
    LB = out.shape[0]                        # tests/test_repack.py:124-127
    by = out.transpose(0, 2, 3, 1).reshape(LB * 1024, S // 4)
    by = by[: 4 * C].reshape(4, N // 4).view(np.uint8)[:, :N]
    return dict(data=data, words=words4, starts=starts4, eof=eof4,
                adler=adler4, lengths=len4, out=by,
                bpos_ok=np.asarray(bpos_ok), ck_ok=np.asarray(ck_ok))


def _port_decode(r):
    t = torch.from_numpy
    step = zlib_decode_step(C, N)
    out, bpos_ok, ck_ok = step(t(r["words"].view(np.int32)), t(r["starts"]),
                               t(r["eof"]), t(r["adler"].astype(np.int64)),
                               t(r["lengths"]))
    return out.numpy(), bpos_ok.numpy(), ck_ok.numpy()


def test_decoded_bytes_match_jax(ref):
    out, _, _ = _port_decode(ref)
    np.testing.assert_array_equal(out[:B], ref["out"][:B])
    np.testing.assert_array_equal(out[:B], ref["data"])


def test_flags_match_jax_and_corruption_is_caught(ref):
    _, bpos_ok, ck_ok = _port_decode(ref)
    np.testing.assert_array_equal(bpos_ok, ref["bpos_ok"])
    np.testing.assert_array_equal(ck_ok, ref["ck_ok"])
    assert bpos_ok[:B].all() and ck_ok[:B].all()
    assert not (bpos_ok[B] and ck_ok[B])     # the flipped word is caught


def test_fused_roundtrip_matches_jax(ref):
    step = fused_zlib_roundtrip(C, N, device="cpu")
    out, bpos_ok, ck_ok = step(ref["data"], LENGTHS)
    np.testing.assert_array_equal(out.numpy(), ref["out"][:B])
    np.testing.assert_array_equal(bpos_ok.numpy(), ref["bpos_ok"][:B])
    np.testing.assert_array_equal(ck_ok.numpy(), ref["ck_ok"][:B])


def _oracle_lane_bits(words, starts, C, S):
    """Exit bit of every lane by the numpy oracle (full lanes only)."""
    Bn = words.shape[0]
    win = stage_blocked_np(words, starts, C, stage_wwin(S))
    bits = np.zeros((Bn, C), np.int64)
    for lane in range(Bn * C):
        b, k = divmod(lane, C)
        lb, r = divmod(lane, 1024)
        _, bits[b, k] = decode_chunk_np(win[lb, :, r // 128, r % 128], S)
    return bits


def _idat(B, N):
    data = make_idat_corpus(B, N, seed=7)
    data[-1] = np.random.default_rng(7).integers(0, 256, N)
    return data


DECODE_CASES = {
    "repack_corpus_C8": (lambda: _corpus(np.random.default_rng(1), 3, 2048), 8),
    "idat_C4": (lambda: _idat(3, 4096), 4),
    "idat_C32": (lambda: _idat(2, 8192), 32),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_matches_numpy_oracle(case):
    make, C_ = DECODE_CASES[case]
    data = make()
    Bn, Nn = data.shape
    S_ = Nn // C_
    lengths = np.full(Bn, Nn, np.int32)
    words, _tb, _ad, starts, _eof = encode_fixed(
        torch.from_numpy(data), torch.from_numpy(lengths), C_)
    out, bp = decode2(words, starts, trained_tables().dtab, Nn, C_)
    np.testing.assert_array_equal(out.numpy(), data)
    want = _oracle_lane_bits(words.numpy().view(np.uint32), starts.numpy(),
                             C_, S_)
    np.testing.assert_array_equal(bp.numpy(), want)


def test_ragged_and_empty_lanes_stall_with_zeros():
    data = _idat(3, 4096)
    lengths = np.array([4096, 1500, 0], np.int32)
    for b in range(3):
        data[b, lengths[b]:] = 0
    words, _tb, adler, starts, eof = encode_fixed(
        torch.from_numpy(data), torch.from_numpy(lengths), 4)
    out, bp = decode2(words, starts, trained_tables().dtab, 4096, 4)
    np.testing.assert_array_equal(out.numpy(), data)
    # Lanes past a stream's end start at its EOF token and stall there.
    assert bp[1, 2:].eq(0).all() and bp[2].eq(0).all()
    assert (starts[2] == eof[2]).all()


@pytest.mark.parametrize("lane", [0, 3])
def test_flipped_word_is_caught(lane):
    data = _idat(2, 4096)
    lengths = np.full(2, 4096, np.int32)
    words, _tb, adler, starts, eof = encode_fixed(
        torch.from_numpy(data), torch.from_numpy(lengths), 4)
    words = words.clone()
    words[0, (int(starts[0, lane]) >> 5) + 2] ^= 0x0F0F0F0F
    _out, bpos_ok, ck_ok = zlib_decode_step(4, 4096)(
        words, starts, eof, adler, torch.from_numpy(lengths))
    assert not (bool(bpos_ok[0]) and bool(ck_ok[0]))
    assert bool(bpos_ok[1]) and bool(ck_ok[1])
