"""The port's adaptive trees (``ops/adaptive.py``, the on-device decode
table, ``fused_adaptive_roundtrip``) against the JAX package.

The JAX reference is ``fdeflate_tpu.ops.adaptive`` on the CPU, whose
encode takes the XLA branch (words-identical to its kernel branch).  The
corpora are tests/test_adaptive.py's three; the JAX chain runs once per
corpus.  Everything is integer: comparisons are exact, the code lengths
included (they decide every stream bit).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdeflate_tpu.ops import adaptive as A
from fdeflate_tpu.ops.pallas_decode2 import _bitrev12_np
import fdeflate_tpu_torch as P
from fdeflate_tpu_torch import trees
from fdeflate_tpu_torch.ops import adaptive as PA
from fdeflate_tpu_torch.ops.decode2 import decode2_plain

B, N, C = 2, 4096, 4
S = N // C
LENGTHS = np.array([N, N - 1000], np.int32)
KINDS = ["mixed", "skewed", "uniform"]


def _corpus(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)        # tests/test_adaptive.py's
    if kind == "mixed":
        d = rng.integers(0, 255, n, np.uint8)
        d[::3] = 0
        d[n // 4 : n // 2] = 0
        return d
    if kind == "skewed":
        return (rng.zipf(1.5, n) % 64).astype(np.uint8)
    return rng.integers(0, 255, n, np.uint8)


def _data(kind: str) -> np.ndarray:
    data = np.stack([_corpus(kind, N, seed=s) for s in range(B)])
    for b in range(B):
        data[b, LENGTHS[b]:] = 0
    return data


@functools.lru_cache(maxsize=None)
def _jax(kind: str):
    data = _data(kind)
    args = (jnp.asarray(data), jnp.asarray(LENGTHS))
    win, cb, adler, lens, meta, tabp = (np.asarray(x) for x in
                                        A.encode_adaptive_blocked(
                                            *args, C, lut_matmul=False))
    freqs = np.asarray(A.symbol_freqs(*args, S, False))
    codes = np.asarray(A.canonical_codes(jnp.asarray(lens))[0])
    return dict(data=data, win=win, chunk_bits=cb, adler=adler, lens=lens,
                meta=meta, tabp=tabp, freqs=freqs, codes=codes)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", KINDS)
def test_symbol_freqs_match_jax(kind):
    ref = _jax(kind)
    got = PA.symbol_freqs(_t(ref["data"]), _t(LENGTHS), S)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref["freqs"])


@pytest.mark.parametrize("kind", KINDS)
def test_code_lengths_match_jax(kind):
    ref = _jax(kind)
    lens = PA.code_lengths_dp(_t(ref["freqs"]))
    np.testing.assert_array_equal(lens.numpy(), ref["lens"])
    assert sum(2.0 ** -int(x) for x in lens) == 1.0


def _near_integer(m: int, seed: int):
    """Frequencies whose scaled products are integers k, summing to
    m * 2^16: the float32 scale 1/m rounds, so some products land just
    above k and their ceiling is k + 1."""
    rng = np.random.default_rng(seed)
    f = rng.integers(1, 300, A.NSYM).astype(np.int64) * m
    f[0] += m * 65536 - int(f.sum())
    assert f[0] > 0
    return f.astype(np.int32)


TIE_CASES = {
    "near_integer_scale_1_7": lambda: _near_integer(7, 7),
    "near_integer_scale_1_15": lambda: _near_integer(15, 8),
    "all_equal": lambda: np.full(A.NSYM, 17, np.int32),
    "powers_of_two": lambda: (1 << (np.arange(A.NSYM) % 20)).astype(np.int32),
    "mostly_zero": lambda: np.where(np.arange(A.NSYM) % 9 == 0, 1000,
                                    0).astype(np.int32),
}


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_code_lengths_match_jax_on_ties(case):
    freqs = TIE_CASES[case]()
    want = np.asarray(A.code_lengths_dp(jnp.asarray(freqs)))
    got = PA.code_lengths_dp(torch.from_numpy(freqs))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [7, 15])
def test_near_integer_cases_round_in_float32(m):
    """The near-integer cases do exercise float32 rounding: some scaled
    products differ from their exact value's ceiling."""
    f = TIE_CASES[f"near_integer_scale_1_{m}"]()
    f32 = np.ceil(f.astype(np.float32) * (np.float32(65536.0)
                                          / np.float32(f.sum())))
    exact = np.ceil(f.astype(np.float64) * 65536.0 / float(f.sum()))
    assert (f32 != exact).any()


@pytest.mark.parametrize("kind", KINDS)
def test_canonical_codes_match_jax(kind):
    ref = _jax(kind)
    codes, first, cnt, idx = trees.canonical_codes(_t(ref["lens"]))
    want = A.canonical_codes(jnp.asarray(ref["lens"]))
    np.testing.assert_array_equal(codes.numpy(), ref["codes"])
    for got, w in zip((first, cnt, idx), want[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", KINDS)
def test_decode_meta_matches_jax(kind):
    ref = _jax(kind)
    meta, tabp = PA.decode_meta(_t(ref["lens"]))
    np.testing.assert_array_equal(meta.numpy(), ref["meta"])
    np.testing.assert_array_equal(tabp.numpy(), ref["tabp"])


@pytest.mark.parametrize("kind", KINDS)
def test_runtime_decode_table_is_the_jax_runtime_rule(kind):
    """K3's table built on the device from ``lens`` gives, for every peek,
    the entry the JAX kernel reads from its runtime (meta, tabp)."""
    ref = _jax(kind)
    dtab = trees.decode_table(_t(ref["lens"])).numpy()
    meta, tabp = ref["meta"][0], ref["tabp"][0]
    for peek in range(4096):
        r12 = _bitrev12_np(peek)
        L = 1 + sum(r12 >= meta[l] for l in range(1, 12))
        idx = meta[16 + L] + (r12 >> (12 - L))
        ent = (int(tabp[idx >> 1]) >> (16 * (idx & 1))) & 0xFFFF
        assert int(dtab[peek]) == ent | (L << 16), peek


@pytest.mark.parametrize("kind", KINDS)
def test_encode_adaptive_blocked_matches_jax(kind):
    """Lens, chunk bits, Adler-32 and each lane's window up to its payload
    equal JAX's (its blocked windows turned lane-major)."""
    ref = _jax(kind)
    win, cb, adler, lens, t = PA.encode_adaptive_blocked(
        _t(ref["data"]), _t(LENGTHS), C)
    np.testing.assert_array_equal(lens.numpy(), ref["lens"])
    np.testing.assert_array_equal(cb.numpy(), ref["chunk_bits"])
    np.testing.assert_array_equal(adler.numpy(), ref["adler"].astype(np.int64))
    jwin = ref["win"]
    lanes = np.transpose(jwin, (0, 2, 3, 1)).reshape(-1, jwin.shape[1])
    for lane in range(B * C):
        nw = -(-int(cb.reshape(-1)[lane]) // 32)
        np.testing.assert_array_equal(win.numpy()[lane, :nw], lanes[lane, :nw])
        assert not win.numpy()[lane, nw:].any()
    np.testing.assert_array_equal(t.dtab.numpy(),
                                  trees.decode_table(lens).numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_fused_adaptive_roundtrip_on_the_cpu(kind):
    ref = _jax(kind)
    data = ref["data"]
    out, bpos_ok, ck_ok, total_bits = P.fused_adaptive_roundtrip(
        C, N, device="cpu")(data, LENGTHS)
    np.testing.assert_array_equal(out.numpy()[0], data[0])
    np.testing.assert_array_equal(out.numpy()[1, : LENGTHS[1]],
                                  data[1, : LENGTHS[1]])
    assert bool(bpos_ok.all()) and bool(ck_ok[0])
    assert int(total_bits) == int(ref["chunk_bits"].sum())


@pytest.mark.parametrize("kind", KINDS)
def test_adaptive_full_length_decodes_its_input(kind):
    data = np.stack([_corpus(kind, N, seed=s + 5) for s in range(3)])
    lengths = np.full(3, N, np.int32)
    out, bpos_ok, ck_ok, _tb = P.fused_adaptive_roundtrip(
        8, N, device="cpu")(data, lengths)
    np.testing.assert_array_equal(out.numpy(), data)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())


def test_adaptive_exit_bits_equal_chunk_bits_per_lane():
    data = _data("mixed")
    win, cb, _ad, _lens, t = PA.encode_adaptive_blocked(
        _t(data), _t(LENGTHS), C)
    starts = torch.zeros(B * C, 1, dtype=torch.int32)
    out, bp = decode2_plain(win, starts, t.dtab, S, 1)
    full = (np.arange(C)[None, :] + 1) * S <= LENGTHS[:, None]
    np.testing.assert_array_equal(bp.reshape(B, C).numpy()[full],
                                  cb.numpy()[full])
