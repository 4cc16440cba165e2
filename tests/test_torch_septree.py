"""The septree profile in the port (encode with ``tree=``, K6's plain
version, ``sep_tables``, the decode step) against the JAX package.

The JAX encode reference is ``encode_ultrafast_batch(..., kernel_pack=False,
kernel_assign=False, tree=sep_profile())`` (the XLA path, as
tests/test_septree.py).  The only JAX oracle of ``_kernel_sep`` is its
Pallas kernel in interpret mode, so it runs ONCE, in a module fixture, on
every lane of a small batch with a full, a ragged, an empty and a corrupted
stream (U = 1: the same decode as the default U, a smaller interpret
compile).  Every other case is held to ``decode_chunk_np`` with the sep
tree's lengths and to ``zlib.decompress``.  All outputs are integers:
comparisons are exact.
"""

from __future__ import annotations

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdeflate_tpu.ops import ultrafast_kernel as UK
from fdeflate_tpu.ops.pallas_decode2 import (
    adler_step_major,
    decode_blocked_sep,
    decode_chunk_np,
    sep_meta,
)
from fdeflate_tpu.ops.repack import (
    stage_blocked_from_linear,
    stage_blocked_np,
    stage_wwin,
)
from fdeflate_tpu.ops.septree import TreeProfile, kernel_tree, sep_profile
from fdeflate_tpu.tables import HUFFMAN_CODES, HUFFMAN_LENGTHS
import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.decode_sep import decode_sep, decode_sep_plain
from fdeflate_tpu_torch.trees import canonical_codes, sep_tables
from fdeflate_tpu_torch.utils import profiling

B, N, C = 4, 2048, 8
S = N // C
LENGTHS = np.array([N, N // 2 + 13, 0, N], np.int32)


def _launches(name: str) -> int:
    return profiling.counts().get("launch." + name, 0)


def _jax_encode(data, lengths, C_, tree):
    return [np.asarray(x) for x in UK.encode_ultrafast_batch(
        jnp.asarray(data), jnp.asarray(lengths), num_chunks=C_,
        fixed_geometry=True, return_eof=True, kernel_pack=False,
        kernel_assign=False, tree=tree)]


def _septree_corpus(rng, B_, N_):   # tests/test_septree.py's corpus
    d = rng.integers(0, 256, (B_, N_)).astype(np.uint8)
    d[0, rng.random(N_) < 0.5] = 0
    if B_ > 1:
        d[1, N_ // 4 : N_ // 2] = 0
    return d


@functools.lru_cache(maxsize=None)
def _jax_sep_decoder(C_: int, N_: int):
    S_ = N_ // C_
    return jax.jit(lambda w, s: decode_blocked_sep(
        stage_blocked_from_linear(w, s, C_, stage_wwin(S_)), T=S_ // 4, U=1,
        interpret=True, lane_major=False))


@pytest.fixture(scope="module")
def ref():
    data = _septree_corpus(np.random.default_rng(3), B, N)
    data[3] = data[0]
    for b in range(B):
        data[b, LENGTHS[b]:] = 0
    words, tb, adler, starts, eof = _jax_encode(data, LENGTHS, C, sep_profile())
    # Row 3: row 0 with one payload word flipped, same index and checksum.
    words = words.copy()
    words[3, (int(starts[3, 2]) >> 5) + 3] ^= np.uint32(0x00F0F0F0)
    out_sm, bpos = _jax_sep_decoder(C, N)(jnp.asarray(words),
                                          jnp.asarray(starts))
    out = np.asarray(out_sm)
    L = B * C
    lanes = np.ascontiguousarray(
        out.transpose(0, 2, 3, 1).reshape(-1, S // 4)[:L])
    bp = np.asarray(bpos).reshape(-1)[:L].reshape(B, C)
    # The JAX decode leg's two checks on the kernel's output.
    expected = np.concatenate([starts[:, 1:], eof[:, None]], 1) - starts
    full = np.arange(C)[None, :] * S + S <= LENGTHS[:, None]
    ck = np.asarray(adler_step_major(out_sm, B, C, S, jnp.asarray(LENGTHS)))
    return dict(data=data, words=words, total_bits=tb, adler=adler,
                starts=starts, eof=eof,
                out=lanes.view(np.uint8).reshape(B, N), bpos=bp,
                bpos_ok=((bp == expected) | ~full).all(1), ck_ok=ck == adler)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _port_sep_decode(r):
    meta, vals = sep_tables(sep_profile().lens)
    return decode_sep_plain(_t(r["words"].view(np.int32)), _t(r["starts"]),
                            meta, vals, N, C)


def test_decode_sep_plain_matches_kernel_sep_on_every_lane(ref):
    """Full, ragged, empty (EOB-first) and corrupted lanes: bytes and exit
    bits equal the TPU kernel's."""
    out, bpos = _port_sep_decode(ref)
    np.testing.assert_array_equal(bpos.numpy(), ref["bpos"])
    np.testing.assert_array_equal(out.numpy(), ref["out"])
    np.testing.assert_array_equal(out.numpy()[:3], ref["data"][:3])


def test_eob_lanes_decode_on_past_the_stream_end(ref):
    """K6 does not stall at EOB: an empty lane reads the 12-bit EOF token
    and then zero bits as zero literals (2 bits each), 3 + 4 * (S/4 - 1)
    of them."""
    _, bpos = _port_sep_decode(ref)
    assert (bpos.numpy()[2] == 12 + 2 * (S - 1)).all()
    assert (ref["starts"][2] == ref["eof"][2]).all()


def test_decode_step_flags_match_jax(ref):
    step = P.zlib_decode_step(C, N, tree=sep_profile())
    out, bpos_ok, ck_ok = step(_t(ref["words"].view(np.int32)),
                               _t(ref["starts"]), _t(ref["eof"]),
                               _t(ref["adler"].astype(np.int64)),
                               _t(LENGTHS))
    np.testing.assert_array_equal(out.numpy(), ref["out"])
    np.testing.assert_array_equal(bpos_ok.numpy(), ref["bpos_ok"])
    np.testing.assert_array_equal(ck_ok.numpy(), ref["ck_ok"])
    assert bpos_ok[:3].all() and ck_ok[:3].all()
    assert not (bpos_ok[3] and ck_ok[3])     # the flipped word is caught


def test_decode_sep_wrapper_takes_the_plain_version_on_the_cpu(ref):
    meta, vals = sep_tables(sep_profile().lens)
    before = _launches("decode_sep")
    got = decode_sep(_t(ref["words"].view(np.int32)), _t(ref["starts"]),
                     meta, vals, N, C)
    want = _port_sep_decode(ref)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _launches("decode_sep") == before


def _ragged_runs():
    rng = np.random.default_rng(11)
    d = np.zeros((3, 4096), np.uint8)
    d[0] = rng.integers(0, 256, 4096)                 # dense random
    d[1, rng.random(4096) < 0.6] = 1                  # run-heavy
    d[1] *= rng.integers(0, 256, 4096).astype(np.uint8)
    d[2, :1000] = rng.integers(1, 256, 1000)          # all zeros after
    lengths = np.array([4096, 3001, 4096], np.int32)
    d[1, 3001:] = 0
    return d, lengths, 4


def _runs_at_lane_ends():
    rng = np.random.default_rng(4)
    d = rng.integers(1, 256, (2, 2048)).astype(np.uint8)
    for k, tail in enumerate([1, 2, 3, 4, 5, 6, 258, 259, 600]):
        s = 256 * (k % 8) + 200
        d[k % 2, s : s + tail + 1] = 0                # across lane ends
    return d, np.full(2, 2048, np.int32), 8


def _septree_case():
    d = _septree_corpus(np.random.default_rng(5), 2, 4096)
    d[1, 4096 - 13 :] = 0
    return d, np.array([4096, 4096 - 13], np.int32), 4


def _empty_and_short():
    rng = np.random.default_rng(6)
    d = rng.integers(0, 256, (3, 1024)).astype(np.uint8)
    lengths = np.array([0, 9, 1024], np.int32)
    for b in range(3):
        d[b, lengths[b]:] = 0
    return d, lengths, 16


CASES = {
    "ragged_runs_C4": _ragged_runs,
    "runs_at_lane_ends_C8": _runs_at_lane_ends,
    "septree_corpus_C4": _septree_case,
    "empty_and_short_C16": _empty_and_short,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sep_encode_matches_jax(case):
    """Words up to ceil(total_bits / 32) (zero past it), total_bits, adler,
    chunk_starts and eof_pos equal the JAX XLA encoder's with the profile;
    every stream is plain zlib."""
    data, lengths, C_ = CASES[case]()
    tree = sep_profile()
    ref = _jax_encode(data, lengths, C_, tree)
    got = P.zlib_encode_step(C_, tree=tree)(_t(data), _t(lengths))
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
    for b, s in enumerate(P.finalize_streams(*got[:3])):
        assert zlib.decompress(s) == data[b, : lengths[b]].tobytes(), b


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_sep_matches_numpy_oracle(case):
    """Every full lane: bytes and exit bit of ``decode_chunk_np`` with the
    sep tree's lengths; the whole batch decodes to its input."""
    data, lengths, C_ = CASES[case]()
    Bn, Nn = data.shape
    S_ = Nn // C_
    tree = sep_profile()
    words, _tb, _ad, starts, _eof = P.zlib_encode_step(C_, tree=tree)(
        _t(data), _t(lengths))
    meta, vals = sep_tables(tree.lens)
    out, bp = decode_sep_plain(words, starts, meta, vals, Nn, C_)
    np.testing.assert_array_equal(out.numpy(), data)
    win = stage_blocked_np(words.numpy().view(np.uint32), starts.numpy(), C_,
                           stage_wwin(S_))
    lens = kernel_tree()[0]
    n_full = 0
    for lane in range(Bn * C_):
        b, k = divmod(lane, C_)
        if (k + 1) * S_ > lengths[b]:
            continue
        lb, r = divmod(lane, 1024)
        want, bits = decode_chunk_np(win[lb, :, r // 128, r % 128], S_,
                                     lens=lens)
        np.testing.assert_array_equal(out.numpy()[b, k * S_ : (k + 1) * S_],
                                      want)
        assert int(bp[b, k]) == bits, lane
        n_full += 1
    assert n_full > 0


def _shuffled_sep_lengths(seed: int) -> np.ndarray:
    """Another class-separated tree: the sep tree's literal lengths given
    to other literals."""
    lens = kernel_tree()[0].copy()
    lens[:256] = np.random.default_rng(seed).permutation(lens[:256])
    return lens


SEP_LENGTHS = {
    "kernel_tree": lambda: kernel_tree()[0],
    "shuffled_literals": lambda: _shuffled_sep_lengths(1),
}


@pytest.mark.parametrize("which", sorted(SEP_LENGTHS))
def test_sep_tables_match_sep_meta(which):
    lens = SEP_LENGTHS[which]()
    meta, vals = sep_tables(lens)
    want_meta, want_vals = sep_meta(lens)
    np.testing.assert_array_equal(meta.numpy(), want_meta)
    np.testing.assert_array_equal(vals.numpy(), want_vals)


def _literal_at_12():
    lens = kernel_tree()[0].copy()
    lens[np.argmax(lens[:256] == 11)] = 12
    return lens


def _incomplete():
    lens = kernel_tree()[0].copy()
    lens[np.argmax(lens[:256] == 11)] = 0       # frees part of the space
    return lens


NOT_SEP = {
    "trained_tree": lambda: np.asarray(HUFFMAN_LENGTHS, np.int64),
    "literal_at_12_bits": _literal_at_12,
    "incomplete_code": _incomplete,
}


@pytest.mark.parametrize("which", sorted(NOT_SEP))
def test_sep_tables_reject_other_trees(which):
    with pytest.raises(ValueError):
        sep_tables(NOT_SEP[which]())


def test_sep_tables_reject_where_sep_meta_asserts():
    with pytest.raises(AssertionError):
        sep_meta(_literal_at_12())
    with pytest.raises(ValueError):
        sep_tables(_literal_at_12())


def _profile(lens: np.ndarray) -> TreeProfile:
    codes = canonical_codes(torch.from_numpy(lens))[0].numpy()
    return TreeProfile(lens, codes)


def test_decode_step_decodes_with_the_tree_it_is_given():
    """A sep tree other than the kernel tree roundtrips: the decode takes
    the profile's own (meta, vals), where the JAX decode leg always takes
    the kernel tree's.  Full-length streams: past a length, zero bits
    decode to this tree's all-zero code, which is not literal 0 here."""
    tree = _profile(_shuffled_sep_lengths(2))
    assert tree.codes[0] != 0 or tree.lens[0] != 2
    data, _lengths, C_ = _septree_case()
    lengths = np.full(data.shape[0], data.shape[1], np.int32)
    out, bpos_ok, ck_ok = P.fused_zlib_roundtrip(
        C_, data.shape[1], tree=tree, device="cpu")(data, lengths)
    np.testing.assert_array_equal(out.numpy(), data)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())
    words, tb, adler, _s, _e = P.zlib_encode_step(C_, tree=tree)(
        _t(data), _t(lengths))
    for b, s in enumerate(P.finalize_streams(words, tb, adler)):
        assert zlib.decompress(s) == data[b, : lengths[b]].tobytes()


def test_fused_sep_roundtrip_on_the_cpu():
    data, lengths, C_ = _ragged_runs()
    out, bpos_ok, ck_ok = P.fused_zlib_roundtrip(
        C_, data.shape[1], tree=P.sep_profile(), device="cpu")(data, lengths)
    np.testing.assert_array_equal(out.numpy(), data)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())


def test_trained_tree_profile_encodes_but_does_not_sep_decode():
    """Any <= 12-bit profile encodes (its own header, plain zlib); only a
    class-separated one has a decode step."""
    tree = TreeProfile(np.asarray(HUFFMAN_LENGTHS), np.asarray(HUFFMAN_CODES))
    data, lengths, C_ = _septree_case()
    got = P.zlib_encode_step(C_, tree=tree)(_t(data), _t(lengths))
    ref = _jax_encode(data, lengths, C_, tree)
    np.testing.assert_array_equal(got[1].numpy(), ref[1])
    for b, s in enumerate(P.finalize_streams(*got[:3])):
        assert zlib.decompress(s) == data[b, : lengths[b]].tobytes()
    with pytest.raises(ValueError):
        P.zlib_decode_step(C_, data.shape[1], tree=tree)
