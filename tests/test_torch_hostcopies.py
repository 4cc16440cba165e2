"""The port's copies of the JAX package's host modules, held to the originals.

The port imports nothing of ``fdeflate_tpu`` or ``bench``; it keeps its own
copies of the host code it needs (``fdeflate_tpu_torch/errors.py``,
``tables.py``, ``huffman.py``, ``ops/septree.py``, ``ops/inflate_host.py``,
the stream header in ``trees.py``, ``ops/bitio.py``, ``tools/corpus.py``).  Each copy is held
here to its original on the same inputs, fuzzed where the input space is
large.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys
import zlib

import numpy as np
import pytest

import bench
from fdeflate_tpu import errors as JE
from fdeflate_tpu import huffman as JH
from fdeflate_tpu import tables as JT
from fdeflate_tpu.models import bitstream as JB
from fdeflate_tpu.models import ultrafast as JU
from fdeflate_tpu.ops import adler32 as JAD
from fdeflate_tpu.ops import bitio as JBIT
from fdeflate_tpu.ops import inflate as JI
from fdeflate_tpu.ops import pallas_inflate as JPI
from fdeflate_tpu.ops import septree as JS
from fdeflate_tpu_torch import errors as PE
from fdeflate_tpu_torch import huffman as PH
from fdeflate_tpu_torch import tables as PT
from fdeflate_tpu_torch import trees as PTR
from fdeflate_tpu_torch.ops import adler32 as PAD
from fdeflate_tpu_torch.ops import bitio as PBIT
from fdeflate_tpu_torch.ops import inflate_host as PI
from fdeflate_tpu_torch.ops import septree as PS
from fdeflate_tpu_torch.tools import corpus as PC
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus

TABLES = ["HUFFMAN_CODES", "HUFFMAN_LENGTHS", "LEN_SYM_TO_LEN_BASE",
          "LEN_SYM_TO_LEN_EXTRA", "LENGTH_TO_SYMBOL", "LENGTH_TO_LEN_EXTRA",
          "FIXED_CODE_LENGTHS", "CLCL_ORDER", "DIST_SYM_TO_DIST_BASE",
          "DIST_SYM_TO_DIST_EXTRA", "LITLEN_TABLE_ENTRIES",
          "DISTANCE_TABLE_ENTRIES", "DISTANCE_TO_SYM"]


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_the_originals(name):
    got, want = getattr(PT, name), getattr(JT, name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_table_constants_equal_the_originals():
    for name in ("LITERAL_ENTRY", "EXCEPTIONAL_ENTRY", "SECONDARY_TABLE_ENTRY",
                 "DEFAULT_LITLEN_TABLE_SIZE", "DEFAULT_DIST_TABLE_SIZE"):
        assert getattr(PT, name) == getattr(JT, name), name


def _decode_tables_equal(lengths, entries_name, size, **kw):
    entries = None if entries_name is None else getattr(JT, entries_name)
    got = PH.build_table(lengths, None if entries is None else
                         getattr(PT, entries_name), size, **kw)
    want = JH.build_table(lengths, entries, size, **kw)
    assert got.ok == want.ok
    for name in ("codes", "primary", "secondary", "first_len"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


LITLEN = dict(is_distance_table=False, double_literal=True)
DIST = dict(is_distance_table=True, double_literal=False)


def test_build_table_equals_the_original_on_fixed_and_trained_codes():
    fixed = np.asarray(JT.FIXED_CODE_LENGTHS, np.int64)
    _decode_tables_equal(JT.HUFFMAN_LENGTHS, "LITLEN_TABLE_ENTRIES", 4096,
                         **LITLEN)
    for size in (512, 4096):
        _decode_tables_equal(fixed[:288], "LITLEN_TABLE_ENTRIES", size,
                             **LITLEN)
    for size in (32, 512):
        _decode_tables_equal(fixed[288:320], "DISTANCE_TABLE_ENTRIES", size,
                             **DIST)
    one = np.zeros(32, np.int64)
    one[0] = 1                        # the trained tree's one distance code
    _decode_tables_equal(one, "DISTANCE_TABLE_ENTRIES", 512, **DIST)
    _decode_tables_equal(np.zeros(32, np.int64), "DISTANCE_TABLE_ENTRIES",
                         512, **DIST)


@pytest.mark.parametrize("seed", range(12))
def test_build_table_equals_the_original_on_fuzzed_codes(seed):
    """Codes of up to 15 bits (secondary tables, which grow as long codes
    share a prefix), some incomplete (ok False), with and without
    templates; the copy's secondaries are exercised where the primary
    table is 12 bits."""
    rng = np.random.default_rng(300 + seed)
    lens = _fuzzed_lengths(rng, 288, 15, used=(256,))
    got = _decode_tables_equal(lens, "LITLEN_TABLE_ENTRIES", 4096, **LITLEN)
    if got.ok and lens.max() > 12:
        assert got.secondary.size > 0
    _decode_tables_equal(lens, None, 4096,
                         is_distance_table=False, double_literal=False)
    _decode_tables_equal(_fuzzed_lengths(rng, 32, 15),
                         "DISTANCE_TABLE_ENTRIES", 512, **DIST)
    # distance codes of up to 15 bits (geometric frequencies)
    freqs = (2.0 ** rng.permutation(np.linspace(0, 15, 32))).astype(np.uint64)
    dl = JH.compute_code_lengths(freqs, np.ones(32, np.int64),
                                 np.full(32, 15, np.int64))
    got = _decode_tables_equal(dl, "DISTANCE_TABLE_ENTRIES", 512, **DIST)
    assert dl.max() > 9 and got.secondary.size > 0


def test_stream_header_equals_the_original():
    assert PTR.STREAM_HEADER == JU.STREAM_HEADER
    assert PTR.STREAM_HEADER_BITS == JU.STREAM_HEADER_BITS


@pytest.mark.parametrize("seed", range(4))
def test_canonical_codes_equal_the_original(seed):
    rng = np.random.default_rng(seed)
    lens = JH.compute_code_lengths(rng.integers(1, 1000, 40).astype(np.uint64),
                                   np.ones(40, np.int64), np.full(40, 9))
    np.testing.assert_array_equal(PT.canonical_codes(lens),
                                  JT.canonical_codes(lens))
    lens[0] += 1  # incomplete
    assert PT.canonical_codes(lens) is None and JT.canonical_codes(lens) is None


def test_kernel_tree_equals_the_original():
    for got, want in zip(PS.kernel_tree(), JS.kernel_tree()):
        np.testing.assert_array_equal(got, want)


def _sep_lengths(seed: int, huffman):
    """A class-separated tree from random literal weights, by ``huffman``'s
    DP (literals <= 11 bits, symbols 256..285 pinned to 12)."""
    rng = np.random.default_rng(seed)
    freqs = np.ones(286, np.uint64)
    freqs[:256] = rng.integers(1, 1 << 20, 256).astype(np.uint64)
    lo = np.ones(286, np.int64)
    hi = np.full(286, 11, np.int64)
    lo[256:] = hi[256:] = 12
    return huffman.compute_code_lengths(freqs, lo, hi)


def _profiles():
    trained = (JT.HUFFMAN_LENGTHS, JT.HUFFMAN_CODES)
    out = {"sep_profile": None, "trained": trained}
    for seed in (1, 2):
        lens = _sep_lengths(seed, JH)
        out[f"random_sep_{seed}"] = (lens, JT.canonical_codes(lens))
    return out


@pytest.mark.parametrize("name", ["sep_profile", "trained", "random_sep_1",
                                  "random_sep_2"])
def test_tree_profile_headers_equal_the_original(name):
    spec = _profiles()[name]
    if spec is None:
        got, want = PS.sep_profile(), JS.sep_profile()
    else:
        got, want = PS.TreeProfile(*spec), JS.TreeProfile(*spec)
    assert got.header_bytes == want.header_bytes
    assert got.header_bits == want.header_bits
    np.testing.assert_array_equal(got.lens, want.lens)
    np.testing.assert_array_equal(got.codes, want.codes)


@pytest.mark.parametrize("seed", range(3))
def test_huffman_copies_equal_the_originals(seed):
    np.testing.assert_array_equal(_sep_lengths(seed, PH), _sep_lengths(seed, JH))
    rng = np.random.default_rng(seed)
    for n, limit in ((19, 7), (30, 15), (286, 12)):
        freqs = rng.integers(0, 50, n) * (rng.random(n) < 0.7)
        freqs[: 1 + seed] = rng.integers(1, 1 << 16, 1 + seed)
        got, want = PH.build_huffman_tree(freqs, limit), JB.build_huffman_tree(
            freqs, limit)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def _fuzzed_lengths(rng, n: int, max_len: int, used=()):
    """Complete code lengths over n symbols, some of them unused (the
    ``used`` ones always coded); one in five has one length bumped, which
    leaves the code incomplete."""
    freqs = rng.integers(0, 1 << 12, n) * (rng.random(n) < rng.random())
    freqs[rng.integers(0, n, 2)] += 1
    freqs[list(used)] += 1
    lens = JB.build_huffman_tree(freqs, max_len)[0]
    if rng.random() < 0.2:
        i = int(rng.choice(np.flatnonzero(lens)))
        lens[i] = min(int(lens[i]) + 1, max_len)
    return lens


@pytest.mark.parametrize("seed", range(6))
def test_foreign_meta_equals_the_original(seed):
    """Litlen trees of 257-288 symbols; no, one or many distance codes;
    incomplete trees raise in both."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        lit = _fuzzed_lengths(rng, int(rng.choice([257, 286, 288])), 15,
                              used=(256,))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            dist = np.zeros(30, np.int64)
        elif kind == 1:
            dist = np.zeros(30, np.int64)
            dist[int(rng.integers(0, 30))] = int(rng.integers(1, 5))
        else:
            dist = _fuzzed_lengths(rng, 30, 15)
        try:
            want = JPI.foreign_meta(lit, dist)
        except ValueError:
            with pytest.raises(ValueError):
                PI.foreign_meta(lit, dist)
            continue
        got = PI.foreign_meta(lit, dist)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for got, want in zip(PI._fixed_foreign_meta(), JI._fixed_foreign_meta()):
        np.testing.assert_array_equal(got, want)
    for name in ("_LIT_BASE", "_CLS_EOB", "REC_IDLE", "REC_LITS", "REC_MATCH",
                 "REC_EOB", "REC_ERR"):
        assert getattr(PI, name) == getattr(JPI, name), name
    assert PI.WINDOW == JI.WINDOW
    lens = _fuzzed_lengths(rng, 288, 15)
    np.testing.assert_array_equal(PI._canonical_order(lens),
                                  JPI._canonical_order(lens))


def _state(st):
    """The fields a header walk sets, comparable across the packages."""
    lengths = st.lengths
    if isinstance(lengths, tuple):
        lengths = (lengths[0].tolist(), lengths[1])
    return (st.bitpos, st.done, st.in_block, st.last_block, bytes(st.out),
            st.window.tobytes(), lengths,
            None if st.error is None else type(st.error).__name__)


def _walk(mod, data: bytes):
    """The state after one package's first header walk of a stream."""
    st = mod._StreamState(data)
    mod._advance_headers(st)
    return _state(st)


def _header_streams():
    from test_torch_inflate import BATCH

    rng = np.random.default_rng(7)
    streams = dict(BATCH)
    text = rng.integers(0, 40, 6000).astype(np.uint8).tobytes()
    base = [zlib.compress(text, lvl) for lvl in (1, 6, 9)]
    base.append(zlib.compress(b"", 6))
    base.append(zlib.compress(text[:900], 0))
    for i in range(200):
        z = bytearray(base[i % len(base)])
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(0, min(len(z), 48)))
            z[k] ^= 1 << int(rng.integers(0, 8))
        streams[f"fuzz_{i}"] = bytes(z)
    return streams


HEADER_STREAMS = _header_streams()


@pytest.mark.parametrize("chunk", range(4))
def test_advance_headers_equals_the_original(chunk):
    """``_advance_headers`` (with ``_parse_dynamic_lengths``, the
    code-length table and the tree checks it runs) on the crafted streams
    of tests/test_torch_inflate.py and on streams with bits flipped in
    their headers: the same state, lengths and error class."""
    names = sorted(HEADER_STREAMS)[chunk::4]
    for name in names:
        z = HEADER_STREAMS[name]
        assert _walk(PI, z) == _walk(JI, z), name


@pytest.mark.parametrize("seed", range(3))
def test_parse_dynamic_lengths_equals_the_original(seed):
    """From every bit offset of a stream's first bytes: the lengths or the
    error class of both parsers, and where the reader stopped."""
    rng = np.random.default_rng(seed)
    z = zlib.compress(rng.integers(0, 1 << (4 + seed), 3000).astype(
        np.uint8).tobytes(), 6)
    for off in range(16, 16 + 8 * 24):
        out = []
        for mod in (PI, JI):
            r = mod._HostBitReader(z, off)
            try:
                lengths, hlit = mod._parse_dynamic_lengths(r)
                out.append((lengths.tolist(), hlit, r.pos))
            except (PE.DecompressionError, JE.DecompressionError) as err:
                out.append((type(err).__name__, r.pos))
        assert out[0] == out[1], off


def test_error_classes_equal_the_originals():
    assert [(s.name, int(s)) for s in PE.Status] == [
        (s.name, int(s)) for s in JE.Status]
    want = {c.__name__: c.status for c in JE.DecompressionError.__subclasses__()}
    got = {c.__name__: c.status for c in PE.DecompressionError.__subclasses__()}
    assert {k: int(v) for k, v in got.items()} == {
        k: int(v) for k, v in want.items()}
    for s in PE.Status:
        if s != PE.Status.OK and s.name != "OUTPUT_TOO_LARGE":
            assert type(PE.error_for_status(int(s))).__name__ == type(
                JE.error_for_status(int(s))).__name__


@pytest.mark.parametrize("seed", [0, 5])
def test_make_idat_corpus_equals_bench(seed):
    got = make_idat_corpus(3, 5000, seed)
    want = bench.make_idat_corpus(3, 5000, seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_distance_map_equals_the_original():
    np.testing.assert_array_equal(PT._build_distance_map(),
                                  JT._build_distance_map())
    assert [PT.distance_to_dist_sym(d) for d in range(1, 32769)] == [
        JT.distance_to_dist_sym(d) for d in range(1, 32769)]


@pytest.mark.parametrize("seed", range(4))
def test_pack_bits_equals_the_original(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 400))
    lengths = rng.integers(0, 58, n)
    values = rng.integers(0, 1 << 57, n, dtype=np.uint64) & (
        (np.uint64(1) << lengths.astype(np.uint64)) - np.uint64(1))
    carry_bits = int(rng.integers(0, 8))
    carry = int(rng.integers(0, 1 << carry_bits)) if carry_bits else 0
    assert PBIT.pack_bits(values, lengths, carry, carry_bits) == \
        JBIT.pack_bits(values, lengths, carry, carry_bits)


@pytest.mark.parametrize("seed", range(4))
def test_bit_writer_equals_the_original(seed):
    """The same writes, single and packed, give the same sink and bit
    position at every step."""
    rng = np.random.default_rng(seed)
    got, want = PBIT.BitWriter(), JBIT.BitWriter(bytearray(b"\x78"))
    got.sink += b"\x78"
    for _ in range(60):
        if rng.random() < 0.8:
            nbits = int(rng.integers(0, 33))
            bits = int(rng.integers(0, 1 << 40))
            got.write_bits(bits, nbits)
            want.write_bits(bits, nbits)
        else:
            lengths = rng.integers(0, 30, int(rng.integers(0, 50)))
            values = rng.integers(0, 1 << 30, len(lengths))
            got.write_packed(values, lengths)
            want.write_packed(values, lengths)
        assert got.bit_position == want.bit_position
        assert bytes(got.sink) == bytes(want.sink)
    assert bytes(got.flush()) == bytes(want.flush())


def _bench_module(name: str):
    """A script of bench/ loaded by path (it puts its folders on sys.path
    while it loads; they are taken off again)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "bench" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.mark.parametrize("gen", ["gen_uniform", "gen_low", "gen_mixture",
                                 "gen_distribution"])
def test_distribution_generators_equal_bench(gen):
    want = getattr(_bench_module("distributions"), gen)(
        np.random.default_rng(3))
    got = getattr(PC, gen)(np.random.default_rng(3))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_size_corpora_equal_bench():
    want = _bench_module("sizes").corpora()
    got = PC.corpora()
    assert [n for n, _ in got] == [n for n, _ in want]
    assert all(g == w for (_, g), (_, w) in zip(got, want))


@pytest.mark.parametrize("seed", range(4))
def test_adler32_combine_equals_the_original(seed):
    """``ops/adler32.combine`` on random checksums (not only valid ones:
    halves up to 0xFFFF) and lengths, 0 and the ones around 65521
    included, and on real checksums, where it is ``zlib.adler32`` of the
    concatenation."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        a1, a2 = (int(x) for x in rng.integers(0, 1 << 32, 2, dtype=np.uint64))
        n = int(rng.choice([0, 1, 65520, 65521, 65522,
                            int(rng.integers(0, 1 << 31))]))
        assert PAD.combine(a1, a2, n) == JAD.combine(a1, a2, n)
    x = rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()
    for cut in (0, 1, 65521, 69999, 70000):
        got = PAD.combine(zlib.adler32(x[:cut]), zlib.adler32(x[cut:]),
                          len(x) - cut)
        assert got == JAD.combine(zlib.adler32(x[:cut]),
                                  zlib.adler32(x[cut:]), len(x) - cut)
        assert got == zlib.adler32(x)
