"""The port's host streaming codec (``fdeflate_tpu_torch/models/``) against
the JAX package's (``fdeflate_tpu/models/``), exactly.

Compressors: the bytes of every level 0-9, RLE and ultra-fast, one-shot and
streamed with split writes, on the inputs of tests/test_compress.py, on the
Python path and on the native path.  JAX's native path runs JAX's ctypes
wrapper over the library the port built (the same sources and flags), so
this file never builds into ``native/`` (ROADMAP Queue 3: JAX's loader
races its build there).  Decompressor: the (consumed, produced, is_done)
sequence of ``read``, the output and the error class by name on every file
of tests/fixtures/corpus and the three chunking fixtures at several input
and output chunkings, ``ignore_adler32``, and ``OutputTooLarge``'s partial
output.  The whole-buffer device route of ``decompress_to_vec_bounded`` on
the CPU (``device="cpu"``, native off), where nothing catches the batch
decoder's exceptions.  Hypothesis differentials in the style of
tests/test_property.py.
"""

from __future__ import annotations

import ctypes
import io
import itertools
import pathlib
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import fdeflate_tpu as F
from fdeflate_tpu.models import compressor as JC
from fdeflate_tpu.models import decompressor as JD
from fdeflate_tpu.models import native as JN
from fdeflate_tpu.models import ultrafast as JU
import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.models import compressor as PC
from fdeflate_tpu_torch.models import decompressor as PD
from fdeflate_tpu_torch.models import native as PN
from fdeflate_tpu_torch.models import ultrafast as PU
from fdeflate_tpu_torch.parallel import discovery

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CORPUS = sorted((FIXTURES / "corpus").iterdir()) + sorted(
    FIXTURES.glob("input-chunking-sensitivity-example*.zz"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The device route's plain kernels on the CPU use one thread each, as
    the suite's parallel workers share the host; restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def native_pair():
    """(JAX's native module, the port's) over one library: the port's build,
    bound to JAX's wrapper for this module and restored after."""
    if not PN.available():
        pytest.fail(f"native backend unavailable: {PN.unavailable_reason()}")
    saved = (JN._lib, JN._tried)
    JN._lib, JN._tried = PN._bind(ctypes.CDLL(str(PN.library_path()))), True
    yield JN, PN
    JN._lib, JN._tried = saved


def _alphabet(seed: int, chars: bytes, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(chars, np.uint8), n).tobytes()


def _compress_inputs():
    """The inputs of tests/test_compress.py."""
    rng = np.random.default_rng(5)
    out = {"hello": b"Hello world!", "empty": b""}
    out.update({f"const{b}": bytes([b] * 2048) for b in (0, 5, 128, 254)})
    out.update({f"random{i}": rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
                for i in range(2)})
    out.update({f"zeros{n}": bytes(n) for n in
                (1, 7, 8, 9, 15, 256, 257, 258, 259, 516, 776, 5000)})
    edges = [b"\x00\x00\x00ab\x00\x00\x00", b"ab\x00\x00\x00\x00\x00\x00xy",
             b"\x00" * 5 + b"ab" + b"\x00" * 600 + b"xyz" + b"\x00" * 3,
             b"a\x00b\x00c\x00d\x00", bytes(16) + b"q" + bytes(16)]
    out.update({f"edge{i}": e for i, e in enumerate(edges)})
    out["streaming"] = _alphabet(9, b"\x00\x00\x00abc", 10000)
    out["stored_split"] = bytes(range(256)) * 300
    out["random30000"] = np.random.default_rng(12).integers(
        0, 256, 30000, dtype=np.uint8).tobytes()
    return out


INPUTS = _compress_inputs()


def _level_data(level: int) -> bytes:
    """TestCompressorLevels.test_roundtrip_against_zlib's input."""
    return _alphabet(level + 100, b"abcdefghij\x00\x00\x00\x00\x00\x00", 40000)


# ------------------------------------------------------------ compressors


@pytest.mark.parametrize("level", range(10))
def test_levels_python_path_equal_jax(level):
    data = _level_data(level)
    got = PC._compress_to_vec_with_level_python(data, level)
    assert got == JC._compress_to_vec_with_level_python(data, level)
    assert zlib.decompress(got) == data


@pytest.mark.parametrize("level", range(10))
def test_levels_native_path_equal_jax(native_pair, level):
    JNat, PNat = native_pair
    for data in [_level_data(level), *INPUTS.values()]:
        got = P.compress_to_vec_with_level(data, level)
        assert got == F.compress_to_vec_with_level(data, level)
        assert got == PNat.deflate(data, level) == JNat.deflate(data, level)
        assert zlib.decompress(got) == data
    raw = PNat.deflate(INPUTS["streaming"], level, zlib_mode=False)
    assert raw == JNat.deflate(INPUTS["streaming"], level, zlib_mode=False)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_small_inputs_python_paths_equal_jax(name):
    """Levels 0-3 and 6, RLE and ultra-fast on the Python path."""
    data = INPUTS[name]
    for level in (0, 1, 2, 3, 6):
        got = PC._compress_to_vec_with_level_python(data, level)
        assert got == JC._compress_to_vec_with_level_python(data, level), level
    rle = P.compress_to_vec_rle(data)
    assert rle == F.compress_to_vec_rle(data)
    uf = PU._compress_to_vec_ultra_fast_python(data)
    assert uf == JU._compress_to_vec_ultra_fast_python(data)
    assert zlib.decompress(rle) == data and zlib.decompress(uf) == data


def test_ultra_fast_native_path_equals_jax(native_pair):
    JNat, PNat = native_pair
    for data in INPUTS.values():
        got = P.compress_to_vec_ultra_fast(data)
        assert got == F.compress_to_vec_ultra_fast(data)
        assert got == PNat.compress_ultra(data) == JNat.compress_ultra(data)
        assert got == PU._compress_to_vec_ultra_fast_python(data)


def _streamed(cls, data, sizes, **kw):
    c = cls(**kw)
    pos = 0
    for size in sizes:
        c.write_data(data[pos:pos + size])
        pos += size
        if pos >= len(data):
            break
    c.write_data(data[pos:])
    return bytes(c.finish())


@pytest.mark.parametrize("level", [1, 4])
def test_streamed_compressor_equals_jax(level):
    """test_streamed_writes_roundtrip's writes (1, 7, 100, 3000, 40000,
    100000 bytes) of its 60000-byte input."""
    data = _alphabet(42, b"aabbbcc\x00", 60000)
    sizes = [1, 7, 100, 3000, 40000, 100000]
    got = _streamed(P.Compressor, data, sizes, level=level)
    assert got == _streamed(F.Compressor, data, sizes, level=level)
    assert zlib.decompress(got) == data


def test_compressor_modes_equal_jax():
    """Sync flush, raw deflate, the 128 KiB window discard, RLE streamed,
    level 0 streamed over the stored-block limit, file-like sinks."""
    def both(run):
        got, want = run(P), run(F)
        assert got == want
        return got

    def sync(M):
        c = M.Compressor(level=1)
        c.write_data(b"first part first part first part")
        c.flush()
        c.write_data(b"second part second part")
        return bytes(c.finish())

    assert zlib.decompress(both(sync)) == (
        b"first part first part first partsecond part second part")
    raw = both(lambda M: _streamed(M.Compressor, b"raw deflate " * 9, [5],
                                   level=1, zlib_mode=False))
    assert zlib.decompress(raw, wbits=-15) == b"raw deflate " * 9
    piece = _alphabet(8, b"abcde\x00", 50000)
    long = both(lambda M: _streamed(M.Compressor, piece * 8, [50000] * 7,
                                    level=1))
    assert zlib.decompress(long) == piece * 8
    data = INPUTS["stored_split"]
    for level in (0, 2):
        out = both(lambda M: _streamed(M.Compressor, data, [70000, 3],
                                       level=level))
        assert zlib.decompress(out) == data
    rle = both(lambda M: _streamed(M.Compressor.new_rle, INPUTS["streaming"],
                                   [997] * 10))
    assert zlib.decompress(rle) == INPUTS["streaming"]

    def sink(M):
        buf = io.BytesIO()
        c = M.Compressor(buf, level=2)
        c.write_data(b"stream me " * 1000)
        c.flush()
        c.write_data(b"more data " * 500)
        assert c.finish() is buf
        u = io.BytesIO()
        uc = M.UltraFastCompressor(u)
        uc.write_data(bytes(5000))
        uc.write_data(b"tail")
        assert uc.finish() is u
        return buf.getvalue(), u.getvalue()

    both(sink)


def test_streamed_ultra_fast_equals_jax():
    data = INPUTS["streaming"]
    for sizes in ([997] * 11, [1, 2, 3, 5, 8, 13, 21, 34, 55, 89] * 3, [0, 9999]):
        got = _streamed(P.UltraFastCompressor, data, sizes)
        assert got == _streamed(F.UltraFastCompressor, data, sizes)
        assert zlib.decompress(got) == data


@pytest.mark.parametrize("corpus", ["low", "text", "mixed"])
def test_size_monotonicity_corpora_equal_jax(corpus):
    """TestSizeMonotonicity's corpora at levels 1 and 7, with demotion on
    and off (the emulated-fdeflate baseline)."""
    from fdeflate_tpu.models import bitstream as JB
    from fdeflate_tpu_torch.models import bitstream as PB

    rng = np.random.default_rng(7)
    low = ((rng.integers(0, 16, 1 << 16, dtype=np.uint8) * 2) - 16).astype(
        np.uint8).tobytes()
    words = [b"the", b"quick", b"brown", b"fox", b"lazy", b"dogs"]
    text = b" ".join(words[i] for i in rng.integers(0, 6, 8000))
    data = {"low": low, "text": text,
            "mixed": low[: 1 << 15] + text[: 1 << 15]}[corpus][: 1 << 14]
    for demote in (True, False):
        saved = JB.ENABLE_DEMOTION, PB.ENABLE_DEMOTION
        JB.ENABLE_DEMOTION = PB.ENABLE_DEMOTION = demote
        try:
            for level in (1, 7):
                got = PC._compress_to_vec_with_level_python(data, level)
                assert got == JC._compress_to_vec_with_level_python(data, level)
        finally:
            JB.ENABLE_DEMOTION, PB.ENABLE_DEMOTION = saved


def test_code_lengths_export_equals_jax():
    freqs = np.array([10, 5, 3, 1, 0, 7])
    lo, hi = np.ones(6, np.int64), np.full(6, 15, np.int64)
    np.testing.assert_array_equal(P.compute_code_lengths(freqs, lo, hi),
                                  F.compute_code_lengths(freqs, lo, hi))


# ----------------------------------------------------------- decompressor


def _trace(M, data: bytes, in_step: int, out_step: int | None = None,
           ignore: bool = True, out_size: int = 1 << 20):
    """Drive ``M.Decompressor().read`` with ``in_step`` bytes of input a
    call (and, with ``out_step``, that many more bytes of output room a
    call): every (consumed, produced, is_done), the output, and the error
    class by name (or None)."""
    d = M.Decompressor()
    if ignore:
        d.ignore_adler32()
    out = bytearray(out_size)
    ip = op = 0
    seq = []
    err = None
    try:
        for _ in range(20000):
            if d.is_done():
                break
            view = out if out_step is None else memoryview(out)[:op + out_step]
            c, p = d.read(data[ip:ip + in_step], view, op)
            ip += c
            op += p
            seq.append((c, p, d.is_done()))
            if c == 0 and p == 0 and (ip >= len(data) or op == out_size):
                break
    except M.DecompressionError as e:
        err = type(e).__name__
    return seq, bytes(out[:op]), d.is_done(), err


CHUNKINGS = [(1 << 20, None), (1, None), (7, None), (64, 13)]


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.name[:12])
def test_decompressor_read_equals_jax(path):
    data = path.read_bytes()
    for in_step, out_step in CHUNKINGS:
        got = _trace(P, data, in_step, out_step)
        assert got == _trace(F, data, in_step, out_step), (in_step, out_step)
    got = _trace(P, data, 3, ignore=False)
    assert got == _trace(F, data, 3, ignore=False)


def test_decompressor_checksum_equals_jax():
    data = _alphabet(3, b"aabbc\x00\x00\x00", 3000)
    for level in (0, 1, 6, 9):
        z = zlib.compress(data, level)
        bad = z[:-1] + bytes([z[-1] ^ 1])
        for stream, ignore in ((z, False), (bad, False), (bad, True)):
            for step in (1, 5, len(stream)):
                got = _trace(P, stream, step, ignore=ignore)
                assert got == _trace(F, stream, step, ignore=ignore)
                want = "WrongChecksum" if stream is bad and not ignore else None
                assert got[3] == want and (want is not None or got[1] == data)


def test_bounded_output_python_path_equals_jax(monkeypatch):
    monkeypatch.setattr(PN, "available", lambda: False)
    monkeypatch.setattr(JN, "available", lambda: False)
    data = bytes(100000)
    z = zlib.compress(data)
    for maxlen in (1000, 1024, 33792, 99999):
        with pytest.raises(P.OutputTooLarge) as got:
            P.decompress_to_vec_bounded(z, maxlen)
        with pytest.raises(F.OutputTooLarge) as want:
            F.decompress_to_vec_bounded(z, maxlen)
        assert got.value.partial_output == want.value.partial_output
    assert P.decompress_to_vec_bounded(z, 100000) == data
    for path in CORPUS:
        stream = path.read_bytes()
        assert _outcome(lambda: P.decompress_to_vec_bounded(stream, 4096)) == \
            _outcome(lambda: F.decompress_to_vec_bounded(stream, 4096))


def test_bounded_output_native_path_equals_the_oracle(native_pair):
    """The native path's ``OutputTooLarge`` carries the stream's first
    ``maxlen`` bytes, the Python oracle's partial output (JAX's native
    wrapper returns bytes past the decoder's last step that it never
    wrote, so its partial output is held only on what was written); every
    other outcome equals JAX's native path and the oracle."""
    data = _alphabet(4, b"abc\x00\x00", 100000)
    z = zlib.compress(data, 6)
    stored = zlib.compress(data, 0)
    bad = z[:-1] + bytes([z[-1] ^ 1])
    for stream, maxlen in itertools.product((z, stored, bad),
                                            (0, 1, 1000, 65536, 99999)):
        with pytest.raises(P.OutputTooLarge) as got:
            P.decompress_to_vec_bounded(stream, maxlen)
        assert got.value.partial_output == data[:maxlen]
        with pytest.raises(F.OutputTooLarge) as want:
            F.decompress_to_vec_bounded(stream, maxlen)
        n = len(want.value.partial_output)
        assert n == maxlen
        with pytest.raises(F.OutputTooLarge) as oracle:
            JD._decompress_to_vec_python(stream, maxlen)
        assert oracle.value.partial_output == data[:maxlen]
    for stream in (z, stored):
        assert P.decompress_to_vec_bounded(stream, 100000) == data
    assert _outcome(lambda: P.decompress_to_vec_bounded(bad, 100000)) == (
        "err", "WrongChecksum")
    for path in CORPUS:
        stream = path.read_bytes()
        for maxlen in (None, 4096, 1 << 20):
            got = _outcome(lambda: P.decompress_to_vec_bounded(stream, maxlen))
            oracle = _outcome(lambda: JD._decompress_to_vec_python(
                stream, maxlen))
            assert got == oracle, (path.name, maxlen)
            if got[0] != "too-large":
                assert got == _outcome(
                    lambda: F.decompress_to_vec_bounded(stream, maxlen))


def _outcome(fn):
    """A decode's result as a comparable value across the two packages."""
    try:
        return ("ok", fn())
    except (P.OutputTooLarge, F.OutputTooLarge) as e:
        return ("too-large", e.partial_output)
    except (P.DecompressionError, F.DecompressionError) as e:
        return ("err", type(e).__name__)


# ----------------------------------------------------- the device route


def _text(n: int, seed: int = 0) -> bytes:
    """Word salad of 40 words: few records a byte, as the plain K4 on the
    CPU costs a loop iteration per record."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, int(rng.integers(3, 9)), np.uint8))
             for _ in range(40)]
    return b" ".join(words[i] for i in rng.integers(0, 40, n // 4))[:n]


@pytest.fixture
def device_route(monkeypatch):
    """Native off, the route's threshold at 1 KiB; returns the list that
    records every call of ``discovery.decompress_batch``."""
    monkeypatch.setattr(PN, "available", lambda: False)
    monkeypatch.setattr(PD, "_DEVICE_ROUTE_MIN", 1024)
    calls = []
    batch = discovery.decompress_batch

    def counted(streams, *a, **kw):
        calls.append(kw.get("device"))
        return batch(streams, *a, **kw)

    monkeypatch.setattr(discovery, "decompress_batch", counted)
    return calls


def test_device_route_equals_jax(device_route):
    """Streams over the threshold decode through ``decompress_batch`` with
    ``device="cpu"``; results and ``maxlen`` semantics equal JAX's (its
    route starts at 256 KiB, so at these sizes JAX decodes in Python, the
    oracle of both)."""
    data = _text(16000)
    co = zlib.compressobj(6)
    split = co.compress(data[:8000]) + co.flush(zlib.Z_BLOCK) + \
        co.compress(data[8000:]) + co.flush()
    for z in (zlib.compress(data, 1), zlib.compress(data, 9), split):
        assert len(z) >= 1024
        got = P.decompress_to_vec_bounded(z, None, device="cpu")
        assert got == JD._decompress_to_vec_python(z, None) == data
        with pytest.raises(P.OutputTooLarge) as exc:
            P.decompress_to_vec_bounded(z, 4096, device="cpu")
        with pytest.raises(F.OutputTooLarge) as want:
            JD._decompress_to_vec_python(z, 4096)
        assert exc.value.partial_output == want.value.partial_output
        assert exc.value.partial_output == data[:4096]
    with pytest.raises(P.OutputTooLarge) as exc:
        P.decompress_to_vec_bounded(split, len(data) - 1, device="cpu")
    assert exc.value.partial_output == data[:-1]
    assert P.decompress_to_vec_bounded(split, len(data), device="cpu") == data
    assert P.decompress_to_vec(split, device="cpu") == data
    assert device_route == ["cpu"] * 9


def test_device_route_errors_follow_the_python_oracle(device_route):
    """A decode error the batch decoder returns sends the stream to the
    Python state machine: the error class (and partial output) are the
    oracle's, and JAX's."""
    data = _text(20000, seed=3)
    z = zlib.compress(data, 6)
    cases = [z[:-3], z[:len(z) // 2], z[:-4] + b"\x00\x00\x00\x00",
             z[:2] + bytes([z[2] | 6]) + z[3:]]
    for i in (100, 700, len(z) - 9):
        bad = bytearray(z)
        bad[i] ^= 0x5A
        cases.append(bytes(bad))
    for stream in cases:
        got = _outcome(lambda: P.decompress_to_vec(stream, device="cpu"))
        assert got == _outcome(lambda: PD._decompress_to_vec_python(stream, None))
        assert got == _outcome(lambda: JD._decompress_to_vec_python(stream, None))
        assert got[0] == "err"
    assert len(device_route) == len(cases)


def test_device_route_full_size_equals_jax(monkeypatch):
    """test_decompress.py's no-native case at its size (the route's own
    threshold): the port's route on the CPU against JAX's."""
    monkeypatch.setattr(PN, "available", lambda: False)
    monkeypatch.setattr(JN, "available", lambda: False)
    rng = np.random.default_rng(21)
    base = np.tile(rng.integers(0, 256, 2048, dtype=np.uint8), 420)
    noise = rng.integers(0, base.size, base.size // 8)
    base[noise] = rng.integers(0, 256, noise.size, dtype=np.uint8)
    data = base.tobytes()
    z = zlib.compress(data, 6)
    assert len(z) >= PD._DEVICE_ROUTE_MIN
    calls = []
    batch = discovery.decompress_batch
    monkeypatch.setattr(discovery, "decompress_batch",
                        lambda s, **kw: calls.append(1) or batch(s, **kw))
    got = P.decompress_to_vec_bounded(z, None, device="cpu")
    assert got == F.decompress_to_vec_bounded(z, None) == data
    assert calls == [1]


def test_device_route_exceptions_propagate(device_route, monkeypatch):
    """Nothing catches a failure of the batch decoder or of a K4 launch in
    it (the plain K4 stands in for the kernel on the CPU), on the
    block-parallel and on the sequential route: no silent fall-through to
    the Python path."""
    from fdeflate_tpu_torch.ops import inflate_records as K4

    def boom(*a, **kw):
        raise RuntimeError("K4 launch failed")

    monkeypatch.setattr(K4, "inflate_records_plain", boom)
    small = zlib.compress(_text(20000), 6)
    large = zlib.compress(_text(300000, seed=5), 1)
    assert len(small) < discovery._PARALLEL_MIN <= len(large)
    for z in (small, large):
        with pytest.raises(RuntimeError, match="K4 launch failed"):
            P.decompress_to_vec(z, device="cpu")
    monkeypatch.setattr(discovery, "decompress_batch", boom)
    with pytest.raises(RuntimeError, match="K4 launch failed"):
        P.decompress_to_vec_bounded(small, 10, device="cpu")


def test_device_route_defaults_to_the_card(device_route, monkeypatch):
    """Without CUDA a call that leaves ``device`` and takes the route
    raises; below the threshold, or with FDEFLATE_TPU_NO_DEVICE=1, the
    Python path decodes and no device is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _text(20000)
    z = zlib.compress(data, 6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.decompress_to_vec(z)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.decompress_to_vec_bounded(z, 100)
    assert P.decompress_to_vec(zlib.compress(data[:200])) == data[:200]
    monkeypatch.setenv("FDEFLATE_TPU_NO_DEVICE", "1")
    assert P.decompress_to_vec(z) == data
    assert device_route == ["cuda", "cuda"]


# ------------------------------------------------------------ hypothesis

payloads = st.one_of(
    st.binary(max_size=3000),
    st.builds(
        lambda seed, n, alphabet: (
            np.random.default_rng(seed).integers(0, alphabet, n)
        ).astype(np.uint8).tobytes(),
        st.integers(0, 2**31), st.integers(0, 3000), st.integers(1, 256),
    ),
    st.builds(
        lambda parts: b"".join(parts),
        st.lists(st.one_of(st.binary(max_size=64),
                           st.integers(0, 600).map(lambda n: bytes(n))),
                 max_size=20),
    ),
)


@given(payloads, st.integers(0, 9), st.lists(st.integers(0, 2000), max_size=6))
@settings(max_examples=25, deadline=None)
def test_property_compressors_equal_jax(data, level, splits):
    got = PC._compress_to_vec_with_level_python(data, level)
    assert got == JC._compress_to_vec_with_level_python(data, level)
    got = _streamed(P.Compressor, data, splits, level=level)
    assert got == _streamed(F.Compressor, data, splits, level=level)
    got = _streamed(P.UltraFastCompressor, data, splits)
    assert got == _streamed(F.UltraFastCompressor, data, splits)
    assert zlib.decompress(got) == data


@given(st.one_of(st.binary(max_size=600),
                 payloads.map(lambda p: zlib.compress(p, 6))),
       st.lists(st.integers(1, 50), min_size=1, max_size=10))
@settings(max_examples=40, deadline=None)
def test_property_decompressor_equals_jax(data, chunks):
    assert _outcome(lambda: PD._decompress_to_vec_python(data, 1 << 20)) == \
        _outcome(lambda: JD._decompress_to_vec_python(data, 1 << 20))
    pattern = list(itertools.islice(itertools.cycle(chunks), 5000))
    assert _trace_pattern(P, data, pattern) == _trace_pattern(F, data, pattern)


def _trace_pattern(M, data, pattern):
    d = M.Decompressor()
    d.ignore_adler32()
    out = bytearray(1 << 20)
    ip = op = 0
    seq = []
    try:
        for step in pattern:
            if d.is_done() or ip >= len(data):
                break
            c, p = d.read(data[ip:ip + step], out, op)
            ip, op = ip + c, op + p
            seq.append((c, p))
    except M.DecompressionError as e:
        return seq, type(e).__name__
    return seq, bytes(out[:op]), d.is_done()


# -------------------------------------------------------------- examples


def _png(raw: bytes, width: int) -> bytes:
    """A greyscale PNG whose IDAT (zlib of ``raw``'s filtered scanlines) is
    split over two chunks, with an ancillary chunk between header and
    data."""
    from fdeflate_tpu_torch.examples.png_idat import write_chunk

    rows = len(raw) // width
    out = bytearray(b"\x89PNG\r\n\x1a\n")
    write_chunk(out, b"IHDR", width.to_bytes(4, "big") + rows.to_bytes(4, "big")
                + bytes([8, 0, 0, 0, 0]))
    write_chunk(out, b"tEXt", b"Comment\x00test")
    z = zlib.compress(raw, 9)
    write_chunk(out, b"IDAT", z[:100])
    write_chunk(out, b"IDAT", z[100:])
    write_chunk(out, b"IEND", b"")
    return bytes(out)


def test_png_idat_example_equals_jax(native_pair, tmp_path, capsys):
    """The port's example gives the bytes of ``examples/png_idat.py`` for the
    ultra-fast mode and a level; its command line writes the file."""
    import importlib.util

    from fdeflate_tpu_torch.examples import png_idat

    spec = importlib.util.spec_from_file_location(
        "jax_png_idat", pathlib.Path(__file__).parent.parent / "examples"
        / "png_idat.py")
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    width = 64
    raw = b"".join(b"\x01" + _alphabet(r, b"\x00\x00\x01\x02", width - 1)
                   for r in range(40))
    png = _png(raw, width)
    for mode in ("uf", "6"):
        got = png_idat.recompress(png, mode, device="cpu")
        assert got == jax_example.recompress(png, mode)
        chunks = list(png_idat.read_chunks(got))
        assert [c for c, _ in chunks] == [b"IHDR", b"tEXt", b"IDAT", b"IEND"]
        assert zlib.decompress(chunks[2][1]) == raw
    src, dst = tmp_path / "in.png", tmp_path / "out.png"
    src.write_bytes(png)
    png_idat.main([str(src), str(dst), "6", "--device", "cpu"])
    assert dst.read_bytes() == png_idat.recompress(png, "6", device="cpu")
    assert "(6)" in capsys.readouterr().out


def test_foreign_decode_example_on_the_cpu(tmp_path, capsys):
    from fdeflate_tpu_torch.examples import foreign_decode

    foreign_decode.demo(device="cpu", streams=2, size=6000)
    assert "decompress_to_vec: OK" in capsys.readouterr().out
    data = _text(5000)
    files = [tmp_path / "a.zz", tmp_path / "b.zz"]
    files[0].write_bytes(zlib.compress(data, 6))
    files[1].write_bytes(b"\x78\x9c\x00")
    foreign_decode.main([str(f) for f in files] + ["--device", "cpu"])
    assert (tmp_path / "a.zz.out").read_bytes() == data
    out = capsys.readouterr().out
    assert "b.zz: InsufficientInput" in out and not (tmp_path / "b.zz.out").exists()


# ------------------------------------------------------- utils/profiling


def test_profiling_trace_and_sync_on_the_cpu(tmp_path, monkeypatch):
    """``trace`` writes a Chrome trace of the region; ``sync`` waits only on
    CUDA tensors' devices, so CPU tensors and other objects ask nothing."""
    import json

    from fdeflate_tpu_torch.utils import profiling as PProf

    with PProf.trace(str(tmp_path / "t")) as prof:
        torch.arange(1000).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::sum" in names
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any(e.get("name") == "aten::sum" for e in events["traceEvents"])

    def fail(*a):
        raise AssertionError("synchronize called for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", fail)
    PProf.sync(torch.zeros(3), np.zeros(2), 5)
