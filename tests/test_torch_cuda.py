"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips unless CUDA is available.  This file
imports no JAX, so on a machine with a GPU and no JAX it runs without the
repository's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Kernel and plain version must agree bit for bit (integer outputs).
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.adler32 import adler32_batch, adler32_batch_plain
from fdeflate_tpu_torch.ops.adler32_pallas import (
    adler32_checksums,
    adler32_tiles,
    adler32_tiles_plain,
    fold_tiles,
)
from fdeflate_tpu_torch.ops.assign_pack import (
    assign_pack,
    assign_pack_plain,
    assign_tokens,
    wwin,
)
from fdeflate_tpu_torch.ops.decode2 import (
    canon_tables,
    decode2,
    decode2_canon,
    decode2_canon_plain,
    decode2_plain,
)
from fdeflate_tpu_torch.ops.decode_sep import (decode_sep, decode_sep_plain,
                                               decode_sep_plain_eob)
from fdeflate_tpu_torch.ops.decode_symbols import (_decode_symbols_live,
                                                   decode_symbols)
from fdeflate_tpu_torch.ops.header_tables import (
    DROPPED,
    LANE,
    header_tables,
    header_tables_plain,
)
from fdeflate_tpu_torch.ops.inflate import pad_words
from fdeflate_tpu_torch.ops.materialize_records import (
    materialize_records,
    materialize_records_plain,
)
from fdeflate_tpu_torch.ops.inflate_records import (
    NO_LIMIT,
    inflate_records,
    inflate_records_plain,
)
from fdeflate_tpu_torch.ops.pack import (
    encode_blocked_v1,
    pack_blocked,
    pack_blocked_plain,
    pack_tokens,
    token_offsets,
)
from fdeflate_tpu_torch.ops.repack import combine, combine_plain
from fdeflate_tpu_torch.ops.validate_headers import (
    validate_headers,
    validate_headers_plain,
)
from fdeflate_tpu_torch.parallel import discovery as PD
from fdeflate_tpu_torch.ops.ultrafast import (_encode, encode_ultrafast_batch,
                                              lane_starts, stream_words)
from fdeflate_tpu_torch.parallel import device_pipeline as DP
from fdeflate_tpu_torch.parallel.device_pipeline import fused_zlib_roundtrip
from fdeflate_tpu_torch.tools.edges import (K4_KINDS, K8_UNSAFE, K11_KINDS,
                                            corrupt_words, k1_edge_inputs,
                                            k1_long_lane, k2_edge_cases,
                                            k3_edge_cases, k4_edge_case,
                                            k5_cross_stream, k6_edge_cases,
                                            k12_edge_case,
                                            k8_unsafe_packed, k9_noise_tokens,
                                            k11_edge_case)
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.trees import sep_tables, trained_tables
from fdeflate_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# Ops a wrapper may dispatch besides its launch: allocations and views.
_NO_COMPUTE = {"aten.empty.memory_format", "aten.select.int",
               "aten.unsqueeze.default", "aten.view.default"}


def torch_ops(fn):
    """(fn's result, the names of the torch ops it dispatched)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    with Ops() as mode:
        out = fn()
    return out, mode.names


def _launches(name: str) -> int:
    return profiling.counts().get("launch." + name, 0)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda")


def _data(seed: int, B: int, N: int, lengths):
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((B, N)) < 0.55, 0,
                 rng.integers(-6, 7, (B, N))).astype(np.uint8)
    d[0, 100:3000] = 0                                   # long runs
    d[-1] = rng.integers(0, 256, N)                      # incompressible
    for b, n in enumerate(lengths):
        d[b, n:] = 0
    return d


GEOMETRIES = {
    "ragged_B3_N8192_C4": (3, 8192, 4, [8192, 8192 - 700, 9]),
    "lanes2048_B4_N65536_C512": (4, 65536, 512, [65536] * 4),
}


def _inputs(dev, name):
    B, N, C, lengths = GEOMETRIES[name]
    data = torch.from_numpy(_data(1, B, N, lengths)).to(dev)
    return data, torch.tensor(lengths, dtype=torch.int32, device=dev), C


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_assign_pack_matches_plain(dev, name):
    data, lengths, C = _inputs(dev, name)
    t = trained_tables(str(dev))
    before = _launches("assign_pack")
    got = assign_pack(data, lengths, C, t)
    assert _launches("assign_pack") == before + 1
    want = assign_pack_plain(data, lengths, C, t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


K1_EDGES = [e[0] for e in k1_edge_inputs()]


def _edge(dev, label):
    (_l, d, lens, C), = [e for e in k1_edge_inputs() + [k1_long_lane()]
                         if e[0] == label]
    return (torch.from_numpy(d).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), C)


@pytest.mark.parametrize("label", K1_EDGES + [k1_long_lane()[0]])
def test_assign_pack_edges(dev, label):
    """K1's warp at the edge geometries: runs on segment and tile edges,
    S = 8, ragged and empty lanes, all zeros, no runs, C = 1 at 1 MiB."""
    data, lengths, C = _edge(dev, label)
    t = trained_tables(str(dev))
    got = assign_pack(data, lengths, C, t)
    want = assign_pack_plain(data, lengths, C, t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("label", K1_EDGES)
def test_decode2_edges(dev, label):
    """K3's warp on the edge batches: clean, corrupted at 64 words per
    stream, an EOB in the middle of a lane, random chunk starts (wrong span
    hints), S = 4."""
    data, lengths, C = _edge(dev, label)
    for _case, words, starts, dtab, N, C, want in k3_edge_cases(data, lengths, C):
        before = _launches("decode2")
        got = decode2(words, starts, dtab, N, C)
        assert _launches("decode2") == before + 1
        exp = decode2_plain(words, starts, dtab, N, C)
        assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
        if want is not None:
            assert torch.equal(got[0], want)


@pytest.mark.parametrize("S", (64, 128, 256, 512, 1024, 2048))
def test_decode2_lane_groups(dev, S):
    """K3 with 32 / m lanes to a warp (m = 1..32 threads each, chosen from
    S), on ragged streams, clean and with corrupted words: the groups of a
    warp diverge and each must still equal the plain version."""
    B, N = 3, 1 << 16
    lengths = [N, N - 4000, 1234]
    data = torch.from_numpy(_data(2, B, N, lengths)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    C = N // S
    words, tb, _ad, starts, _eof = P.zlib_encode_step(C)(data, lens)
    t = trained_tables(str(dev))
    for w in (words, corrupt_words(words, tb, 64, seed=S)):
        got = decode2(w, starts, t.dtab, N, C)
        exp = decode2_plain(w, starts, t.dtab, N, C)
        assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    assert torch.equal(decode2(words, starts, t.dtab, N, C)[0], data)


def test_decode2_long_lanes(dev):
    """K3 with lanes of several tiles: C = 1 at 1 MiB (bytes and exit bit
    against the input and the encoder; the plain version loops once per
    symbol) and S = 8192 against the plain version, clean and corrupted."""
    data, lengths, C = _edge(dev, k1_long_lane()[0])
    words, tb, _ad, starts, eof = P.zlib_encode_step(C)(data, lengths)
    t = trained_tables(str(dev))
    out, bpos = decode2(words, starts, t.dtab, data.shape[1], C)
    assert torch.equal(out, data)
    assert int(bpos[0, 0]) == int(eof[0]) - int(starts[0, 0])
    data, lengths, C = _inputs(dev, "lanes2048_B4_N65536_C512")
    C = 8
    words, tb, _ad, starts, _eof = P.zlib_encode_step(C)(data, lengths)
    for w in (words, corrupt_words(words, tb, 64, seed=5)):
        got = decode2(w, starts, t.dtab, data.shape[1], C)
        exp = decode2_plain(w, starts, t.dtab, data.shape[1], C)
        assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


def test_decode2_adaptive_windows(dev):
    """K3 on an adaptive tree's lane windows, whose zero bits need not
    decode to a zero byte: clean and with corrupted words."""
    from fdeflate_tpu_torch.ops.adaptive import encode_adaptive_blocked

    data, lengths, C = _inputs(dev, "ragged_B3_N8192_C4")
    win, _cb, _ad, _lens, ta = encode_adaptive_blocked(data, lengths, C)
    S = data.shape[1] // C
    zero = torch.zeros(win.shape[0], 1, dtype=torch.int32, device=dev)
    bad = win.clone()
    bad[::3, 5] ^= 0x5A5A5A5A
    bad[1::2, -2] ^= 0x00F00F00
    for w in (win, bad):
        got = decode2(w, zero, ta.dtab, S, 1)
        exp = decode2_plain(w, zero, ta.dtab, S, 1)
        assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_combine_matches_plain(dev, name):
    data, lengths, C = _inputs(dev, name)
    t = trained_tables(str(dev))
    B, N = data.shape
    win, bits = assign_pack_plain(data, lengths, C, t)
    pos0 = lane_starts(bits, B, C, t.header_bits)[0].reshape(-1).to(torch.int32)
    W = stream_words(N, t)
    assert torch.equal(combine(win, bits, pos0, B, W),
                       combine_plain(win, bits, pos0, B, W))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode2_matches_plain(dev, name, corrupt):
    data, lengths, C = _inputs(dev, name)
    t = trained_tables(str(dev))
    B, N = data.shape
    words, _tb, _ad, starts, _eof = _encode(
        data, lengths, C, t, assign_pack_plain, combine_plain)
    if corrupt:
        words[0, 40] ^= 0x5A5A5A5A
    got = decode2(words, starts, t.dtab, N, C)
    want = decode2_plain(words, starts, t.dtab, N, C)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if not corrupt:
        assert torch.equal(got[0], data)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode2_canon_matches_plain(dev, name, corrupt):
    """K8 on K1's lane windows: bytes and exit bits equal its plain version
    and K3 on the same windows, no lane serial; with tables that break
    K3's protocol (``K8_UNSAFE``), equal to the plain version with every
    lane serial (stats[4])."""
    data, lengths, C = _inputs(dev, name)
    B, N = data.shape
    S = N // C
    win, _bits = assign_pack_plain(data, lengths, C, trained_tables(str(dev)))
    if corrupt:
        win[1, 3] ^= 0x5A5A5A5A
        win[-1, 0] ^= 0x7FFFFFFF
    meta, packed = canon_tables(str(dev))
    before = _launches("decode2_canon")
    stats = torch.zeros(5, dtype=torch.int64, device=dev)
    got = decode2_canon(win, S // 4, meta, packed, stats=stats)
    assert _launches("decode2_canon") == before + 1
    want = decode2_canon_plain(win, S // 4, meta, packed)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(stats[4]) == 0 and int(stats[1]) >= win.shape[0]
    starts = torch.zeros(win.shape[0], 1, dtype=torch.int32, device=dev)
    k3 = decode2(win, starts, trained_tables(str(dev)).dtab, S, 1)
    assert torch.equal(got[0], k3[0]) and torch.equal(got[1], k3[1].reshape(-1))
    if not corrupt:
        assert torch.equal(got[0].reshape(B, N), data)
    # Tables that break K3's protocol: every lane serial, counted.
    for kind in K8_UNSAFE:
        bad = k8_unsafe_packed(packed, kind)
        stats.zero_()
        before = _launches("decode2_canon")
        got = decode2_canon(win, S // 4, meta, bad, stats=stats)
        assert _launches("decode2_canon") == before + 1
        want = decode2_canon_plain(win, S // 4, meta, bad)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), kind
        assert int(stats[4]) == win.shape[0] and int(stats[1]) == 0, kind


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_pack_v1_matches_plain(dev, name):
    """K9 on the lanes' tokens (S <= 630) and on random token words (edge
    offsets, empty pairs), at window widths 1, wwin(S) and 300."""
    data, lengths, C = _inputs(dev, name)
    B, N = data.shape
    C = max(C, N // 512)
    S = N // C
    t = trained_tables(str(dev))
    v, nb, _ = assign_tokens(data, lengths, S, t)
    tok = pack_tokens(v, nb, token_offsets(nb, C), C)
    before = _launches("pack_v1")
    got = pack_blocked(tok, wwin(S))
    assert _launches("pack_v1") == before + 1
    assert torch.equal(got, pack_blocked_plain(tok, wwin(S)))
    assert torch.equal(got, assign_pack(data, lengths, C, t)[0])
    assert torch.equal(encode_blocked_v1(data, lengths, C, t)[0], got)
    noise = torch.randint(-2**31, 2**31 - 1, (64, S), dtype=torch.int32,
                          device=dev, generator=torch.Generator(dev).manual_seed(5))
    assert torch.equal(pack_blocked(noise, 40), pack_blocked_plain(noise, 40))
    noise = k9_noise_tokens(S, 64, 6).to(dev)
    for width in (1, wwin(S), 300):
        before = _launches("pack_v1")
        got = pack_blocked(noise, width)
        assert _launches("pack_v1") == before + 1
        assert torch.equal(got, pack_blocked_plain(noise, width)), width
        got = pack_blocked(tok, width)
        assert torch.equal(got, pack_blocked_plain(tok, width)), width


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("group", [2, 8, 32])
def test_combine_grouped_matches_plain(dev, name, group):
    """K10 equals K2 and the plain version, lanes crossing slab ends."""
    data, lengths, C = _inputs(dev, name)
    t = trained_tables(str(dev))
    B, N = data.shape
    win, bits = assign_pack_plain(data, lengths, C, t)
    pos0 = lane_starts(bits, B, C, 32037)[0].reshape(-1).to(torch.int32)
    W = 1024 + stream_words(N, t)
    before = _launches("combine_grouped")
    got = combine(win, bits, pos0, B, W, group=group)
    assert _launches("combine_grouped") == before + 1
    assert torch.equal(got, combine_plain(win, bits, pos0, B, W))
    assert torch.equal(got, combine(win, bits, pos0, B, W))
    got, ops = torch_ops(lambda: combine(win, bits, pos0, B, W, group=group))
    assert set(ops) <= _NO_COMPUTE, ops      # no torch search before K10
    assert torch.equal(got, combine_plain(win, bits, pos0, B, W))


@pytest.mark.parametrize("case", range(len(k2_edge_cases())))
@pytest.mark.parametrize("group", [2, 8, 32])
def test_combine_grouped_edges(dev, case, group):
    """K10 on K2's edge inputs (lanes of 0 bits, lanes shorter than a
    word, word-aligned starts, the last word's high half at W, trailing
    words, a mix): one launch, equal to K2 and the plain version."""
    label, win, bits, pos0, B, W = k2_edge_cases()[case]
    win, bits, pos0 = (x.to(dev) for x in (win, bits, pos0))
    before = _launches("combine_grouped")
    got = combine(win, bits, pos0, B, W, group=group)
    assert _launches("combine_grouped") == before + 1
    assert torch.equal(got, combine_plain(win, bits, pos0, B, W)), label
    assert torch.equal(got, combine(win, bits, pos0, B, W)), label


def test_v2_roundtrip_on_the_card(dev):
    data, lengths, C = _inputs(dev, "lanes2048_B4_N65536_C512")
    out, bpos_ok, ck_ok = P.fused_ultrafast_roundtrip_v2(
        C, data.shape[1], device=dev)(data, lengths)
    assert torch.equal(out, data)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())
    data, lengths, C = _inputs(dev, "ragged_B3_N8192_C4")
    out, bpos_ok, ck_ok = P.fused_ultrafast_roundtrip_v2(
        C, data.shape[1], device=dev)(data, lengths)
    assert torch.equal(out, data)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())


def test_fused_roundtrip_on_the_card(dev):
    data, lengths, C = _inputs(dev, "lanes2048_B4_N65536_C512")
    out, bpos_ok, ck_ok = fused_zlib_roundtrip(C, data.shape[1], device=dev)(
        data, lengths)
    assert torch.equal(out, data)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode_sep_matches_plain(dev, name, corrupt):
    """K6 on septree streams: every lane's bytes and exit bit, the ragged
    and empty lanes (which decode on past EOB) included."""
    data, lengths, C = _inputs(dev, name)
    B, N = data.shape
    tree = P.sep_profile()
    words, _tb, _ad, starts, _eof = P.zlib_encode_step(C, tree=tree)(
        data, lengths)
    if corrupt:
        words[0, 40] ^= 0x5A5A5A5A
    meta, vals = sep_tables(tree.lens, dev)
    before = _launches("decode_sep")
    got = decode_sep(words, starts, meta, vals, N, C)
    assert _launches("decode_sep") == before + 1
    want = decode_sep_plain(words, starts, meta, vals, N, C)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if not corrupt:
        assert torch.equal(got[0], data)


@pytest.mark.parametrize("label", K1_EDGES)
def test_decode_sep_edges(dev, label):
    """K6 (K3's group decode, EOB lanes serial) on the K1 edge batches
    encoded with the sep tree: clean, corrupted, an EOB at each sub-step
    position of a word and at lane, tile and last-symbol edges, random
    starts; the lanes decoded serially are exactly those whose decode meets
    an EOB, and none of the clean full streams'."""
    data, lengths, C = _edge(dev, label)
    tree = P.sep_profile()
    for case, words, starts, meta, vals, N, Ck, want in k6_edge_cases(
            data, lengths, C, tree):
        stats = torch.zeros(5, dtype=torch.int64, device=dev)
        before = _launches("decode_sep")
        got = decode_sep(words, starts, meta, vals, N, Ck, stats=stats)
        assert _launches("decode_sep") == before + 1
        exp_out, exp_bpos, eob = decode_sep_plain_eob(words, starts, meta,
                                                      vals, N, Ck)
        assert torch.equal(got[0], exp_out), case
        assert torch.equal(got[1], exp_bpos), case
        assert int(stats[4]) == int(eob.sum()), case
        if want is not None:
            assert torch.equal(got[0], want), case


def test_decode_sep_full_streams_stay_parallel(dev):
    """At 16 x 64 KiB, C = 32 (S = 2048, 32 threads a lane) no lane of the
    full streams is decoded serially."""
    data = torch.from_numpy(_data(4, 16, 1 << 16, [1 << 16] * 16)).to(dev)
    lengths = torch.full((16,), 1 << 16, dtype=torch.int32, device=dev)
    tree = P.sep_profile()
    words, _tb, _ad, starts, _eof = P.zlib_encode_step(32, tree=tree)(
        data, lengths)
    meta, vals = sep_tables(tree.lens, dev)
    stats = torch.zeros(5, dtype=torch.int64, device=dev)
    out, _bpos = decode_sep(words, starts, meta, vals, 1 << 16, 32, stats=stats)
    assert torch.equal(out, data)
    assert int(stats[4]) == 0 and int(stats[1]) >= 16 * 32


def test_sep_roundtrip_on_the_card(dev):
    data, lengths, C = _inputs(dev, "lanes2048_B4_N65536_C512")
    out, bpos_ok, ck_ok = fused_zlib_roundtrip(
        C, data.shape[1], tree=P.sep_profile(), device=dev)(data, lengths)
    assert torch.equal(out, data)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())


def test_adaptive_roundtrip_on_the_card(dev):
    """The tree is built on the card; the roundtrip and its payload bits
    equal the CPU path's."""
    data, lengths, C = _inputs(dev, "lanes2048_B4_N65536_C512")
    N = data.shape[1]
    out, bpos_ok, ck_ok, total = P.fused_adaptive_roundtrip(
        C, N, device=dev)(data, lengths)
    assert torch.equal(out, data)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())
    _o, _b, _c, cpu_total = P.fused_adaptive_roundtrip(C, N, device="cpu")(
        data.cpu(), lengths.cpu())
    assert int(total) == int(cpu_total)


@pytest.mark.parametrize("n,length,offset", [
    (1, None, 0), (1023, None, 0), (4097, 3001, 0), (200001, None, 3),
    ((1 << 20) + 5, (1 << 19) + 7, 1)])
def test_adler32_tiles_matches_plain(dev, n, length, offset):
    host = np.random.default_rng(n).integers(0, 256, n + offset, np.uint8)
    x = torch.from_numpy(host).to(dev)[offset:]
    ln = n if length is None else length
    lt = torch.tensor([ln], dtype=torch.int64, device=dev)
    before = _launches("adler32_tiles")
    got = adler32_tiles(x, lt)
    assert _launches("adler32_tiles") == before + 1
    want = adler32_tiles_plain(x, lt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want_ck = zlib.adler32(host[offset : offset + ln].tobytes())
    assert int(P.adler32_pallas(x, length)) == want_ck


def _k7_rows(dev, B, n, stride, off, seed):
    """u8[B, n] rows at ``stride`` bytes from ``off`` in a noisy buffer."""
    host = np.random.default_rng(seed).integers(
        0, 256, B * stride + off + 64, np.uint8)
    buf = torch.from_numpy(host).to(dev)
    return buf[off:off + B * stride].reshape(B, stride)[:, :n]


K7_BATCHES = {
    "ragged 0, 1, 1023, 1025, n, unaligned rows": (
        6, 5000, 5007, 3, [0, 1, 1023, 1025, 5000, 77]),
    "16 x 1 MiB": (16, 1 << 20, 1 << 20, 0, [1 << 20] * 15 + [12345]),
    "64 MiB, one unaligned row": (1, 64 << 20, 64 << 20, 5, [(64 << 20) - 9]),
    "many short rows": (300, 40, 41, 1, list(range(0, 41)) * 7 + [40] * 13),
}


@pytest.mark.parametrize("case", sorted(K7_BATCHES))
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_adler32_checksums_matches_plain(dev, case, dtype):
    """K7 on a batch: one launch, tile sums equal to the plain version's,
    checksums to the plain fold, the plain batch and zlib.adler32."""
    B, n, stride, off, lens = K7_BATCHES[case]
    rows = _k7_rows(dev, B, n, stride, off, n + B)
    lengths = torch.tensor(lens, dtype=dtype, device=dev)
    T = -(-n // 1024)
    sums = torch.empty(B, T, dtype=torch.int32, device=dev)
    wsums = torch.empty(B, T, dtype=torch.int32, device=dev)
    before = _launches("adler32_tiles")
    got = adler32_checksums(rows, lengths, sums, wsums)
    assert _launches("adler32_tiles") == before + 1
    want_s, want_w = adler32_tiles_plain(rows, lengths)
    assert torch.equal(sums, want_s) and torch.equal(wsums, want_w)
    assert torch.equal(got, fold_tiles(want_s, want_w, lengths))
    assert torch.equal(got, adler32_batch_plain(rows, lengths))
    assert torch.equal(adler32_checksums(rows, lengths), got)
    host = rows.cpu().numpy()
    for b, ln in enumerate(lens):
        assert int(got[b]) == zlib.adler32(host[b, :ln].tobytes())


def test_adler32_batch_is_one_k7_launch(dev):
    """``adler32_batch`` on CUDA tensors launches K7 once and runs no torch
    op besides allocations; the encode launches it once."""
    data, lengths, C = _inputs(dev, "ragged_B3_N8192_C4")
    adler32_batch(data, lengths)                  # the workspace, once
    before = _launches("adler32_tiles")
    got, ops = torch_ops(lambda: adler32_batch(data, lengths))
    assert _launches("adler32_tiles") == before + 1
    assert set(ops) <= _NO_COMPUTE, ops
    assert torch.equal(got, adler32_batch_plain(data, lengths))
    before = _launches("adler32_tiles")
    P.zlib_encode_step(C)(data, lengths)
    assert _launches("adler32_tiles") == before + 1


def _foreign(seed: int, n: int = 200_000) -> bytes:
    rng = np.random.default_rng(seed)
    wp = [rng.bytes(int(rng.integers(2, 12))) for _ in range(200)]
    return b"".join(wp[int(rng.integers(200))] for _ in range(n // 6))[:n]


def _lanes(z: bytes, dev, corrupt: bool):
    """Every discovered block of ``z`` as a K4 lane (corrupted: one byte of
    the payload flipped after the tables were parsed)."""
    words = PD.stage_words(z, device=dev)
    lanes = PD._parse_lanes(
        z, PD.find_block_boundaries(z, words, device=dev)[0])[0]
    from fdeflate_tpu_torch.ops.inflate_host import foreign_meta
    from fdeflate_tpu_torch.ops.inflate_records import pack_tables

    meta, tab = pack_tables([foreign_meta(l[3][: l[4]], l[3][288:320])
                             for l in lanes], dev)
    if corrupt:
        words = words.clone()
        words[words.numel() // 2] ^= 0x00F0F0F0
    L = len(lanes)
    start = torch.tensor([l[2] for l in lanes], dtype=torch.int64, device=dev)
    full = lambda v: torch.full((L,), v, dtype=torch.int64, device=dev)  # noqa: E731
    return words, start, full(words.numel()), full(NO_LIMIT), full(NO_LIMIT), meta, tab


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("K", [64, 8192])
def test_inflate_records_matches_plain(dev, corrupt, K):
    args = _lanes(zlib.compress(_foreign(1), 6), dev, corrupt)
    before = _launches("inflate_records")
    got = inflate_records(*args, K)
    assert _launches("inflate_records") == before + 1
    want = inflate_records_plain(*args, K)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_validate_headers_matches_plain(dev):
    z = zlib.compress(_foreign(2), 6)
    words = PD.stage_words(z, device=dev)
    rng = np.random.default_rng(3)
    cands = np.unique(np.concatenate([
        PD.scan_stage1_device(z, device=dev),
        rng.integers(0, len(z) * 8 - 80, 20000)]))
    c = torch.from_numpy(cands.astype(np.int64)).to(dev)
    before = _launches("validate_headers")
    good, end = validate_headers(words, c, len(z) * 8)
    assert _launches("validate_headers") == before + 1
    want_good, want_end = validate_headers_plain(words, c, len(z) * 8)
    assert torch.equal(good, want_good) and torch.equal(end, want_end)
    assert bool(good.any())


def test_validate_headers_two_streams(dev):
    """K5 over two streams' words at once, each candidate bounded by its
    own stream (``edges.k5_cross_stream``): equal to the plain version and,
    stream by stream, to each stream alone."""
    a = zlib.compress(_foreign(5, 60_000), 6)
    b = np.random.default_rng(6).integers(1, 256, 4000, np.uint8).tobytes()
    words, c, wend, nb, parts = k5_cross_stream(a, b)
    words, c, wend, nb = (x.to(dev) for x in (words, c, wend, nb))
    good, end = validate_headers(words, c, nb, wend=wend)
    want = validate_headers_plain(words, c, nb, wend=wend)
    assert torch.equal(good, want[0]) and torch.equal(end, want[1])
    for lo, hi, z, cs, b0 in parts:
        g, e = validate_headers(PD.stage_words(z, device=dev),
                                torch.from_numpy(cs).to(dev), len(z) * 8)
        assert torch.equal(good[lo:hi], g) and torch.equal(end[lo:hi] - b0, e)


def test_try_foreign_batch_launches_k5_once(dev):
    data = [_foreign(s, 80_000) for s in range(3)]
    streams = [zlib.compress(d, 6) for d in data]
    before = _launches("validate_headers")
    assert P.try_foreign_batch(streams, device=dev) == data
    assert _launches("validate_headers") == before + 1


def test_foreign_path_on_the_card(dev):
    data = [_foreign(s, 120_000) for s in range(3)]
    streams = [zlib.compress(d, lvl) for d, lvl in zip(data, (1, 6, 9))]
    assert P.try_foreign(streams[1], device=dev) == data[1]
    assert P.try_foreign_batch(streams, device=dev) == data
    out = P.decompress_batch(streams + [zlib.compress(b"abc" * 99, 0),
                                        streams[0][:500]], device=dev)
    assert out[:3] == data and out[3] == b"abc" * 99
    assert type(out[4]).__name__ == "InsufficientInput"


def test_try_foreign_batch_of_16_cuda_equals_cpu(dev):
    """16 streams stitched together (``discovery._stitch``'s flat record
    starts over many rows) give on the card what they give on the CPU."""
    data = [_foreign(s, 30_000) for s in range(16)]
    streams = [zlib.compress(d, (1, 6, 9)[s % 3]) for s, d in enumerate(data)]
    got = P.try_foreign_batch(streams, device=dev)
    assert got == P.try_foreign_batch(streams, device="cpu")
    assert got == data


def _k12_equals_plain(dev, words, offs, wend, bit_end):
    """K12 on the card, one launch, equal to the plain version (run on the
    CPU) in all its outputs; returns the statuses."""
    before = _launches("header_tables")
    got = header_tables(*(x.to(dev) for x in (words, offs, wend, bit_end)))
    assert _launches("header_tables") == before + 1
    want = header_tables_plain(*(x.cpu() for x in (words, offs, wend, bit_end)))
    for name, g, w in zip(("info", "meta", "tab"), got, want):
        assert torch.equal(g.cpu(), w), name
    return got[0][0].cpu()


@pytest.mark.parametrize("source", ["text", "idat"])
def test_header_tables_at_every_bit(dev, source):
    """K12 at every bit offset of the first 4096 bits of a zlib-6 stream
    (most not a header: skipped), and again with the stream ending 600
    bits after each offset (parses cut short)."""
    raw = (_foreign(7, 100_000) if source == "text"
           else make_idat_corpus(1, 1 << 17, 8)[0].tobytes())
    z = zlib.compress(raw, 6)
    words = PD.stage_words(z, device="cpu")
    c = torch.arange(4096, dtype=torch.int64)
    wend = torch.full((4096,), words.numel(), dtype=torch.int64)
    status = [_k12_equals_plain(dev, words, c, wend, end) for end in (
        torch.full((4096,), len(z) * 8, dtype=torch.int64), c + 600)]
    assert {LANE, 1} <= set(status[0].tolist())


def test_header_tables_on_a_batchs_validated_headers(dev):
    """K12 on every K5-good header of bench.py's images 16-31 at zlib 6
    (16 x 1 MiB, image 20's false header among them), each bounded by its
    own stream over the concatenated words."""
    raw = [r.tobytes() for r in make_idat_corpus(32, 1 << 20, 0)[16:]]
    streams = [zlib.compress(r, 6) for r in raw]
    words_np, base = pad_words(streams)
    words = torch.from_numpy(words_np).to(dev)
    survivors = {si: PD.scan_stage1_device(
        z, device=dev, words=words[base[si]:base[si + 1]])
        for si, z in enumerate(streams)}
    valid = PD.validate_stage2_batch(streams, survivors, words, base)
    cols = PD.stage2_batch_inputs(
        streams, {si: v[0] for si, v in valid.items()}, base)
    status = _k12_equals_plain(dev, torch.from_numpy(words_np),
                               *torch.from_numpy(cols))
    assert (status == DROPPED).sum() >= 1 and (status == LANE).sum() > 100


def test_header_tables_on_crafted_headers(dev):
    """K12 on ``edges.k12_edge_case``: each crafted header's status (a
    lane with no, one and two distance codes and with runs; skipped for
    BTYPE, HLIT, HDIST, the code-length code, a leading 16, a repeat past
    the end, no end-of-block code, truncation; dropped for an incomplete
    literal/length code), equal to the plain version."""
    words, offs, wend, bit_end, labels, want, _lengths = k12_edge_case()
    status = _k12_equals_plain(dev, words, offs, wend, bit_end)
    assert status.tolist() == want, labels


def test_lane_layout_launches_header_tables_once(dev):
    """One K12 launch per ``lane_layout`` call: ``try_foreign`` and
    ``try_foreign_batch`` on the card."""
    data = [_foreign(s, 60_000) for s in range(3)]
    streams = [zlib.compress(d, 6) for d in data]
    before = _launches("header_tables")
    assert P.try_foreign(streams[0], device=dev) == data[0]
    assert _launches("header_tables") == before + 1
    assert P.try_foreign_batch(streams, device=dev) == data
    assert _launches("header_tables") == before + 2


def test_try_foreign_batch_counts_equal_cpu(dev):
    """Small streams (a false header past one stream's trailer, a stored
    stream, a bad zlib header among them) through ``try_foreign_batch`` on
    the card and on the CPU: zlib's bytes where discovery keeps the stream,
    and the same discovery counters."""
    def blocks(d, step):   # a block ended every ``step`` bytes
        co = zlib.compressobj(6)
        return b"".join(co.compress(d[i:i + step]) + (
            co.flush(zlib.Z_BLOCK) if i + step < len(d) else b"")
            for i in range(0, len(d), step)) + co.flush()

    image20 = zlib.compress(make_idat_corpus(21, 1 << 20, 0)[20], 6)
    rng = np.random.default_rng(9)
    data = [np.where(rng.integers(0, 4, 3000) > 0, rng.integers(-8, 8, 3000),
                     0).astype(np.uint8).tobytes() for _ in range(3)]
    good = [blocks(d, 1000) for d in data]
    streams = [good[0], good[1] + image20[1302677 // 8:][:120], good[2],
               zlib.compress(b"stored" * 99, 0), b"\x00\x01" + good[0][2:]]
    runs = []
    for device in (dev, "cpu"):
        before = profiling.counts()
        got = P.try_foreign_batch(streams, max_steps=256, device=device)
        n = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
             if k.startswith("discovery.") and v != before.get(k, 0)}
        runs.append((got, n))
    assert runs[0] == runs[1]
    assert runs[0][0] == data + [None, None]
    assert runs[0][1]["discovery.lanes_dropped"] == 1


@pytest.mark.parametrize("case", range(len(k2_edge_cases())))
def test_combine_edges(dev, case):
    """K2 on its edge inputs (lanes of 0 bits, lanes shorter than a word,
    word-aligned starts, the last word's high half at W, trailing words, a
    mix): every word written, equal to the plain version, one launch."""
    label, win, bits, pos0, B, W = k2_edge_cases()[case]
    win, bits, pos0 = (x.to(dev) for x in (win, bits, pos0))
    before = _launches("combine")
    got = combine(win, bits, pos0, B, W)
    assert _launches("combine") == before + 1
    assert torch.equal(got, combine_plain(win, bits, pos0, B, W)), label


@pytest.mark.parametrize("kind", K4_KINDS)
def test_inflate_records_edges(dev, kind):
    """K4 on its edge inputs (tools/edges.py: blocks at levels 1, 6, 9,
    IDAT and Huffman-only, false candidates, corrupted words, too few
    slots, too far, bit_end inside blocks, random starts) against the plain
    version, which runs on the CPU (it loops once per record step)."""
    args, K = k4_edge_case(kind)
    want = inflate_records_plain(*args, K)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    before = _launches("inflate_records")
    got = inflate_records(*(x.to(dev) for x in args), K, stats=stats)
    assert _launches("inflate_records") == before + 1
    for name, g, w in zip(("recs", "bpos", "nout", "done"), got, want):
        assert torch.equal(g.cpu(), w), (kind, name)
    assert int(stats[1]) >= args[1].numel()       # a span per lane at least


def _flat(res):
    """``decode_symbols``' (records, state) as one tuple."""
    return tuple(res[0]) + tuple(res[1])


def _on(case: dict, dev) -> dict:
    """``decode_symbols`` keywords with their tensors on ``dev`` (numpy
    tables stay numpy: the wrapper moves them)."""
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in case.items()}


def _same_records(got, want, label):
    for i, (g, w) in enumerate(zip(got[0] + got[1], want[0] + want[1])):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), (label, i)


@pytest.mark.parametrize("kind", K11_KINDS)
def test_decode_symbols_edges(dev, kind):
    """K11 on its edge inputs (tools/edges.py: codes of up to 15 bits,
    truncation, reads past the last word, corrupted fixed-code streams,
    invalid entries, stacked tables and stream_row, exhausted steps), one
    launch, against the plain version on the CPU."""
    case = k11_edge_case(kind)
    want = decode_symbols(**case)
    before = _launches("decode_symbols")
    got = decode_symbols(**_on(case, dev))
    assert _launches("decode_symbols") == before + 1
    _same_records(got, want, kind)


def _indexed_case(dev, B=4, N=65536, C=64):
    """The chunk lanes of an IDAT-like batch, encoded on ``dev``."""
    data = torch.from_numpy(_data(3, B, N, [N] * B)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    words, total_bits, _adler, index = encode_ultrafast_batch(
        data, lengths, num_chunks=C)
    starts, bits_l, stops, srow, active = DP.chunk_lanes(total_bits, index)
    t = DP.trained_symbol_tables(str(dev))
    return data, lengths, dict(
        words=words, bit_pos=starts, bit_end=bits_l,
        out_pos=torch.full_like(starts, 1 << 30), active=active,
        table_id=torch.zeros_like(starts), litlen=t[0], litlen_sec=t[1],
        dist=t[2], dist_sec=t[3], bit_stop=stops, stream_row=srow,
        litlen_first=t[4], max_steps=2048)


@pytest.mark.parametrize("chain", [1, 2, 4])
def test_decode_symbols_indexed_matches_plain(dev, chain):
    _data_, _lengths, case = _indexed_case(dev)
    got = decode_symbols(**case, chain=chain)
    want = decode_symbols(**_on(case, "cpu"), chain=chain)
    _same_records(got, want, f"chain {chain}")


def _same_live(got, want, label):
    """K11's live form against the plain (full) records: each lane's rows
    below its step count, the count (the rows with a position) and the
    state."""
    records, state, steps = got
    ran = want[0][5] >= 0
    assert torch.equal(steps.cpu(), ran.sum(0, dtype=torch.int32)), label
    live = (torch.arange(ran.shape[0])[:, None]
            < steps.cpu()[None, :].to(torch.int64))
    for i, (g, w) in enumerate(zip(records, want[0])):
        assert g.dtype == w.dtype and torch.equal(g.cpu()[live], w[live]), (
            label, i)
    for i, (g, w) in enumerate(zip(state, want[1])):
        assert torch.equal(g.cpu(), w), (label, "state", i)


@pytest.mark.parametrize("kind", K11_KINDS)
def test_decode_symbols_live_edges(dev, kind):
    """K11's live form on its edge inputs, one launch, against plain."""
    case = k11_edge_case(kind)
    want = decode_symbols(**case)
    before = _launches("decode_symbols")
    got = _decode_symbols_live(**_on(case, dev))
    assert _launches("decode_symbols") == before + 1
    _same_live(got, want, kind)


@pytest.mark.parametrize("chain", [1, 2, 4])
def test_decode_symbols_live_indexed_matches_plain(dev, chain):
    _data_, _lengths, case = _indexed_case(dev)
    got = _decode_symbols_live(**case, chain=chain)
    want = decode_symbols(**_on(case, "cpu"), chain=chain)
    _same_live(got, want, f"live, chain {chain}")


def test_fused_ultrafast_roundtrip_cuda_equals_cpu(dev):
    data, lengths, _case = _indexed_case(dev, N=32768, C=8)
    N = data.shape[1]
    before = _launches("decode_symbols")
    got = P.fused_ultrafast_roundtrip(8, 8192, N)(data, lengths)
    assert _launches("decode_symbols") == before + 1
    want = P.fused_ultrafast_roundtrip(8, 8192, N, device="cpu")(
        data.cpu(), lengths.cpu())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(got[2].all()) and bool(got[3].all())
    assert torch.equal(got[0], data)


def test_decompress_batch_indexed_cuda_equals_cpu(dev):
    rng = np.random.default_rng(123)
    datas = [rng.choice([0] * 7 + [40, 90], 60_000).astype(np.uint8).tobytes(),
             bytes(200_000),
             rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
             b"small", b""]
    streams, index = P.compress_batch_ultra_fast(datas, with_index=8)
    before = profiling.counts().get("indexed.fallback", 0)
    got = P.decompress_batch_indexed(streams, index)
    assert got == datas == P.decompress_batch_indexed(streams, index,
                                                      device="cpu")
    assert profiling.counts().get("indexed.fallback", 0) == before



@pytest.mark.parametrize("level", [1, 3])
def test_compress_batch_device_cuda_equals_cpu(dev, level):
    """The matched encoder on the card: the CPU twin's bytes, every stream
    through zlib, K7 launched once for the batch's Adler-32."""
    rng = np.random.default_rng(124)
    datas = [rng.choice([0] * 7 + [40, 90], 60_000).astype(np.uint8).tobytes(),
             bytes(70_000), rng.integers(0, 256, 20_000,
                                         dtype=np.uint8).tobytes(),
             b"the quick brown fox " * 900, b"x", b""]
    before = _launches("adler32_tiles")
    got = P.compress_batch_device(datas, level)
    assert _launches("adler32_tiles") == before + 1
    assert got == P.compress_batch_device(datas, level, device="cpu")
    assert [zlib.decompress(o) for o in got] == datas

def _split_blocks(data: bytes, level: int, step: int) -> bytes:
    """zlib stream whose blocks end every ``step`` input bytes (the plain K4
    of the ``device="cpu"`` runs costs a loop iteration per record)."""
    co = zlib.compressobj(level)
    out = b"".join(co.compress(data[i:i + step])
                   + (co.flush(zlib.Z_BLOCK) if i + step < len(data) else b"")
                   for i in range(0, len(data), step))
    return out + co.flush()


def test_host_api_device_route_cuda_equals_cpu(dev, monkeypatch):
    """``decompress_to_vec_bounded``'s route to the card (native off, the
    threshold cut so that a 240 kB stream takes it): the bytes of its
    ``device="cpu"`` run, ``OutputTooLarge`` with the first 4096 bytes,
    and the Python oracle's error class, with K4, K5 and K7 launched."""
    from fdeflate_tpu_torch.models import decompressor as MD
    from fdeflate_tpu_torch.models import native as MN

    monkeypatch.setattr(MN, "available", lambda: False)
    monkeypatch.setattr(MD, "_DEVICE_ROUTE_MIN", 1024)
    data = _foreign(3, 240_000)
    z = _split_blocks(data, 6, 20_000)
    assert len(z) >= PD._PARALLEL_MIN
    kernels = ("inflate_records", "validate_headers", "adler32_tiles")
    before = [_launches(k) for k in kernels]
    assert P.decompress_to_vec(z) == data
    assert all(_launches(k) > b for k, b in zip(kernels, before))
    assert P.decompress_to_vec(z, device="cpu") == data
    with pytest.raises(P.OutputTooLarge) as got:
        P.decompress_to_vec_bounded(z, 4096)
    assert got.value.partial_output == data[:4096]
    bad = bytearray(z)
    bad[len(z) // 2] ^= 0x5A
    outcome = []
    for fn in (lambda: P.decompress_to_vec(bytes(bad)),
               lambda: MD._decompress_to_vec_python(bytes(bad), None)):
        try:
            outcome.append(fn())
        except P.DecompressionError as e:
            outcome.append(type(e).__name__)
    assert outcome[0] == outcome[1] == "WrongChecksum"


def test_try_foreign_host_materialize_on_the_card(dev):
    """``materialize="host"``: K4's records from the card expanded by the
    native backend equal zlib's bytes and the device stitch's."""
    from fdeflate_tpu_torch.models import native as MN

    assert MN.available(), MN.unavailable_reason()
    data = _foreign(4, 200_000)
    z = zlib.compress(data, 6)
    before = _launches("inflate_records")
    assert P.try_foreign(z, materialize="host") == data
    assert _launches("inflate_records") > before
    assert P.try_foreign(z, materialize="device") == data


def test_traced_batch_puts_k4_inside_its_span(dev, tmp_path):
    """``try_foreign_batch`` on three 1 MiB streams under
    ``profiling.trace``: every ``inflate_kernel`` interval on the device
    lies inside a ``discovery.records`` span on the host, no device
    operation of ``portbench.trace.timelines`` bears a span's name, the
    counters count the call, and the bytes are zlib's."""
    from portbench import trace as PT


    raw = [r.tobytes() for r in make_idat_corpus(3, 1 << 20, seed=5)]
    streams = [zlib.compress(r, 6) for r in raw]
    assert P.try_foreign_batch(streams) == raw           # built and warm
    before = profiling.counts()
    with profiling.trace(str(tmp_path)) as prof:
        got = P.try_foreign_batch(streams)
    assert got == raw
    device, host = PT.timelines(prof)
    spans = {n for n, _s, _t in host if n.startswith(("discovery.",
                                                       "inflate."))}
    assert {"discovery.stage1", "discovery.validate", "discovery.parse",
            "discovery.tables", "discovery.records", "discovery.chain",
            "discovery.stitch"} <= spans
    assert not {n for n, _s, _t in device} & spans
    records = [(s, t) for n, s, t in host if n == "discovery.records"]
    k4 = [(s, t) for n, s, t in device if "inflate_kernel" in n]
    assert len(records) == len(k4) == 1
    slack = 50e-6   # the profiler's host and device clocks, aligned
    assert all(any(rs - slack <= s and t <= rt + slack for rs, rt in records)
               for s, t in k4)
    n = {k: v - before.get(k, 0) for k, v in profiling.counts().items()}
    assert n["discovery.streams"] == 3 and n["launch.inflate_records"] == 1
    assert n["launch.validate_headers"] == 1
    assert n["discovery.lanes"] >= n["discovery.lanes_chained"] > 3
    assert not any(v for k, v in n.items()
                   if k.startswith("discovery.fallback."))


def test_a_false_header_costs_no_stream_of_the_batch(dev):
    """bench.py's images 16-31 at zlib 6 through ``decompress_batch``: K5
    takes a false header of image 20 whose trees cannot be built; that
    header is dropped, and every stream decodes by block discovery."""

    raw = [r.tobytes() for r in make_idat_corpus(32, 1 << 20, 0)[16:]]
    streams = [zlib.compress(r, 6) for r in raw]
    before = profiling.counts()
    got = P.decompress_batch(streams, device=dev)
    assert got == [zlib.decompress(z) for z in streams]
    n = {k: v - before.get(k, 0) for k, v in profiling.counts().items()}
    assert not any(v for k, v in n.items()
                   if k.startswith("discovery.fallback."))
    assert n["discovery.lanes_dropped"] >= 1
    assert n["discovery.streams"] == 16


def test_a_batch_of_256_thumbnails_on_the_card_equals_zlib(dev):
    """The thumbnail cell's call: 256 128 x 128 RGB images with real PNG
    rows at zlib 6, every stream under block discovery's threshold, so
    the sequential path decodes them all, one K4 launch per round."""
    from portbench.thumbnails import make_rgb_thumbnails

    streams = [zlib.compress(r.tobytes(), 6)
               for r in make_rgb_thumbnails(256, seed=4)]
    before = profiling.counts()
    got = P.decompress_batch(streams, device=dev)
    assert got == [zlib.decompress(z) for z in streams]
    n = {k: v - before.get(k, 0) for k, v in profiling.counts().items()}
    assert n.get("discovery.streams", 0) == 0
    assert n["sequential.streams"] == 256
    assert n["sequential.blocks.dynamic"] >= 512
    assert n["launch.inflate_records"] == n["sequential.launches"] >= 2
    assert n["launch.materialize_records"] == n["sequential.launches"]


def test_fast_mode_streams_without_their_index_leave_discovery_by_budget(
        dev, monkeypatch):
    """The index-less fast-mode cell's route: 1 MiB single-block
    ``compress_batch_ultra_fast`` streams through ``decompress_batch``;
    discovery gives each up at its first lane, out of record slots, and the
    sequential path decodes all of it in rounds of one lane a stream
    (``sequential.lanes``: each launch's lanes, seen at K4's call)."""
    from fdeflate_tpu_torch.ops import inflate as PI

    raw = [r.tobytes() for r in make_idat_corpus(3, 1 << 20, seed=27)]
    streams = P.compress_batch_ultra_fast(raw, device=dev)
    assert all(z[2] & 7 == 0b101 for z in streams)
    lanes = []
    launch = PI.inflate_records

    def counted(words, start, *rest):
        lanes.append(start.numel())
        return launch(words, start, *rest)

    monkeypatch.setattr(PI, "inflate_records", counted)
    before = profiling.counts()
    assert P.decompress_batch(streams, device=dev) == raw
    n = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
         if v != before.get(k, 0)}
    assert {k: v for k, v in n.items()
            if k.startswith("discovery.fallback.")} == {
        "discovery.fallback.budget": 3}
    assert n["sequential.streams"] == 3
    assert n["sequential.launches"] == len(lanes) >= 30
    assert n["sequential.lanes"] == sum(lanes)
    assert n["launch.inflate_records"] == n["sequential.launches"] + 1
    assert n["launch.materialize_records"] == n["sequential.launches"]


def _held_materialize(monkeypatch, dev):
    """Hold every K13 launch of the sequential path to its plain version on
    the same arguments (on the card), out and new window alike.  Returns
    the list of (lanes, cap) of the launches held."""
    from fdeflate_tpu_torch.ops import inflate as PI

    held = []

    def both(recs, window, produced, cap):
        before = _launches("materialize_records")
        got = materialize_records(recs, window, produced, cap)
        assert _launches("materialize_records") == before + 1
        assert {x.device.type for x in (recs, window, produced)} == {dev.type}
        want = materialize_records_plain(recs, window, produced, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        held.append((recs.shape[1], cap))
        return got

    monkeypatch.setattr(PI, "materialize_records", both)
    return held


def test_materialize_records_on_the_thumbnail_rounds(dev, monkeypatch):
    """K13 equals its plain version on every round of the thumbnail cell's
    call: 256 lanes of K4 records, the first rounds at cap 32768."""
    from fdeflate_tpu_torch.ops.inflate import decompress_sequential
    from portbench.thumbnails import make_rgb_thumbnails

    held = _held_materialize(monkeypatch, dev)
    images = [r.tobytes() for r in make_rgb_thumbnails(256, seed=28)]
    streams = [zlib.compress(im, 6) for im in images]
    assert decompress_sequential(streams, device=dev) == images
    assert len(held) >= 2 and held[0][0] == 256
    assert max(cap for _l, cap in held) >= 32768


def test_materialize_records_on_every_round_of_a_fast_mode_stream(
        dev, monkeypatch):
    """A 1 MiB single-block fast-mode stream through the sequential path:
    K13 equals its plain version in every round, the window carried on the
    card from one round to the next (uploaded from the host once)."""
    from fdeflate_tpu_torch.ops.inflate import decompress_sequential

    raw = make_idat_corpus(1, 1 << 20, seed=28)[0].tobytes()
    (z,) = P.compress_batch_ultra_fast([raw], device=dev)
    held = _held_materialize(monkeypatch, dev)
    before = profiling.counts()
    assert decompress_sequential([z], device=dev) == [raw]
    n = {k: v - before.get(k, 0) for k, v in profiling.counts().items()}
    assert len(held) == n["sequential.launches"] >= 30
    assert n["sequential.window_host"] == 1


def test_materialize_records_on_the_bad_header_streams(dev, monkeypatch):
    """``edges.bad_header_streams`` beside good streams: every K13 launch
    equals its plain version, failed lanes (produced 0) included, and the
    answers are the CPU's."""
    from fdeflate_tpu_torch.ops.inflate import decompress_sequential
    from fdeflate_tpu_torch.tools.edges import bad_header_streams
    from portbench.thumbnails import make_rgb_thumbnails

    images = [r.tobytes() for r in make_rgb_thumbnails(8, 32, 32, 28)]
    bad = bad_header_streams(images[0][:400])
    streams = [zlib.compress(im, 6) for im in images]
    streams += [z for z, _cls in bad.values()]
    want = decompress_sequential(streams, device="cpu")
    held = _held_materialize(monkeypatch, dev)
    got = decompress_sequential(streams, device=dev)
    assert got[:8] == want[:8] == images
    assert [type(g).__name__ for g in got[8:]] == [
        type(w).__name__ for w in want[8:]] == [c for _z, c in bad.values()]
    assert len(held) >= 2


@pytest.mark.parametrize("seed", range(4))
def test_materialize_records_on_random_lane_subsets(dev, seed):
    """K13 on random subsets of one thumbnail round's lanes, some lanes
    marked failed (produced 0), at the round's cap and at 262144 (past
    shared memory: the working bytes in device memory), equals its plain
    version."""
    from fdeflate_tpu_torch.ops import inflate as PI
    from portbench.thumbnails import make_rgb_thumbnails

    rounds = []

    def keep(recs, window, produced, cap):
        rounds.append((recs, window, produced, cap))
        return materialize_records(recs, window, produced, cap)

    streams = [zlib.compress(r.tobytes(), 6)
               for r in make_rgb_thumbnails(64, seed=28)]
    saved = PI.materialize_records
    PI.materialize_records = keep
    try:
        PI.decompress_sequential(streams, device=dev)
    finally:
        PI.materialize_records = saved
    rng = np.random.default_rng(seed)
    recs, window, produced, cap = rounds[seed % len(rounds)]
    L = recs.shape[1]
    for size in (1, 7, L):
        lanes = torch.from_numpy(rng.permutation(L)[:size]).to(dev)
        p = produced[lanes].clone()
        p[torch.from_numpy(rng.random(size) < 0.25).to(dev)] = 0
        args = (recs[:, lanes], window[lanes], p)
        for c in (cap, 1 << 18):
            got = materialize_records(*args, c)
            want = materialize_records_plain(*args, c)
            assert torch.equal(got[0], want[0]), (size, c)
            assert torch.equal(got[1], want[1]), (size, c)


def _no_host_parse(monkeypatch):
    """Make the host's header parse and table build raise, under every name
    the port holds them by."""
    from fdeflate_tpu_torch.ops import header_tables as HT
    from fdeflate_tpu_torch.ops import inflate_host
    from fdeflate_tpu_torch.ops import inflate_records as K4

    def boom(*_a, **_k):
        raise AssertionError("a dynamic header parsed on the host")

    monkeypatch.setattr(inflate_host, "_parse_dynamic_lengths", boom)
    for mod in (K4, HT):
        monkeypatch.setattr(mod, "block_tables", boom)


def test_the_sequential_path_on_the_card_equals_the_cpu(dev):
    """256 small thumbnails of every block kind and the crafted bad streams
    (``edges.bad_header_streams``) through ``decompress_sequential``: the
    card's answers are the CPU's (K12 and the plain parse), one K12 launch
    a round that met a dynamic header, the bad headers handed to the host."""
    from fdeflate_tpu_torch.ops.inflate import decompress_sequential
    from fdeflate_tpu_torch.tools.edges import bad_header_streams
    from portbench.thumbnails import make_rgb_thumbnails

    images = [r.tobytes() for r in make_rgb_thumbnails(256, 32, 32, 26)]
    fixed = zlib.compressobj(6, strategy=zlib.Z_FIXED)
    streams = [zlib.compress(im, (6, 0, 9, 1)[k % 4])
               for k, im in enumerate(images)]
    streams[5] = fixed.compress(images[5]) + fixed.flush()
    bad = bad_header_streams(images[0][:400])
    streams += [z for z, _cls in bad.values()]
    runs = []
    for where in (dev, "cpu"):
        before = profiling.counts()
        got = decompress_sequential(streams, device=where)
        runs.append((got, {k: v - before.get(k, 0)
                           for k, v in profiling.counts().items()}))
    (got, n), (want, n_cpu) = runs
    assert got[:256] == want[:256] == images
    assert [type(g).__name__ for g in got[256:]] == [
        type(w).__name__ for w in want[256:]] == [c for _z, c in bad.values()]
    for k in ("sequential.headers.device", "sequential.headers.host",
              "sequential.blocks.dynamic", "sequential.launches"):
        assert n[k] == n_cpu[k], k
    assert n["sequential.headers.host"] == len(bad)
    assert n["launch.header_tables"] == 2


def test_no_good_thumbnail_header_is_parsed_on_the_host(dev, monkeypatch):
    """The thumbnail cell's call with the host's header parse and table
    build made to raise: its 512 dynamic headers all go to K12, two
    launches, and every image decodes."""
    from portbench.thumbnails import make_rgb_thumbnails

    _no_host_parse(monkeypatch)
    streams = [zlib.compress(r.tobytes(), 6)
               for r in make_rgb_thumbnails(256, seed=26)]
    before = profiling.counts()
    got = P.decompress_batch(streams, device=dev)
    assert got == [zlib.decompress(z) for z in streams]
    n = {k: v - before.get(k, 0) for k, v in profiling.counts().items()}
    assert n["sequential.headers.device"] == 512
    assert n.get("sequential.headers.host", 0) == 0
    assert n["launch.header_tables"] == 2


def test_profiling_sync_waits_on_cuda_tensors(dev):
    from fdeflate_tpu_torch.utils import profiling as PProf

    x = torch.ones(1 << 20, device=dev)
    y = x.cumsum(0)
    PProf.sync(y, torch.zeros(2), "not a tensor")
    assert float(y[-1]) == float(1 << 20)


def _every_wrapper(dev):
    """(name, kernel call, plain call) of each of the thirteen kernels'
    entry points (K7's through both its wrappers) on small inputs on
    ``dev``; the plain calls of K11 and K12 run on the CPU."""
    data, lengths, C = _inputs(dev, "ragged_B3_N8192_C4")
    B, N = data.shape
    t = trained_tables(str(dev))
    win, bits = assign_pack_plain(data, lengths, C, t)
    pos0 = lane_starts(bits, B, C, t.header_bits)[0].reshape(-1).to(torch.int32)
    W = stream_words(N, t)
    words, tb, _ad, starts, _eof = _encode(data, lengths, C, t,
                                           assign_pack_plain, combine_plain)
    sep = P.sep_profile()
    sw, _t, _a, sst, _e = P.zlib_encode_step(C, tree=sep)(data, lengths)
    meta, vals = sep_tables(sep.lens, dev)
    cmeta, packed = canon_tables(str(dev))
    S = N // C
    v, nb, _ = assign_tokens(data, lengths, 512, t)
    tok = pack_tokens(v, nb, token_offsets(nb, N // 512), N // 512)
    buf = data.reshape(-1)
    lt = torch.tensor([buf.numel() - 5], dtype=torch.int64, device=dev)
    args4, K = k4_edge_case("blocks")
    args4 = tuple(x.to(dev) for x in args4)
    z = zlib.compress(_foreign(2, 60_000), 6)
    zw = PD.stage_words(z, device=dev)
    c = torch.from_numpy(PD.scan_stage1_device(z, device="cpu")).to(dev)
    k11 = k11_edge_case("stacked tables")
    k12 = k12_edge_case()[:4]
    k13 = (torch.tensor([[(1 << 28) | (2 << 16) | 0x4142],
                         [(2 << 28) | (97 << 15) | 1]], dtype=torch.int32,
                        device=dev),
           torch.zeros(1, 32768, dtype=torch.uint8, device=dev),
           torch.tensor([102], device=dev))
    return [
        ("assign_pack", lambda: assign_pack(data, lengths, C, t),
         lambda: assign_pack_plain(data, lengths, C, t)),
        ("combine", lambda: combine(win, bits, pos0, B, W),
         lambda: (combine_plain(win, bits, pos0, B, W),)),
        ("decode2", lambda: decode2(words, starts, t.dtab, N, C),
         lambda: decode2_plain(words, starts, t.dtab, N, C)),
        ("decode_sep", lambda: decode_sep(sw, sst, meta, vals, N, C),
         lambda: decode_sep_plain(sw, sst, meta, vals, N, C)),
        ("adler32_tiles", lambda: adler32_tiles(buf, lt),
         lambda: adler32_tiles_plain(buf, lt)),
        ("adler32_tiles (batch)", lambda: adler32_batch(data, lengths),
         lambda: (adler32_batch_plain(data, lengths),)),
        ("inflate_records", lambda: inflate_records(*args4, K),
         lambda: inflate_records_plain(*args4, K)),
        ("validate_headers", lambda: validate_headers(zw, c, len(z) * 8),
         lambda: validate_headers_plain(zw, c, len(z) * 8)),
        ("decode2_canon", lambda: decode2_canon(win, S // 4, cmeta, packed),
         lambda: decode2_canon_plain(win, S // 4, cmeta, packed)),
        ("pack_v1", lambda: pack_blocked(tok, wwin(512)),
         lambda: (pack_blocked_plain(tok, wwin(512)),)),
        ("combine_grouped", lambda: combine(win, bits, pos0, B, W, group=4),
         lambda: (combine_plain(win, bits, pos0, B, W),)),
        ("decode_symbols", lambda: _flat(decode_symbols(**_on(k11, dev))),
         lambda: tuple(x.to(dev) for x in _flat(decode_symbols(**k11)))),
        ("header_tables", lambda: header_tables(*(x.to(dev) for x in k12)),
         lambda: tuple(x.to(dev) for x in header_tables_plain(*k12))),
        ("materialize_records", lambda: materialize_records(*k13, 1024),
         lambda: materialize_records_plain(*k13, 1024)),
    ]


def test_launches_follow_the_tensors_device():
    """Every wrapper, given tensors on cuda:1 while device 0 is current,
    launches on device 1 (``_build.launch`` makes it current for the
    call), equals its plain version there, and leaves device 0 current.
    Skips below two devices."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    calls = _every_wrapper(dev)
    torch.cuda.set_device(0)
    for name, kern, plain in calls:
        got = kern()
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0, name
        assert all(g.device == dev for g in got), name
        for g, w in zip(got, plain()):
            assert torch.equal(g, w), name
