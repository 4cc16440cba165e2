"""K12 header_tables on the CPU: its plain version, its lane code built for
the host, and block discovery's ``lane_layout`` around it.

The plain version (``header_tables_plain``) is held to the JAX package's
host parse of each header (``_HostBitReader``, ``_parse_dynamic_lengths``,
``foreign_meta``) under the rules block discovery applied to it before the
parse moved to the card: a header whose trees cannot be built is dropped,
a stream whose bit-16 header is dropped or whose first lane is not at bit
16 is left.  ``csrc/header_lanes.cuh`` (the kernel's group code, with
``HostGroup``: 32 threads in turn) is built with g++ and held to the plain
version bit for bit in every output.  Streams stay small: stage 1 and the
plain K4 run on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from fdeflate_tpu import errors as JE
from fdeflate_tpu.ops import inflate as JI
from fdeflate_tpu.ops.pallas_inflate import foreign_meta as jax_foreign_meta
from fdeflate_tpu_torch.ops import header_tables as HT
from fdeflate_tpu_torch.ops.inflate import pad_words
from fdeflate_tpu_torch.ops.inflate_host import foreign_meta
from fdeflate_tpu_torch.ops.inflate_records import pack_tables
from fdeflate_tpu_torch.parallel import discovery as PD
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.edges import k12_edge_case
from fdeflate_tpu_torch.utils import profiling

CSRC = pathlib.Path(__file__).resolve().parent.parent / "fdeflate_tpu_torch" / "csrc"
FALSE_HEADER = 1302677   # image 20's false header (test_torch_tracing.py)

_HARNESS = r"""
#include "warp.cuh"
#include "header_lanes.cuh"
// K12's group code with HostGroup, 32 threads to a header, as the kernel
// runs it (a warp a header, words past min(wend, W) read as 0).
extern "C" void header_lanes(const uint32_t* words, const int64_t* offs,
    const int64_t* wend, const int64_t* bit_end, int64_t W, int64_t* info,
    int32_t* meta, int32_t* tab, int H) {
  fdt::HdrScratch sh;
  const fdt::HostGroup g{32};
  for (int64_t h = 0; h < H; ++h)
    fdt::header_group(g, words, wend[h] < W ? wend[h] : W, offs[h],
                      bit_end[h], sh, info + h, H, meta + h * fdt::kMetaRows,
                      tab + h * fdt::kTabPairs);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build K12's lane code for the host")
    d = tmp_path_factory.mktemp("header_lanes")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libheader.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.header_lanes.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                                 + [ctypes.c_void_p] * 3 + [ctypes.c_int])
    return lib


def _lane_code(lib, words, offs, wend, bit_end):
    """The kernel's group code on the host: (info, meta, tab)."""
    words = words.reshape(-1).to(torch.int32).contiguous()
    cols = [x.reshape(-1).to(torch.int64).contiguous()
            for x in (offs, wend, bit_end)]
    H = cols[0].numel()
    info = torch.full((4, H), 7, dtype=torch.int64)
    meta = torch.full((H, 64), 7, dtype=torch.int32)
    tab = torch.full((H, 160), 7, dtype=torch.int32)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    lib.header_lanes(ptr(words), *(ptr(x) for x in cols), words.numel(),
                     ptr(info), ptr(meta), ptr(tab), H)
    return info, meta, tab


def _split(data: bytes, step: int, level: int = 6) -> bytes:
    """zlib stream whose blocks end every ``step`` input bytes."""
    co = zlib.compressobj(level)
    out = b"".join(co.compress(data[i: i + step])
                   + (co.flush(zlib.Z_BLOCK) if i + step < len(data) else b"")
                   for i in range(0, len(data), step))
    return out + co.flush()


def _corpus(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return np.where(rng.integers(0, 4, n) > 0, rng.integers(-8, 8, n),
                    0).astype(np.uint8).tobytes()


@functools.lru_cache(maxsize=1)
def _image20() -> bytes:
    return zlib.compress(make_idat_corpus(21, 1 << 20, 0)[20], 6)


STREAMS = {
    "zlib6 blocks": _split(_corpus(4000, 1), 1000),
    "zlib1 blocks": _split(_corpus(3000, 2), 600, level=1),
    "zlib9 blocks": _split(_corpus(3000, 3), 1500, level=9),
    "idat zlib6": zlib.compress(make_idat_corpus(1, 6000, 4)[0].tobytes(), 6),
}


def _old_parse_lanes(data: bytes, offsets):
    """Block discovery's parse of one stream before K12, on the JAX
    package's host functions: (lanes (off, bfinal, symbol start, lengths,
    hlit), tables, dropped), or None."""
    lanes, tables, dropped = [], [], set()
    if 16 in set(np.asarray(offsets).tolist()):
        for off in np.asarray(offsets).tolist():
            r = JI._HostBitReader(data, off)
            bfinal = r.take(1)
            if r.take(2) != 0b10:
                continue
            try:
                lengths, hlit = JI._parse_dynamic_lengths(r)
            except JE.DecompressionError:
                continue
            try:
                tables.append(jax_foreign_meta(lengths[:hlit],
                                               lengths[288:320]))
            except ValueError:
                dropped.add(off)
                continue
            lanes.append((off, bool(bfinal), r.pos, lengths, hlit))
    if 16 in dropped or not lanes or lanes[0][0] != 16:
        return None
    return lanes, tables, dropped


def _headers(streams, offsets: dict):
    """``header_tables``' inputs for ``offsets`` (stream index -> its
    stream-local header bits) over the streams' concatenated words."""
    words, base = pad_words(streams)
    cols = PD.stage2_batch_inputs(streams, offsets, base)
    return torch.from_numpy(words), *torch.from_numpy(cols)


# -- the plain version -----------------------------------------------------

@pytest.mark.parametrize("name", list(STREAMS))
def test_plain_equals_the_old_parse(name):
    """Every validated header of a stream: the plain K12's lanes, tables and
    dropped set are those of the host parse before K12."""
    z = STREAMS[name]
    offsets = PD.find_block_boundaries(z, device="cpu")[0]
    info, meta, tab = HT.header_tables(*_headers([z], {0: offsets}))
    want_lanes, want_tables, want_dropped = _old_parse_lanes(z, offsets)
    status, bfinal, start = info[:3].numpy()
    lanes = np.flatnonzero(status == HT.LANE)
    assert [(int(offsets[i]), bool(bfinal[i]), int(start[i])) for i in lanes] \
        == [lane[:3] for lane in want_lanes]
    assert set(offsets[status == HT.DROPPED].tolist()) == want_dropped
    want_meta, want_tab = pack_tables(want_tables, "cpu")
    assert torch.equal(meta[lanes], want_meta)
    assert torch.equal(tab[lanes], want_tab)
    assert not meta[status != HT.LANE].any() and not tab[status != HT.LANE].any()
    # and _parse_lanes, the plain per-stream helper, is the old parse
    lanes, tables, dropped = PD._parse_lanes(z, offsets)
    assert [lane[:3] for lane in lanes] == [l[:3] for l in want_lanes]
    assert all(np.array_equal(a[3], b[3]) and a[4] == b[4]
               for a, b in zip(lanes, want_lanes))
    assert dropped == want_dropped
    assert all(np.array_equal(m, wm) and np.array_equal(t, wt)
               for (m, t), (wm, wt) in zip(tables, want_tables))


def test_plain_drops_image20s_false_header():
    z = _image20()
    offsets = np.array([16, FALSE_HEADER])
    info, meta, _tab = HT.header_tables(*_headers([z], {0: offsets}))
    assert info[0].tolist() == [HT.LANE, HT.DROPPED]
    want_lanes, want_tables, want_dropped = _old_parse_lanes(z, offsets)
    assert want_dropped == {FALSE_HEADER}
    assert info[2, 0].item() == want_lanes[0][2]
    assert torch.equal(meta[:1], pack_tables(want_tables, "cpu")[0])


_K12 = k12_edge_case()


@pytest.mark.parametrize("i", range(len(_K12[4])), ids=_K12[4])
def test_plain_classifies_crafted_headers(i):
    words, offs, wend, bit_end, _labels, status, lengths = _K12
    info, meta, tab = HT.header_tables(words, offs, wend, bit_end)
    assert info[0, i].item() == status[i]
    if status[i] == HT.SKIPPED:
        assert info[1:3, i].tolist() == [0, -1]
    if lengths[i] is None:
        assert not meta[i].any() and not tab[i].any()
        assert info[3, i].item() == 0
    else:
        m, t = foreign_meta(np.array(lengths[i][0]), np.array(lengths[i][1]))
        assert np.array_equal(meta[i].numpy(), m)
        assert np.array_equal(tab[i].numpy(), t)
        assert info[3, i].item() == _jax_takes_trees(*lengths[i])


def _jax_takes_trees(lit, dist) -> bool:
    """Whether the JAX package's host table build takes the trees (the
    host's rule, ``host_ok``)."""
    lengths = np.zeros(320, np.int64)
    lengths[:len(lit)] = lit
    lengths[288:288 + len(dist)] = dist
    try:
        JI._tables_from_lengths(lengths, len(lit))
    except JE.DecompressionError:
        return False
    return True


def test_crafted_headers_include_trees_only_the_card_takes():
    """K12 makes lanes of single distance codes longer than one bit, which
    the host's rule refuses: ``host_ok`` tells them apart."""
    words, offs, wend, bit_end, labels, status, _lengths = _K12
    info = HT.header_tables(words, offs, wend, bit_end)[0]
    refused = [lab for lab, st, ok in zip(labels, status, info[3].tolist())
               if st == HT.LANE and not ok]
    assert refused == ["one distance code", "a single 2-bit distance code",
                       "a single 5-bit distance code"]


def test_header_tables_needs_one_entry_per_header():
    words, offs, wend, bit_end, *_ = _K12
    with pytest.raises(ValueError, match="one entry per header"):
        HT.header_tables(words, offs, wend[1:], bit_end)


# -- the kernel's lane code on the host ------------------------------------

def test_lane_code_matches_plain_on_crafted_headers(lib):
    words, offs, wend, bit_end, *_ = _K12
    got = _lane_code(lib, words, offs, wend, bit_end)
    for g, w in zip(got, HT.header_tables(words, offs, wend, bit_end)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["zlib6 blocks", "idat zlib6"])
def test_lane_code_matches_plain_at_every_bit(lib, name):
    """Every bit offset of a stream's first 2048 bits (most skipped), and
    each with its stream's end 600 bits on (truncated parses)."""
    z = STREAMS[name]
    words, c, wend, bit_end = _headers([z], {0: np.arange(2048)})
    for end in (bit_end, torch.minimum(bit_end, c + 600)):
        got = _lane_code(lib, words, c, wend, end)
        want = HT.header_tables(words, c, wend, end)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert {0, 1} <= set(got[0][0].tolist())


def test_lane_code_matches_plain_on_validated_headers(lib):
    """The K5-good headers of several streams over their concatenated words
    (each bounded by its own stream), image 20's false header among
    them."""
    streams = list(STREAMS.values()) + [_image20()]
    offsets = {si: PD.find_block_boundaries(z, device="cpu")[0]
               for si, z in enumerate(streams[:-1])}
    offsets[len(streams) - 1] = np.array([16, FALSE_HEADER])
    args = _headers(streams, offsets)
    got = _lane_code(lib, *args)
    want = HT.header_tables(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert set(got[0][0].tolist()) == {HT.LANE, HT.DROPPED}


# -- lane_layout around it -------------------------------------------------

def _layout_streams():
    good = STREAMS["zlib6 blocks"]
    false = good + _image20()[FALSE_HEADER // 8:][:120]   # past the trailer
    return [good, STREAMS["zlib1 blocks"], false,
            zlib.compress(b"stored" * 50, 0),            # first_block
            b"\x00\x01" + good[2:],                      # header
            STREAMS["idat zlib6"]]


def test_lane_layout_equals_the_old_parse():
    """``lane_layout`` on the CPU: the lanes, their tables (packed), ranges,
    dropped sets and counter deltas of the parse before K12, and
    ``discovery.headers`` = lanes + dropped + skipped."""
    streams = _layout_streams()
    words, base = pad_words(streams)
    before = profiling.counts()
    lanes, (meta, tab), wend, bit_end, ranges, dropped = PD.lane_layout(
        streams, torch.from_numpy(words), base)
    n = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
         if v != before.get(k, 0)}

    want_lanes, want_tables, want_ranges, want_dropped = [], [], {}, {}
    headers = skipped = n_dropped = 0
    for si, z in enumerate(streams):
        if len(z) < 7 or not PD._zlib_header_ok(z):
            continue
        offsets = PD.find_block_boundaries(z, device="cpu")[0]
        found = _old_parse_lanes(z, offsets)
        if 16 in set(offsets.tolist()):
            headers += len(offsets)
            info = HT.header_tables(*_headers([z], {0: offsets}))[0]
            skipped += int((info[0] == HT.SKIPPED).sum())
            n_dropped += int((info[0] == HT.DROPPED).sum())
        if found is None:
            continue
        own, tables, want_dropped[si] = found
        lo = len(want_lanes)
        want_lanes += [(o, b, int(base[si]) * 32 + s) for o, b, s, _l, _h in own]
        want_tables += tables
        want_ranges[si] = (lo, len(want_lanes))
    assert lanes == want_lanes
    assert (ranges, dropped) == (want_ranges, want_dropped)
    want_meta, want_tab = pack_tables(want_tables, "cpu")
    assert torch.equal(meta, want_meta) and torch.equal(tab, want_tab)
    assert wend.tolist() == [int(base[si + 1]) for si, (lo, hi) in
                             ranges.items() for _ in range(lo, hi)]
    assert bit_end.tolist() == [int(base[si]) * 32 + len(streams[si]) * 8
                                for si, (lo, hi) in ranges.items()
                                for _ in range(lo, hi)]
    assert n == {"discovery.fallback.header": 1,
                 "discovery.fallback.first_block": 1,
                 "discovery.lanes_dropped": 1,
                 "discovery.headers": headers}
    assert n_dropped == 1
    assert headers == len(lanes) + n_dropped + skipped


def test_discovery_counts_headers_as_lanes_dropped_and_skipped():
    """Through ``try_foreign_batch``: every header K12 took is a lane K4
    decoded, a dropped one or a skipped one."""
    streams = [_layout_streams()[i] for i in (0, 1, 2)]
    before = profiling.counts()
    got = PD.try_foreign_batch(streams, max_steps=512, device="cpu")
    assert got == [zlib.decompress(z) for z in streams]
    n = {k: v - before.get(k, 0) for k, v in profiling.counts().items()}
    offsets = {si: PD.find_block_boundaries(z, device="cpu")[0]
               for si, z in enumerate(streams)}
    info = HT.header_tables(*_headers(streams, offsets))[0]
    skipped = int((info[0] == HT.SKIPPED).sum())
    assert n["discovery.headers"] == (n["discovery.lanes"]
                                      + n["discovery.lanes_dropped"] + skipped)
    assert n["discovery.lanes_dropped"] == 1
