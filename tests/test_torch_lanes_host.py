"""The kernels' per-lane code, built for the host, against the plain versions.

``fdeflate_tpu_torch/csrc/lanes.cuh`` holds, as plain C++, the lane code
of K1, K2, K3, K6, K8 and K9 (a group of m threads per lane: K1's group
classification, run scan and segment emit; K2's owned words; K3's segment
decode, sync rounds and span hints, put together by ``assign_pack_group``,
``combine_group`` and ``decode2_group``, which K6 runs with the sep tree's
table and its serial path for lanes that meet an EOB, and K8 with the
table of its canonical rows and its serial path for tables that break
K3's protocol; K9's scatter of token pairs into a window,
``pack_v1_group``) and the whole sequential work of a K6 and a K8 lane
(their serial paths); ``csrc/inflate_lanes.cuh`` that of K4 (``inflate_group``, K3's
protocol on records, with its lookup tables) and of a K5 candidate (its
code-length table, bit buffer and resumable section decode).  Here g++ builds the same headers into a small
host library: the lane loops around the one-lane machines, and the group
code with ``HostGroup`` (``csrc/warp.cuh``: m threads run in turn,
collectives as loops; the kernels run the same code with ``WarpGroup``'s
shuffles), for m = 32 as on the card, the kernels' own choice of m, and
1, 2 and 5.
So the bit machines and their orchestration are held against the plain
PyTorch versions on every tier-1 run, with no card.  The launch
configuration, cp.async staging, shuffles and shared-memory atomics are
covered only on the card (tests/test_torch_cuda.py, chip_smoke.py).
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

from fdeflate_tpu.ops import inflate as I
from fdeflate_tpu.ops.pallas_inflate import foreign_meta
from fdeflate_tpu.parallel.discovery import scan_stage1
from fdeflate_tpu_torch.ops.assign_pack import assign_pack_plain, wwin
from fdeflate_tpu.ops.septree import sep_profile
from fdeflate_tpu_torch.ops.decode2 import (
    canon_tables,
    canon_unsafe,
    decode2_canon_plain,
    decode2_plain,
)
from fdeflate_tpu_torch.ops.decode_sep import (
    decode_sep_plain,
    decode_sep_plain_eob,
)
from fdeflate_tpu_torch.ops.inflate import fixed_meta_tab, pad_words
from fdeflate_tpu_torch.ops.pack import (
    pack_blocked_plain,
    pack_tokens,
    token_offsets,
)
from fdeflate_tpu_torch.ops.inflate_records import (
    NO_LIMIT,
    inflate_records_plain,
    pack_tables,
)
from fdeflate_tpu_torch.ops.adler32 import adler32_batch_plain
from fdeflate_tpu_torch.ops.adler32_pallas import (adler32_checksums,
                                                   adler32_tiles_plain)
from fdeflate_tpu_torch.ops.repack import combine_plain, slab_lanes
from fdeflate_tpu_torch.ops.ultrafast import (
    encode_fixed,
    lane_starts,
    stream_words,
)
from fdeflate_tpu_torch.ops.validate_headers import validate_headers_plain
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.edges import (
    K4_KINDS,
    K8_UNSAFE,
    corrupt_words,
    k1_edge_inputs,
    k1_long_lane,
    k2_edge_cases,
    k4_edge_case,
    k4_streams,
    k5_cross_stream,
    k6_edge_cases,
    k8_unsafe_packed,
    k9_noise_tokens,
    mid_lane_bit,
    splice_eob,
)
from fdeflate_tpu_torch.tables import HUFFMAN_LENGTHS
from fdeflate_tpu_torch.trees import decode_table, sep_tables, trained_tables

CSRC = pathlib.Path(__file__).resolve().parent.parent / "fdeflate_tpu_torch" / "csrc"

# The kernels' lane loops (validate_headers.cu, K6's and K8's serial
# paths) and the group code of assign_pack.cu, combine.cu, decode2.cu,
# decode_sep.cu, decode2_canon.cu, pack_v1.cu and inflate_records.cu,
# serial on the host.
_HARNESS = r"""
#include <cstring>
#include <vector>
#include "lanes.cuh"
#include "warp.cuh"
#include "inflate_lanes.cuh"
// K4's group code with HostGroup, m threads to a lane (0: the kernel's
// fdt::inf_threads of the lane's hint), the hint times hnum / hden.
extern "C" void inflate_warp(const uint32_t* words, const int64_t* start,
    const int64_t* wend, const int64_t* bit_end, const int64_t* out0,
    const int32_t* meta, const int32_t* tab, int32_t* recs, int64_t* bpos,
    int64_t* nout, int32_t* done, int L, int K, int m, int64_t hnum,
    int64_t hden, int64_t* stats) {
  std::vector<int32_t> lit(fdt::kInfTable), dist(fdt::kInfTable);
  std::vector<uint32_t> sw(fdt::kInfTileWords);
  for (int64_t lane = 0; lane < L; ++lane) {
    const int32_t* mt = meta + lane * fdt::kMetaRows;
    const int32_t* tb = tab + lane * fdt::kTabPairs;
    fdt::inf_table_part(mt, tb, lit.data(), dist.data(), 0, 1);
    const int64_t he = fdt::inf_hint_end(start, wend, bit_end, L, lane);
    fdt::HostGroup g{m ? m : fdt::inf_threads(he - start[lane]), hnum, hden,
                     stats};
    fdt::inflate_group(g, words, start[lane], wend[lane], bit_end[lane],
        out0[lane], he, fdt::InfTables{lit.data(), dist.data(), mt, tb},
        sw.data(), recs + lane, L, K, bpos + lane, nout + lane, done + lane);
  }
}
extern "C" int inf_threads(int64_t span_bits) {
  return fdt::inf_threads(span_bits);
}
// K2's group code with HostGroup, m threads to a lane.
extern "C" void combine_warp(const uint32_t* win, const int32_t* chunk_bits,
    const int32_t* pos0, uint32_t* words, int B, int C, int wwin, int W,
    int m) {
  fdt::HostGroup g{m};
  for (int64_t lane = 0; lane < (int64_t)B * C; ++lane)
    fdt::combine_group(g, win, chunk_bits, pos0, words, C, wwin, W, lane);
  for (int64_t b = 0; b < B; ++b)
    for (int64_t c = 0; c * fdt::kCombineZero < W; ++c)
      fdt::combine_zero_group(g, chunk_bits, pos0, words, C, W, b, c);
}
// K7's tile code with HostGroup, m threads to a tile, and its fold: the
// checksums of B rows (row b at data + b * stride, n bytes, lengths[b]
// of them counted) and their tile sums (int32[B, T], or null).
extern "C" void adler32_warp(const uint8_t* data, int64_t stride, int64_t B,
    int64_t n, const int64_t* lengths, int64_t* out, int32_t* sums,
    int32_t* wsums, int m) {
  fdt::HostGroup g{m};
  const int64_t T = (n + fdt::kAdlerTile - 1) / fdt::kAdlerTile;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t len = lengths[b], limit = len < n ? len : n;
    uint64_t a = 0, terms = 0;
    for (int64_t k = 0; k < T; ++k) {
      const int64_t o = k * fdt::kAdlerTile;
      const fdt::TileSums ts =
          fdt::adler_tile_group(g, data + b * stride, o, limit);
      if (sums) {
        sums[b * T + k] = ts.s;
        wsums[b * T + k] = ts.w;
      }
      a += static_cast<uint32_t>(ts.s);
      terms += fdt::adler_term(len, o, ts);
    }
    out[b] = fdt::adler_finish(len, a, terms);
  }
}
// K10's slab code with HostGroup, m threads to a slab, every slab of
// every stream in turn.
extern "C" void combine_slabs_warp(const uint32_t* win,
    const int32_t* chunk_bits, const int32_t* pos0, uint32_t* words, int B,
    int C, int wwin, int W, int m) {
  fdt::HostGroup g{m};
  std::vector<uint32_t> buf(fdt::kSlabBuf + 4);
  uint32_t* b16 = reinterpret_cast<uint32_t*>(
      (reinterpret_cast<uintptr_t>(buf.data()) + 15) & ~uintptr_t{15});
  for (int64_t b = 0; b < B; ++b)
    for (int64_t s = 0; s * fdt::kSlabWords < W; ++s)
      fdt::combine_slab_group(g, win, chunk_bits, pos0, words, C, wwin, W,
                              (int64_t)B * C, b, s, b16);
}
// K10's lane search with HostGroup: lanes [lo, hi) of each slab.
extern "C" void slab_ranges_warp(const int32_t* chunk_bits,
    const int32_t* pos0, int B, int C, int W, int m, int64_t* lo,
    int64_t* hi) {
  fdt::HostGroup g{m};
  const int64_t nslabs = (W + fdt::kSlabWords - 1) / fdt::kSlabWords;
  for (int64_t b = 0; b < B; ++b)
    for (int64_t s = 0; s < nslabs; ++s)
      fdt::slab_range(g, chunk_bits, pos0, b, C, s * fdt::kSlabWords,
                      lo + b * nslabs + s, hi + b * nslabs + s);
}
// K5's lane code, each candidate with its stream's word end and payload
// end: one pass (validate_lane) for first >= kValSteps, else `first`
// sections, then the rest from a new reader at the state's bit, as the
// kernel resumes its survivors after the compaction.
extern "C" void validate_lanes(const uint32_t* words, const int64_t* cands,
    const int64_t* wends, const int64_t* nbits, int32_t* good, int64_t* end,
    int L, int first) {
  uint8_t t[128];
  for (int64_t i = 0; i < L; ++i) {
    if (first >= fdt::kValSteps) {
      good[i] = fdt::validate_lane(words, wends[i], cands[i], nbits[i], t,
                                   end + i);
      continue;
    }
    fdt::HeaderBits hb(words, wends[i], cands[i]);
    fdt::ValState s = fdt::val_begin(hb, cands[i], t);
    fdt::val_sections(s, hb, t, nbits[i], first);
    if (fdt::val_live(s)) {
      fdt::HeaderBits rest(words, wends[i], s.pos);
      fdt::val_sections(s, rest, t, nbits[i], fdt::kValSteps);
    }
    good[i] = fdt::val_good(s);
    end[i] = s.pos;
  }
}
// K5's CL decode tables of packed lengths (3 bits a symbol).
extern "C" void cl_tables(const int64_t* clps, uint8_t* out, int n) {
  for (int i = 0; i < n; ++i)
    fdt::cl_table(static_cast<uint64_t>(clps[i]), out + 128 * i);
}
// K1's and K3's lane code with HostGroup (warp.cuh): m threads run in
// turn, the same orchestration as the kernels'.
extern "C" void assign_pack_warp(const uint8_t* data, const int32_t* lengths,
    const int32_t* lit, const int32_t* lent, uint32_t* win, int32_t* bits,
    int B, int N, int C, int wwin, int m) {
  std::vector<uint8_t> tile(fdt::kApTile);
  std::vector<uint32_t> buf(fdt::kApBufWords);
  fdt::HostGroup g{m};
  for (int64_t lane = 0; lane < (int64_t)B * C; ++lane)
    fdt::assign_pack_group(g, data, lengths, N, C, lane, lit, lent,
                           tile.data(), buf.data(), win, wwin, bits);
}
// The hint is the kernel's times hnum / hden; tcap the output bytes staged
// per lane (0: the kernel's, fdt::dec_tile(m)).  stats: HostGroup's.
extern "C" void decode_warp(const uint32_t* words, const int32_t* starts,
    const int32_t* dtab, uint8_t* out, int32_t* bpos, int B, int W, int N,
    int C, int m, int tcap, int64_t hnum, int64_t hden, int64_t* stats) {
  if (tcap == 0) tcap = fdt::dec_tile(m);
  std::vector<uint8_t> tile(tcap + 16);
  std::vector<uint32_t> sw(fdt::dec_words(31, tcap));
  fdt::HostGroup g{m, hnum, hden, stats};
  for (int64_t lane = 0; lane < (int64_t)B * C; ++lane)
    fdt::decode2_group(g, words, W, starts, N, C, lane, dtab, tcap,
                       tile.data(), sw.data(), out, bpos);
}
// K3's threads per lane for S bytes.
extern "C" int dec_threads(int S) { return fdt::dec_threads(S); }
// K6's group code (decode2_group<kSep>) with HostGroup, its table built
// from (meta, vals) as the kernel's prologue builds it; tcap and the hint
// as decode_warp's.  stats[4]: lanes decoded serially.
extern "C" void decode_sep_warp(const uint32_t* words, const int32_t* starts,
    const int32_t* meta, const int32_t* vals, uint8_t* out, int32_t* bpos,
    int B, int W, int N, int C, int m, int tcap, int64_t hnum, int64_t hden,
    int64_t* stats) {
  std::vector<int32_t> dtab(1 << fdt::kMaxL);
  for (int x = 0; x < (1 << fdt::kMaxL); ++x)
    dtab[x] = fdt::sep_entry(meta, vals, x);
  if (tcap == 0) tcap = fdt::dec_tile(m);
  std::vector<uint8_t> tile(tcap + 16);
  std::vector<uint32_t> sw(fdt::dec_words(31, tcap));
  fdt::HostGroup g{m, hnum, hden, stats};
  for (int64_t lane = 0; lane < (int64_t)B * C; ++lane)
    fdt::decode2_group<fdt::HostGroup, true>(g, words, W, starts, N, C, lane,
        dtab.data(), tcap, tile.data(), sw.data(), out, bpos);
}
extern "C" void sep_entries(const int32_t* meta, const int32_t* vals,
    int32_t* out) {
  for (int x = 0; x < (1 << fdt::kMaxL); ++x)
    out[x] = fdt::sep_entry(meta, vals, x);
}
extern "C" void decode_sep_lanes(const uint32_t* words, const int32_t* starts,
    const int32_t* meta, const int32_t* vals, uint8_t* out, int32_t* bpos,
    int B, int W, int N, int C) {
  int S = N / C;
  for (int64_t lane = 0; lane < (int64_t)B * C; ++lane) {
    int b = lane / C, k = lane % C;
    bpos[lane] = fdt::decode_sep_lane(words + (int64_t)b * W, W, starts[lane],
        meta, vals, (uint32_t*)(out + (int64_t)b * N + (int64_t)k * S), S);
  }
}
extern "C" void decode_canon_lanes(const uint32_t* win, const int32_t* meta,
    const int32_t* packed, uint32_t* out, int32_t* bpos, int L, int wwin,
    int T) {
  for (int64_t lane = 0; lane < L; ++lane)
    bpos[lane] = fdt::decode_canon_lane(win + lane * wwin, wwin, meta,
        meta + 16, packed, out + lane * T, T);
}
// K8's table as its kernel's prologue builds it; returns the unsafe flag.
extern "C" int canon_entries(const int32_t* meta, const int32_t* packed,
    int32_t* out) {
  return fdt::canon_table(meta, packed, out, 0, 1);
}
// K8 as its kernel runs it, with HostGroup: the table from (meta,
// packed); an unsafe table decodes every lane serially (stats[4] counts
// them), a safe one runs K3's group code on each lane's window, a C = 1
// stream from bit 0 (null chunk starts), m threads (0: the kernel's
// fdt::dec_threads(4T) and its tile), the hint times hnum / hden.
extern "C" void decode_canon_warp(const uint32_t* win, const int32_t* meta,
    const int32_t* packed, uint8_t* out, int32_t* bpos, int L, int wwin,
    int T, int m, int tcap, int64_t hnum, int64_t hden, int64_t* stats) {
  std::vector<int32_t> dtab(1 << fdt::kMaxL);
  if (fdt::canon_table(meta, packed, dtab.data(), 0, 1)) {
    for (int64_t lane = 0; lane < L; ++lane) {
      bpos[lane] = fdt::decode_canon_lane(win + lane * wwin, wwin, meta,
          meta + 16, packed, (uint32_t*)(out + lane * 4 * T), T);
      stats[4] += 1;
    }
    return;
  }
  if (m == 0) m = fdt::dec_threads(4 * T), tcap = 0;
  if (tcap == 0) tcap = fdt::dec_tile(m);
  std::vector<uint8_t> tile(tcap + 16);
  std::vector<uint32_t> sw(fdt::dec_words(31, tcap));
  fdt::HostGroup g{m, hnum, hden, stats};
  for (int64_t lane = 0; lane < L; ++lane)
    fdt::decode2_group(g, win, wwin, nullptr, 4 * T, 1, lane, dtab.data(),
                       tcap, tile.data(), sw.data(), out, bpos);
}
// K9's group code with HostGroup, m threads to a lane.
extern "C" void pack_v1_lanes(const int32_t* tok, uint32_t* win, int L, int S,
    int wwin, int m) {
  alignas(16) uint32_t buf[fdt::kPackWords];
  fdt::HostGroup g{m};
  for (int64_t lane = 0; lane < L; ++lane)
    fdt::pack_v1_group(g, tok, S, lane, buf, win, wwin);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the lane code for the host")
    d = tmp_path_factory.mktemp("lanes")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "liblanes.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.validate_lanes.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    return lib


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _case(seed: int):
    """Random geometry, zero density, run structure and ragged lengths."""
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 4))
    C = int(rng.choice([1, 2, 4, 8]))
    N = C * 8 * int(rng.integers(1, 80))
    kind = seed % 4
    if kind == 1:
        d = rng.integers(-8, 8, (B, N))
    else:
        d = rng.integers(1, 256, (B, N))
    d = np.where(rng.random((B, N)) < rng.random(), 0, d).astype(np.uint8)
    if kind == 3:
        for b in range(B):
            s = int(rng.integers(0, N))
            d[b, s : s + int(rng.integers(1, 800))] = 0
    lengths = np.full(B, N, np.int32)
    if seed % 2:
        lengths = rng.integers(0, N + 1, B).astype(np.int32)
    for b in range(B):
        d[b, lengths[b]:] = 0
    return torch.from_numpy(d), torch.from_numpy(lengths), C


SEEDS = range(0, 48, 6)


def _assign_pack_warp(lib, data, lengths, C, t, m):
    B, N = data.shape
    ww = wwin(N // C)
    win = torch.empty(B * C, ww, dtype=torch.int32)
    bits = torch.empty(B * C, dtype=torch.int32)
    data, lengths = data.contiguous(), lengths.to(torch.int32).contiguous()
    lib.assign_pack_warp(_ptr(data), _ptr(lengths), _ptr(t.lit_tok),
                         _ptr(t.len_tok), _ptr(win), _ptr(bits), B, N, C, ww,
                         m)
    return win, bits


def _check_assign_pack(lib, data, lengths, C, t, m, label):
    win, bits = _assign_pack_warp(lib, data, lengths, C, t, m)
    want_win, want_bits = assign_pack_plain(data, lengths, C, t)
    assert torch.equal(bits, want_bits), label
    assert torch.equal(win, want_win), label


def _decode_warp(lib, words, starts, dtab, N, C, m, hint=(1, 1), tcap=2048):
    """K3's group code on the host, m threads to a lane and ``tcap`` output
    bytes staged per lane (0: the kernel's for m): (out, bpos, stats)."""
    B, W = words.shape
    out = torch.empty(B, N, dtype=torch.uint8)
    bpos = torch.empty(B, C, dtype=torch.int32)
    stats = torch.zeros(4, dtype=torch.int64)
    words = words.to(torch.int32).contiguous()
    starts = starts.to(torch.int32).contiguous()
    lib.decode_warp(_ptr(words), _ptr(starts), _ptr(dtab.contiguous()),
                    _ptr(out), _ptr(bpos), B, W, N, C, m, tcap,
                    ctypes.c_int64(hint[0]), ctypes.c_int64(hint[1]),
                    _ptr(stats))
    return out, bpos, stats


def _check_decode(lib, words, starts, dtab, N, C, m, label, hint=(1, 1),
                  want_data=None, tcap=2048):
    """m = 0: the kernel's geometry for S (its m and staged tile)."""
    if m == 0:
        m, tcap = lib.dec_threads(N // C), 0
    out, bpos, stats = _decode_warp(lib, words, starts, dtab, N, C, m, hint,
                                    tcap)
    want_out, want_bpos = decode2_plain(words, starts, dtab, N, C)
    assert torch.equal(bpos, want_bpos), label
    assert torch.equal(out, want_out), label
    if want_data is not None:
        assert torch.equal(out, want_data), label
    assert int(stats[0]) <= m, label      # sync rounds: at most one per thread
    return stats


def _corrupt(words, total_bits, seed, B):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        b = int(rng.integers(0, B))
        j = int(rng.integers(14, max(15, int(total_bits[b]) // 32)))
        words[b, j] ^= int(rng.integers(1, 2**31))
    return words


@pytest.mark.parametrize("seed0", SEEDS)
def test_assign_pack_lane_matches_plain(lib, seed0):
    """K1's warp (32 threads) on the random seeds."""
    t = trained_tables()
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        _check_assign_pack(lib, data, lengths, C, t, 32, seed)


@pytest.mark.parametrize("seed0", SEEDS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode_lane_matches_plain(lib, seed0, corrupt):
    """K3's warp (32 threads) on the random seeds, clean and corrupted."""
    t = trained_tables()
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        B, N = data.shape
        words, total_bits, _ad, starts, _eof = encode_fixed(
            data, lengths, C)
        if corrupt:
            words = _corrupt(words, total_bits, seed, B)
        _check_decode(lib, words, starts, t.dtab, N, C, 32, seed,
                      want_data=None if corrupt else data)


THREADS = (1, 2, 5)   # besides the card's 32, run by the tests above
# K3 also at the kernel's own geometry for each S (m = 0: dec_threads(S)
# threads and dec_tile(m) staged bytes per lane).
KERNEL_M = pytest.param(0, id="kernel")


@pytest.mark.parametrize("m", THREADS)
@pytest.mark.parametrize("seed0", SEEDS)
def test_assign_pack_warp_threads(lib, m, seed0):
    """K1's per-thread pieces with m threads to a lane."""
    t = trained_tables()
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        _check_assign_pack(lib, data, lengths, C, t, m, seed)


@pytest.mark.parametrize("m", THREADS + (KERNEL_M,))
@pytest.mark.parametrize("seed0", SEEDS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode_warp_threads(lib, m, seed0, corrupt):
    """K3's group code with m threads to a lane, and at the kernel's own
    choice of m for each S."""
    t = trained_tables()
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        B, N = data.shape
        words, total_bits, _ad, starts, _eof = encode_fixed(
            data, lengths, C)
        if corrupt:
            words = _corrupt(words, total_bits, seed, B)
        _check_decode(lib, words, starts, t.dtab, N, C, m, seed,
                      want_data=None if corrupt else data)


K1_EDGES = [e[0] for e in k1_edge_inputs()]


@pytest.mark.parametrize("m", (1, 2, 5, 32))
@pytest.mark.parametrize("label", K1_EDGES)
def test_assign_pack_warp_edges(lib, m, label):
    """Runs of 258n-1..258n+1 on segment and tile edges, whole-segment and
    whole-tile runs, the ragged lane, lanes past the length, runs at k = 0,
    S = 8, all zeros and no runs at all."""
    (_l, d, lens, C), = [e for e in k1_edge_inputs() if e[0] == label]
    _check_assign_pack(lib, torch.from_numpy(d),
                       torch.tensor(lens, dtype=torch.int32), C,
                       trained_tables(), m, label)


@pytest.mark.parametrize("m", (5, 32))
def test_assign_pack_warp_long_lane(lib, m):
    """One 1 MiB lane (C = 1): 512 tiles, carries across every tile edge."""
    label, d, lens, C = k1_long_lane()
    _check_assign_pack(lib, torch.from_numpy(d),
                       torch.tensor(lens, dtype=torch.int32), C,
                       trained_tables(), m, label)


def _edge_streams(label):
    """(data, lengths, C, words, total_bits, starts) of a K1 edge batch."""
    (_l, d, lens, C), = [e for e in k1_edge_inputs() if e[0] == label]
    data = torch.from_numpy(d)
    lengths = torch.tensor(lens, dtype=torch.int32)
    words, total_bits, _ad, starts, _eof = encode_fixed(
        data, lengths, C)
    return data, lengths, C, words, total_bits, starts


def _decode_edge_cases(kind):
    """[(label, words, starts, dtab, N, C, hint, want_data)] for one kind."""
    t = trained_tables()
    cases = []
    if kind in ("clean", "corrupted at 64 words", "hint too short",
                "hint too long"):
        for label in K1_EDGES:
            data, lengths, C, words, tb, starts = _edge_streams(label)
            want = data
            if kind == "corrupted at 64 words":
                words, want = corrupt_words(words, tb, 64, seed=len(label)), None
            hint = {"hint too short": (1, 64), "hint too long": (64, 1)}.get(
                kind, (1, 1))
            cases.append((label, words, starts, t.dtab, data.shape[1], C, hint,
                          want))
    elif kind == "EOB spliced mid-lane":
        for label in K1_EDGES[1:]:
            data, lengths, C, words, tb, starts = _edge_streams(label)
            S = data.shape[1] // C
            for lane in (0, 1, C * data.shape[0] - 1):
                if int(lengths[lane // C]) - (lane % C) * S <= S // 2 + 8:
                    continue
                bit = mid_lane_bit(data, lengths, C, t, starts, lane)
                w = splice_eob(words, bit, lane // C, t.eof_code, t.eof_bits)
                cases.append((f"{label} lane {lane}", w, starts, t.dtab,
                              data.shape[1], C, (1, 1), None))
    elif kind == "S = 4":
        data, lengths, C, words, tb, starts = _edge_streams("S = 8")
        win, _b = assign_pack_plain(data, lengths, C, t)
        cases.append(("windows read 4 bytes", win,
                      torch.zeros(win.shape[0], 1, dtype=torch.int32), t.dtab,
                      4, 1, (1, 1), None))
        rng = np.random.default_rng(44)
        B, N = data.shape
        st = np.sort(rng.integers(0, int(tb.min()), (B, N // 4)), axis=1)
        cases.append(("linear, random starts", words,
                      torch.from_numpy(st.astype(np.int32)), t.dtab, N,
                      N // 4, (1, 1), None))
    elif kind == "random starts":
        data, lengths, C, words, tb, starts = _edge_streams(K1_EDGES[2])
        rng = np.random.default_rng(45)
        st = rng.integers(0, int(tb.max()) + 64, starts.shape)
        cases.append(("unordered random starts", words,
                      torch.from_numpy(st.astype(np.int32)), t.dtab,
                      data.shape[1], C, (1, 1), None))
    elif kind == "adaptive tree, corrupted windows":
        from fdeflate_tpu_torch.ops.adaptive import encode_adaptive_blocked
        data = torch.from_numpy(make_idat_corpus(2, 8192, seed=46))
        lengths = torch.tensor([8192, 6001], dtype=torch.int32)
        data[1, 6001:] = 0
        clean, _cb, _ad, _lens, ta = encode_adaptive_blocked(data, lengths, 4)
        win = clean.clone()
        rng = np.random.default_rng(47)
        for _ in range(6):
            win[int(rng.integers(0, 8)), int(rng.integers(0, win.shape[1]))] ^= (
                int(rng.integers(1, 2**31)))
        zero = torch.zeros(win.shape[0], 1, dtype=torch.int32)
        cases.append(("adaptive windows, clean", clean, zero, ta.dtab, 2048, 1,
                      (1, 1), data.reshape(8, 2048)))
        cases.append(("adaptive windows, corrupted", win, zero, ta.dtab, 2048,
                      1, (1, 1), None))
    elif kind == "several tiles":
        data = torch.from_numpy(make_idat_corpus(2, 16384, seed=48))
        lengths = torch.tensor([16384, 9999], dtype=torch.int32)
        data[1, 9999:] = 0
        words, tb, _ad, starts, _eof = encode_fixed(data, lengths, 2)
        cases.append(("S = 8192, clean", words, starts, t.dtab, 16384, 2,
                      (1, 1), data))
        cases.append(("S = 8192, corrupted", corrupt_words(words, tb, 64, 49),
                      starts, t.dtab, 16384, 2, (1, 1), None))
        cases.append(("S = 8192, short hint", words, starts, t.dtab, 16384, 2,
                      (1, 100), data))
    return cases


DECODE_EDGES = ("clean", "corrupted at 64 words", "hint too short",
                "hint too long", "EOB spliced mid-lane", "S = 4",
                "random starts", "adaptive tree, corrupted windows",
                "several tiles")


@pytest.mark.parametrize("m", (1, 2, 5, 32, KERNEL_M))
@pytest.mark.parametrize("kind", DECODE_EDGES)
def test_decode_warp_edges(lib, m, kind):
    """K3's warp on the K1 edge batches (clean, corrupted at 64 words per
    stream, with a hint 64x too short or too long), EOB spliced into a
    lane, S = 4, random chunk starts, an adaptive tree's windows whose
    zero bits decode to bytes, and lanes of several tiles."""
    short = 0
    for label, words, starts, dtab, N, C, hint, want in _decode_edge_cases(kind):
        stats = _check_decode(lib, words, starts, dtab, N, C, m,
                              f"{kind}: {label}", hint, want)
        short += int(stats[2])
    if kind == "hint too short":
        assert short > 0      # spans that fell short were followed on


def test_decode_warp_resynchronises(lib):
    """With the index's hint, the 32 threads of a clean lane agree within
    a few sync rounds (the design's premise, not its correctness)."""
    t = trained_tables()
    data = torch.from_numpy(make_idat_corpus(4, 1 << 16, seed=50))
    lengths = torch.full((4,), 1 << 16, dtype=torch.int32)
    words, _tb, _ad, starts, _eof = encode_fixed(data, lengths, 32)
    out, bpos, stats = _decode_warp(lib, words, starts, t.dtab, 1 << 16, 32,
                                    32)
    assert torch.equal(out, data)
    assert int(stats[0]) <= 4, stats


def test_dec_threads(lib):
    """K3's threads per lane: ~64 output bytes each, a power of two, at
    most a warp."""
    S = (4, 8, 64, 68, 128, 256, 512, 1024, 1028, 2048, 4096, 1 << 20)
    assert [lib.dec_threads(s) for s in S] == [1, 1, 1, 2, 2, 4, 8, 16, 32,
                                                32, 32, 32]


@pytest.mark.parametrize("C", (256, 512, 1024))
def test_decode_warp_resynchronises_short_lanes(lib, C):
    """At S = 256..1024 the kernel's m threads per lane (4..16, ~64 bytes
    each) agree within a few sync rounds, as 32 do at S = 2048."""
    t = trained_tables()
    data = torch.from_numpy(make_idat_corpus(2, 1 << 18, seed=51))
    lengths = torch.full((2,), 1 << 18, dtype=torch.int32)
    words, _tb, _ad, starts, _eof = encode_fixed(data, lengths, C)
    out, bpos, stats = _decode_warp(lib, words, starts, t.dtab, 1 << 18, C,
                                    lib.dec_threads((1 << 18) // C), tcap=0)
    assert torch.equal(out, data)
    assert int(stats[0]) <= 4, stats


@pytest.mark.parametrize("seed0", SEEDS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode_sep_lane_matches_plain(lib, seed0, corrupt):
    """K6's serial path (``decode_sep_lane``: its word steps, entries from
    ``sep_entry``) on septree streams, ragged and empty lanes (EOB met
    mid-lane or first, decoding on past it) and corrupted words."""
    tree = sep_profile()
    meta, vals = sep_tables(tree.lens)
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        B, N = data.shape
        if (N // C) % 4:
            continue
        words, total_bits, _ad, starts, _eof = encode_fixed(
            data, lengths, C, tree=tree)
        if corrupt:
            rng = np.random.default_rng(seed)
            for _ in range(3):
                b = int(rng.integers(0, B))
                j = int(rng.integers(10, max(11, int(total_bits[b]) // 32)))
                words[b, j] ^= int(rng.integers(1, 2**31))
        W = words.shape[1]
        out = torch.empty(B, N, dtype=torch.uint8)
        bpos = torch.empty(B, C, dtype=torch.int32)
        starts = starts.contiguous()
        lib.decode_sep_lanes(_ptr(words), _ptr(starts), _ptr(meta),
                             _ptr(vals), _ptr(out), _ptr(bpos), B, W, N, C)
        want_out, want_bpos = decode_sep_plain(words, starts, meta, vals, N, C)
        assert torch.equal(bpos, want_bpos), seed
        assert torch.equal(out, want_out), seed
        if not corrupt:
            assert torch.equal(out, data), seed


def _random_sep_lens(seed: int) -> np.ndarray:
    """A random complete class-separated tree: literals of random weight
    at most 11 bits, EOB and the length symbols at 12 (``ops/septree``'s
    construction with other weights)."""
    from fdeflate_tpu_torch.huffman import compute_code_lengths

    rng = np.random.default_rng(seed)
    freqs = np.ones(286, np.uint64)
    freqs[:256] = rng.integers(1, 1 << int(rng.integers(4, 24)), 256)
    min_l = np.ones(286, np.int64)
    max_l = np.full(286, 11, np.int64)
    min_l[256:] = max_l[256:] = 12
    return np.asarray(compute_code_lengths(freqs, min_l, max_l), np.int64)


@pytest.mark.parametrize("tree", ["sep_profile", 0, 1, 2, 3])
def test_sep_entry_matches_decode_table(lib, tree):
    """K6's table entry (``fdt::sep_entry``, from the sep rows), for all
    4096 peeks, equals ``trees.decode_table`` of the tree's lengths."""
    lens = sep_profile().lens if tree == "sep_profile" else _random_sep_lens(tree)
    meta, vals = sep_tables(lens)
    got = torch.empty(4096, dtype=torch.int32)
    lib.sep_entries(_ptr(meta), _ptr(vals), _ptr(got))
    assert torch.equal(got, decode_table(torch.from_numpy(lens)))


def _sep_warp(lib, words, starts, meta, vals, N, C, m, hint=(1, 1)):
    """K6's group code on the host, m threads to a lane with 2048 staged
    output bytes (m = 0: the kernel's m and tile for S): (out, bpos,
    stats, m)."""
    B, W = words.shape
    tcap = 2048
    if m == 0:
        m, tcap = lib.dec_threads(N // C), 0
    out = torch.empty(B, N, dtype=torch.uint8)
    bpos = torch.empty(B, C, dtype=torch.int32)
    stats = torch.zeros(5, dtype=torch.int64)
    lib.decode_sep_warp(_ptr(words.to(torch.int32).contiguous()),
                        _ptr(starts.to(torch.int32).contiguous()), _ptr(meta),
                        _ptr(vals), _ptr(out), _ptr(bpos), B, W, N, C, m,
                        tcap, ctypes.c_int64(hint[0]),
                        ctypes.c_int64(hint[1]), _ptr(stats))
    return out, bpos, stats, m


def _check_sep(lib, words, starts, meta, vals, N, C, m, label, hint=(1, 1),
               want_data=None, plain=None):
    """K6's group code against the plain version (``plain``: its result,
    if known): bytes, exit bits, and the serial lanes exactly those whose
    decode meets an EOB."""
    out, bpos, stats, m = _sep_warp(lib, words, starts, meta, vals, N, C, m,
                                    hint)
    want_out, want_bpos, eob = plain or decode_sep_plain_eob(
        words, starts, meta, vals, N, C)
    assert torch.equal(bpos, want_bpos), label
    assert torch.equal(out, want_out), label
    if want_data is not None:
        assert torch.equal(out, want_data), label
    assert int(stats[4]) == int(eob.sum()), label
    assert int(stats[0]) <= m, label      # sync rounds: at most one per thread
    return stats


@pytest.mark.parametrize("m", THREADS + (32, KERNEL_M))
@pytest.mark.parametrize("seed0", SEEDS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode_sep_warp_threads(lib, m, seed0, corrupt):
    """K6's group code (K3's protocol, EOB lanes serial) with m threads to
    a lane on septree streams: ragged and empty lanes (whose decode meets
    the EOF token) and corrupted words."""
    tree = sep_profile()
    meta, vals = sep_tables(tree.lens)
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        B, N = data.shape
        if (N // C) % 4:
            continue
        words, total_bits, _ad, starts, _eof = encode_fixed(
            data, lengths, C, tree=tree)
        if corrupt:
            words = _corrupt(words, total_bits, seed, B)
        _check_sep(lib, words, starts, meta, vals, N, C, m, seed,
                   want_data=None if corrupt else data)


SEP_HINTS = {"hint 64x too short": (1, 64), "hint 64x too long": (64, 1)}
_K6_CASES = {}


def _k6_cases(label):
    """``k6_edge_cases`` of a K1 edge batch with their plain results,
    computed once (the plain K6 loops once per sub-step)."""
    if label not in _K6_CASES:
        (_l, d, lens, C), = [e for e in k1_edge_inputs() if e[0] == label]
        cases = k6_edge_cases(torch.from_numpy(d),
                              torch.tensor(lens, dtype=torch.int32), C,
                              sep_profile())
        _K6_CASES[label] = [c + (decode_sep_plain_eob(*c[1:7]),)
                            for c in cases]
    return _K6_CASES[label]


@pytest.mark.parametrize("m", THREADS + (32, KERNEL_M))
@pytest.mark.parametrize("kind", K1_EDGES + list(SEP_HINTS))
def test_decode_sep_warp_edges(lib, m, kind):
    """K6's group code on the K1 edge batches encoded with the sep tree
    (``edges.k6_edge_cases``): clean (ragged streams meet their EOF), 64
    words corrupted per stream, an EOB spliced at each of the four
    sub-step positions of a word, at a lane's first symbol, at its second
    tile's first symbol (runs crossing that tile edge) and at its last
    symbol, random unordered starts; and every batch's cases with the span
    hint 64x too short or too long."""
    labels = K1_EDGES if kind in SEP_HINTS else [kind]
    serial = short = 0
    for label in labels:
        cases = _k6_cases(label)
        if kind not in SEP_HINTS:
            subs = {c[0] for c in cases if "sub-step" in c[0]}
            assert len(subs) == 4 or label.startswith("all zeros"), subs
        for case, words, starts, meta, vals, N, Ck, want, plain in cases:
            stats = _check_sep(lib, words, starts, meta, vals, N, Ck, m,
                               f"{label}: {case}", SEP_HINTS.get(kind, (1, 1)),
                               want, plain)
            serial += int(stats[4])
            short += int(stats[2])
    assert serial > 0                     # lanes that met an EOB went serial
    if kind == "hint 64x too short" and m != 1:
        assert short > 0


def test_decode_sep_warp_clean_lanes_stay_parallel(lib):
    """On full septree streams no lane meets an EOB: none is decoded
    serially, even where a last lane's threads decode into the EOF token
    speculatively, and 32 threads agree within a few sync rounds."""
    tree = sep_profile()
    meta, vals = sep_tables(tree.lens)
    data = torch.from_numpy(make_idat_corpus(4, 1 << 16, seed=52))
    lengths = torch.full((4,), 1 << 16, dtype=torch.int32)
    words, _tb, _ad, starts, _eof = encode_fixed(data, lengths, 32, tree=tree)
    out, bpos, stats, _m = _sep_warp(lib, words, starts, meta, vals, 1 << 16,
                                     32, 32)
    assert torch.equal(out, data)
    assert int(stats[4]) == 0 and int(stats[0]) <= 4, stats


@pytest.mark.parametrize("seed0", SEEDS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode_canon_lane_matches_plain(lib, seed0, corrupt):
    """K8's serial path (``decode_canon_lane``) on K1's windows: clean,
    ragged and empty lanes, and windows with flipped words (EOB stalls,
    runs over the lane end)."""
    meta, packed = canon_tables()
    for seed in range(seed0, seed0 + 6):
        case = _canon_case(seed, corrupt)
        if case is None:
            continue
        win, T, want_out, want_bpos, data = case
        L, ww = win.shape
        out = torch.empty(L, 4 * T, dtype=torch.uint8)
        bpos = torch.empty(L, dtype=torch.int32)
        lib.decode_canon_lanes(_ptr(win), _ptr(meta), _ptr(packed), _ptr(out),
                               _ptr(bpos), L, ww, T)
        assert torch.equal(bpos, want_bpos), seed
        assert torch.equal(out, want_out), seed
        if not corrupt:
            assert torch.equal(out.reshape(data.shape), data), seed


_CANON_CASES = {}


def _canon_case(seed: int, corrupt: bool):
    """K1's windows of ``_case(seed)`` (None where S % 4), 4 words flipped
    if ``corrupt``, with K8's plain result, computed once:
    (win, T, out, bpos, data)."""
    if (seed, corrupt) not in _CANON_CASES:
        data, lengths, C = _case(seed)
        B, N = data.shape
        S = N // C
        case = None
        if S % 4 == 0:
            win, _bits = assign_pack_plain(data, lengths, C, trained_tables())
            if corrupt:
                rng = np.random.default_rng(seed)
                for _ in range(4):
                    win[int(rng.integers(0, B * C)), int(rng.integers(
                        0, win.shape[1]))] ^= int(rng.integers(1, 2**31))
            meta, packed = canon_tables()
            case = (win, S // 4) + decode2_canon_plain(win, S // 4, meta,
                                                       packed) + (data,)
        _CANON_CASES[seed, corrupt] = case
    return _CANON_CASES[seed, corrupt]


@pytest.mark.parametrize("seed0", SEEDS)
def test_pack_v1_lane_matches_plain(lib, seed0):
    """K9's group code (a warp to a lane, as the kernel runs it) on every
    lane's tokens and on random token words (garbage pairs, negative
    offsets)."""
    from fdeflate_tpu_torch.ops.assign_pack import assign_tokens

    t = trained_tables()
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        B, N = data.shape
        S = N // C
        if S > 630:
            continue
        v, nb, _ = assign_tokens(data, lengths, S, t)
        toks = [pack_tokens(v, nb, token_offsets(nb, C), C)]
        rng = np.random.default_rng(seed)
        toks.append(torch.from_numpy(rng.integers(
            -2**31, 2**31, (3, S), dtype=np.int64).astype(np.int32)))
        for tok in toks:
            L = tok.shape[0]
            ww = wwin(S) + seed % 3
            win = torch.empty(L, ww, dtype=torch.int32)
            lib.pack_v1_lanes(_ptr(tok.contiguous()), _ptr(win), L, S, ww,
                              32)
            assert torch.equal(win, pack_blocked_plain(tok, ww)), seed


_PACK_PLAIN = {}


def _pack_plain(tok: torch.Tensor, label: str, width: int) -> torch.Tensor:
    """``pack_blocked_plain(tok, width)``, computed once per source."""
    if (label, width) not in _PACK_PLAIN:
        _PACK_PLAIN[label, width] = pack_blocked_plain(tok, width)
    return _PACK_PLAIN[label, width]


@functools.lru_cache(maxsize=1)
def _pack_sources():
    """(label, tok int32[L, S]) K9 is held to its plain version on:
    ``pack_tokens`` of the K1 edge batches and of IDAT rows at S <= 512,
    and random token words."""
    from fdeflate_tpu_torch.ops.assign_pack import assign_tokens

    t = trained_tables()
    inputs = [(label, torch.from_numpy(d), torch.tensor(lens), C)
              for label, d, lens, C in k1_edge_inputs()]
    idat = torch.from_numpy(make_idat_corpus(2, 8192, seed=44))
    inputs.append(("idat", idat, torch.tensor([8192, 6001]), 16))
    out = []
    for label, d, lens, C in inputs:
        B, N = d.shape
        C = max(C, N // 512)
        S = N // C
        v, nb, _ = assign_tokens(d, lens.to(torch.int32), S, t)
        out.append((label, pack_tokens(v, nb, token_offsets(nb, C), C)))
    out.append(("random words, S = 512", k9_noise_tokens(512, 24, 45)))
    out.append(("random words, S = 630", k9_noise_tokens(630, 8, 46)))
    out.append(("random words, S = 2", k9_noise_tokens(2, 64, 47)))
    return out


@pytest.mark.parametrize("m", (1, 2, 5, 32))
@pytest.mark.parametrize("ww", ("1", "wwin(S)", "300"))
def test_pack_v1_warp_threads(lib, m, ww):
    """K9's group code (the pairs scattered into a shared window) with m
    threads to a lane, at window widths 1, ``wwin(S)`` and 300 (wider than
    the 257 words a pair can reach), on every token source: equal to the
    all-pairs plain version bit for bit."""
    from fdeflate_tpu_torch.ops.pack import _pairs

    reached = 0
    for label, tok in _pack_sources():
        L, S = tok.shape
        width = {"1": 1, "wwin(S)": wwin(S), "300": 300}[ww]
        win = torch.empty(L, width, dtype=torch.int32)
        lib.pack_v1_lanes(_ptr(tok.contiguous()), _ptr(win), L, S, width, m)
        assert torch.equal(win, _pack_plain(tok, label, width)), label
        wi, _lo, hi = _pairs(tok)
        reached += int(((wi == -1) & (hi != 0)).sum())
    assert reached > 0      # pairs before the window that reach word 0


def _canon_meta(lens) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's (meta int32[32], packed int32[512]) of a code-length vector."""
    from fdeflate_tpu_torch.trees import canonical_meta

    bounds, kvals, packed = canonical_meta(torch.from_numpy(lens))
    meta = torch.zeros(32, dtype=torch.int64)
    meta[:13], meta[16:29] = bounds, kvals
    return meta.to(torch.int32), packed.to(torch.int32)


@pytest.mark.parametrize("tree", ["trained", "sep_profile", 0, 1])
def test_canon_entry_matches_decode_table(lib, tree):
    """K8's table (``fdt::canon_table``: the compare chain once per peek,
    in K3's entry format) equals ``trees.decode_table`` for all 4096 peeks,
    and flags none of a canonical tree's entries."""
    lens = (np.asarray(HUFFMAN_LENGTHS, np.int64) if tree == "trained"
            else sep_profile().lens if tree == "sep_profile"
            else _random_sep_lens(tree))
    meta, packed = canon_tables() if tree == "trained" else _canon_meta(lens)
    got = torch.empty(4096, dtype=torch.int32)
    unsafe = lib.canon_entries(_ptr(meta), _ptr(packed), _ptr(got))
    assert torch.equal(got, decode_table(torch.from_numpy(lens)))
    assert unsafe == 0 and not canon_unsafe(meta, packed)


def _canon_warp(lib, win, meta, packed, T, m, hint=(1, 1)):
    """K8 as its kernel runs it, on the host (m = 0: the kernel's m and
    tile): (out, bpos, stats)."""
    L, ww = win.shape
    out = torch.empty(L, 4 * T, dtype=torch.uint8)
    bpos = torch.empty(L, dtype=torch.int32)
    stats = torch.zeros(5, dtype=torch.int64)
    lib.decode_canon_warp(_ptr(win.contiguous()), _ptr(meta), _ptr(packed),
                          _ptr(out), _ptr(bpos), L, ww, T, m, 2048,
                          ctypes.c_int64(hint[0]), ctypes.c_int64(hint[1]),
                          _ptr(stats))
    return out, bpos, stats


@pytest.mark.parametrize("m", THREADS + (32, KERNEL_M))
@pytest.mark.parametrize("seed0", SEEDS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode_canon_warp_matches_plain(lib, m, seed0, corrupt):
    """K8's redesign: K3's group code over each lane's window with the
    table of the trained tree's canonical rows, m threads to a lane, the
    span hint as computed and 64x too short or too long, on K1's windows
    (clean, ragged, empty lanes; flipped words: stalls, runs over the lane
    end): bytes and exit bits equal the plain version's, and no lane
    decoded serially."""
    meta, packed = canon_tables()
    for seed in range(seed0, seed0 + 6):
        case = _canon_case(seed, corrupt)
        if case is None:
            continue
        win, T, want_out, want_bpos, data = case
        for hint in ((1, 1), (1, 64), (64, 1)):
            out, bpos, stats = _canon_warp(lib, win, meta, packed, T, m, hint)
            assert torch.equal(bpos, want_bpos), (seed, hint)
            assert torch.equal(out, want_out), (seed, hint)
            assert int(stats[4]) == 0, (seed, hint)
            assert int(stats[0]) <= (m or 32), (seed, hint)
        if not corrupt:
            assert torch.equal(out.reshape(data.shape), data), seed


@pytest.mark.parametrize("kind", K8_UNSAFE)
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode_canon_warp_unsafe_tables(lib, kind, corrupt):
    """A table with a literal above 255 or a run of base below 3 is flagged
    (``canon_unsafe``, in the kernel's prologue and in the plain helper),
    every lane is decoded serially and counted in stats[4], and the result
    equals the plain version's, where K3's group decode with the same table
    would differ (literals above 255, runs of base 0)."""
    meta = canon_tables()[0]
    packed = k8_unsafe_packed(canon_tables()[1], kind)
    dtab = torch.empty(4096, dtype=torch.int32)
    assert lib.canon_entries(_ptr(meta), _ptr(packed), _ptr(dtab)) == 1
    assert canon_unsafe(meta, packed)
    differs = False
    for seed in (0, 8, 14, 22):
        data, lengths, C = _case(seed)
        B, N = data.shape
        S = N // C
        win, _bits = assign_pack_plain(data, lengths, C, trained_tables())
        if corrupt:
            win[::3, 1] ^= 0x5A5A5A5A
        out, bpos, stats = _canon_warp(lib, win, meta, packed, S // 4, 32)
        want_out, want_bpos = decode2_canon_plain(win, S // 4, meta, packed)
        assert torch.equal(bpos, want_bpos), seed
        assert torch.equal(out, want_out), seed
        assert int(stats[4]) == win.shape[0], seed
        k3 = _decode_warp(lib, win, torch.zeros(win.shape[0], 1), dtab, S, 1,
                          32)[:2]
        differs |= not (torch.equal(k3[0].reshape(out.shape), want_out)
                        and torch.equal(k3[1].reshape(-1), want_bpos))
    assert differs or kind == "run of base 2"


def _foreign_stream(seed: int) -> bytes:
    """A zlib stream of random kind, level and strategy."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 12000))
    kind = seed % 4
    if kind == 0:
        d = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    elif kind == 1:
        d = (rng.integers(0, 6, n) * 41).astype(np.uint8).tobytes()
    elif kind == 2:
        wp = [rng.bytes(int(rng.integers(2, 12))) for _ in range(40)]
        d = b"".join(wp[int(rng.integers(40))] for _ in range(n // 6))
    else:
        d = bytes(n // 3) + rng.bytes(n // 3) + bytes(n // 3)
    strat = [zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED, zlib.Z_HUFFMAN_ONLY,
             zlib.Z_RLE][(seed // 4) % 4]
    co = zlib.compressobj(int(rng.integers(1, 10)), zlib.DEFLATED, 15, 9, strat)
    return co.compress(d) + co.flush()


def _inflate_case(seed: int):
    """Lanes from the first compressed block of several streams, some
    corrupted, with random budgets, bit ends and output offsets."""
    rng = np.random.default_rng(seed)
    streams, tables, starts, ends, out0 = [], [], [], [], []
    for j in range(6):
        z = bytearray(_foreign_stream(seed * 8 + j))
        r = I._HostBitReader(bytes(z), 16)
        r.take(1)
        btype = r.take(2)
        if btype == 1:
            tables.append(fixed_meta_tab())
        elif btype == 2:
            lengths, hlit = I._parse_dynamic_lengths(r)
            tables.append(foreign_meta(lengths[:hlit], lengths[288:320]))
        else:
            continue
        if rng.random() < 0.4:
            for _ in range(int(rng.integers(1, 4))):
                k = int(rng.integers(r.pos // 8, len(z)))
                z[k] ^= int(rng.integers(1, 256))
        streams.append(bytes(z))
        starts.append(r.pos)
        cut = rng.random()
        ends.append(NO_LIMIT if cut < 0.5 else int(
            rng.integers(r.pos, len(z) * 8 + 1)))
        out0.append(NO_LIMIT if rng.random() < 0.5 else int(
            rng.integers(-300, 40)))
    # a fixed block holding symbol 286 under foreign_meta's fixed table,
    # where it is an invalid literal/length code
    streams.append(b"\x78\x01\x4b\x1c\x03" + bytes(4))
    tables.append(I._fixed_foreign_meta())
    starts.append(19)
    # a block with matches decoded under a tree with no distance codes
    z = zlib.compress(b"the quick brown fox jumps over the lazy dog " * 80, 9)
    r = I._HostBitReader(z, 19)
    lengths, hlit = I._parse_dynamic_lengths(r)
    streams.append(z)
    tables.append(foreign_meta(lengths[:hlit], np.zeros(30, np.int64)))
    starts.append(r.pos)
    ends += [NO_LIMIT] * 2
    out0 += [NO_LIMIT] * 2
    # the same block at the edges of the two checks: its last bit exactly
    # at bit_end and one past it; its first match's distance exactly
    # out0 + the bytes before it, and one more
    meta, tab = foreign_meta(lengths[:hlit], lengths[288:320])
    w = torch.from_numpy(pad_words([z])[0])
    one = torch.tensor([r.pos], dtype=torch.int64)
    recs, end, _n, _d = inflate_records_plain(
        w, one, torch.tensor([w.numel()]), one + NO_LIMIT, one * 0 + NO_LIMIT,
        torch.from_numpy(meta)[None], torch.from_numpy(tab)[None], 4096)
    kind = recs[:, 0].numpy() >> 28
    first = int(np.flatnonzero(kind == 2)[0])
    before = int(((recs[:first, 0] >> 16) & 3).sum())
    edge = (int(recs[first, 0]) & 0x7FFF) + 1 - before
    for e, o in ((int(end[0]), NO_LIMIT), (int(end[0]) - 1, NO_LIMIT),
                 (NO_LIMIT, edge), (NO_LIMIT, edge - 1)):
        streams.append(z)
        tables.append((meta, tab))
        starts.append(r.pos)
        ends.append(e)
        out0.append(o)
    words, base = pad_words(streams)
    L = len(streams)
    lane = {
        "start": torch.from_numpy(base[:L] * 32 + np.array(starts)),
        "wend": torch.from_numpy(base[1:]),
        "bit_end": torch.tensor([min(e, NO_LIMIT) + (base[i] * 32 if e <
                                 NO_LIMIT else 0) for i, e in enumerate(ends)],
                                dtype=torch.int64),
        "out0": torch.tensor(out0, dtype=torch.int64),
    }
    meta, tab = pack_tables(tables, "cpu")
    return torch.from_numpy(words), lane, meta, tab, int(rng.integers(16, 3000))


def _inflate_warp(lib, args, K, m, hint=(1, 1)):
    """K4's group code on the host, m threads to a lane (0: the kernel's
    choice): (recs, bpos, nout, done), stats."""
    words, start, wend, bit_end, out0, meta, tab = args
    L = start.numel()
    recs = torch.zeros(K, L, dtype=torch.int32)
    bpos = torch.empty(L, dtype=torch.int64)
    nout = torch.empty(L, dtype=torch.int64)
    done = torch.empty(L, dtype=torch.int32)
    stats = torch.zeros(4, dtype=torch.int64)
    lane = [x.to(torch.int64).contiguous() for x in (start, wend, bit_end, out0)]
    lane[1] = lane[1].clamp(max=words.numel())
    lib.inflate_warp(_ptr(words.to(torch.int32).contiguous()),
                     *(_ptr(x) for x in lane), _ptr(meta.contiguous()),
                     _ptr(tab.contiguous()), _ptr(recs), _ptr(bpos),
                     _ptr(nout), _ptr(done), L, K, m,
                     ctypes.c_int64(hint[0]), ctypes.c_int64(hint[1]),
                     _ptr(stats))
    return (recs, bpos, nout, done), stats


@pytest.mark.parametrize("seed", range(8))
def test_inflate_lane_matches_plain(lib, seed):
    """K4's group code with one thread per lane (the serial decode) on
    random streams, corruption, budgets, bit ends and output offsets."""
    words, lane, meta, tab, K = _inflate_case(seed)
    args = (words, lane["start"], lane["wend"], lane["bit_end"], lane["out0"],
            meta, tab)
    got, _stats = _inflate_warp(lib, args, K, 1)
    want = inflate_records_plain(*args, K)
    for g, exp in zip(got, want):
        assert torch.equal(g, exp), seed


_K4_PLAIN = {}


def _k4_case(kind):
    """A kind of K4 edge input and its plain result, computed once (the
    plain K4 loops once per record step)."""
    if kind not in _K4_PLAIN:
        args, K = k4_edge_case(kind)
        _K4_PLAIN[kind] = (args, K, inflate_records_plain(*args, K))
    return _K4_PLAIN[kind]


K4_HINTS = {"hint 64x too short": (1, 64), "hint 64x too long": (64, 1)}


@pytest.mark.parametrize("m", (1, 2, 5, 32, KERNEL_M))
@pytest.mark.parametrize("kind", K4_KINDS + tuple(K4_HINTS))
def test_inflate_warp_edges(lib, m, kind):
    """K4's group code, m threads to a lane, on zlib streams at levels 1, 6
    and 9, IDAT and Huffman-only (runs of literal pairs), blocks of a few
    thousand records, every lane block discovery finds (false candidates
    included): as they are, with corrupted words, too few slots, out0 = 0
    (too far), bit_end inside the blocks, random starts, and hints 64x too
    short or too long."""
    args, K, want = _k4_case("blocks" if kind in K4_HINTS else kind)
    got, stats = _inflate_warp(lib, args, K, m, K4_HINTS.get(kind, (1, 1)))
    for name, g, exp in zip(("recs", "bpos", "nout", "done"), got, want):
        assert torch.equal(g, exp), (kind, name)
    assert int(stats[0]) <= max(m, 32), stats   # a round per thread at most
    if kind == "hint 64x too short" and m != 1:
        assert int(stats[2]) > 0      # spans that fell short were followed on


def test_inflate_edge_exit_codes():
    """The K4 edge inputs end lanes with every exit code: 0 (slots), 1
    (EOB), 2 and 3 (invalid codes), 4 (truncated), 5 (too far)."""
    codes = set()
    for kind in K4_KINDS:
        codes |= set(_k4_case(kind)[2][3].tolist())
    assert codes == {0, 1, 2, 3, 4, 5}, codes


def test_inflate_warp_resynchronises(lib):
    """With the next lane's start as hint, 32 threads on a real block agree
    within a few sync rounds (the design's premise, not its correctness)."""
    args, K, want = _k4_case("blocks")
    got, stats = _inflate_warp(lib, args, K, 32)
    assert torch.equal(got[0], want[0])
    assert int(stats[3]) <= 4 * int(stats[1]), stats


def test_inf_threads(lib):
    """K4's threads per lane: ~1024 hinted bits each, a power of two, at
    most a warp."""
    bits = (-5, 0, 1024, 1025, 4096, 20000, 31 * 1024, 32 * 1024 + 1, 1 << 40)
    assert [lib.inf_threads(ctypes.c_int64(b)) for b in bits] == [
        1, 1, 1, 2, 4, 32, 32, 32, 32]


@pytest.mark.parametrize("m", (1, 2, 5, 32))
@pytest.mark.parametrize("case", range(len(k2_edge_cases())))
def test_combine_warp_edges(lib, m, case):
    """K2's group code, m threads to a lane, on its edge inputs: lanes of 0
    bits, lanes shorter than a word, word-aligned starts, the last word's
    high half at W, trailing words, a random mix.  Every word is written:
    the buffer starts as noise."""
    label, win, bits, pos0, B, W = k2_edge_cases()[case]
    C = bits.numel() // B
    words = torch.full((B, W), -0x5A5A5A5B, dtype=torch.int32)
    lib.combine_warp(_ptr(win), _ptr(bits), _ptr(pos0), _ptr(words), B, C,
                     win.shape[1], W, m)
    assert torch.equal(words, combine_plain(win, bits, pos0, B, W)), label


@pytest.mark.parametrize("seed0", SEEDS)
def test_combine_warp_matches_plain(lib, seed0):
    """K2's warp on K1's windows of the random seeds, lanes placed by
    ``lane_starts`` after headers of 0..95 bits."""
    t = trained_tables()
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        B, N = data.shape
        win, bits = assign_pack_plain(data, lengths, C, t)
        pos0 = lane_starts(bits, B, C, seed * 7 % 96)[0].reshape(-1).to(
            torch.int32)
        W = stream_words(N, t)
        words = torch.full((B, W), 77, dtype=torch.int32)
        lib.combine_warp(_ptr(win), _ptr(bits), _ptr(pos0), _ptr(words), B, C,
                         win.shape[1], W, 32)
        assert torch.equal(words, combine_plain(win, bits, pos0, B, W)), seed


# K7's rows: (B, n, row stride, offset of row 0 in the buffer, lengths).
# Unaligned rows and strides put a row's first and last bytes inside
# 16-byte chunks shared with noise that must not count.
K7_CASES = {
    "ragged lengths 0, 1, 1023, 1025, n, unaligned": (
        6, 5000, 5007, 3, [0, 1, 1023, 1025, 5000, 3072]),
    "aligned rows, whole tiles": (2, 4096, 4096, 0, [4096, 2048]),
    "one unaligned row": (1, 70001, 70001, 13, [69996]),
    "rows shorter than a chunk": (3, 9, 25, 1, [9, 5, 0]),
    "no bytes": (2, 0, 16, 0, [0, 0]),
}


def _adler32_warp(lib, case, m):
    """K7's tile and fold code on the host for one K7_CASES case: (rows
    u8[B, n] as a strided view of a noisy buffer, lengths, checksums,
    sums, wsums)."""
    B, n, stride, off, lens = K7_CASES[case]
    rng = np.random.default_rng(n + off)
    buf = torch.from_numpy(rng.integers(0, 256, B * stride + off + 64,
                                        dtype=np.uint8))
    rows = buf[off:off + B * stride].reshape(B, stride)[:, :n]
    lengths = torch.tensor(lens, dtype=torch.int64)
    T = -(-n // 1024)
    out = torch.empty(B, dtype=torch.int64)
    sums = torch.empty(B, T, dtype=torch.int32)
    wsums = torch.empty(B, T, dtype=torch.int32)
    lib.adler32_warp.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int64] + [
                                     ctypes.c_void_p] * 4 + [ctypes.c_int]
    lib.adler32_warp(ctypes.c_void_p(rows.data_ptr()), stride, B, n,
                     _ptr(lengths), _ptr(out), _ptr(sums), _ptr(wsums), m)
    return rows, lengths, out, sums, wsums


@pytest.mark.parametrize("m", (1, 2, 5, 32))
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_adler32_tile_warp_matches_plain(lib, m, case):
    """K7's group code, m threads to a tile, and its fold on rows that
    start and end inside 16-byte chunks of noise, lengths that end inside
    a tile (the tile's coefficient is negative before its residue is
    taken) and rows past their length: tile sums equal the plain
    version's, checksums the plain fold's, the plain batch's and
    zlib.adler32."""
    rows, lengths, out, sums, wsums = _adler32_warp(lib, case, m)
    want_s, want_w = adler32_tiles_plain(rows, lengths)
    assert torch.equal(sums, want_s) and torch.equal(wsums, want_w)
    assert torch.equal(out, adler32_checksums(rows, lengths))
    assert torch.equal(out, adler32_batch_plain(rows, lengths))
    for b, ln in enumerate(lengths.tolist()):
        assert int(out[b]) == zlib.adler32(rows[b, :ln].numpy().tobytes())


def _slab_cases():
    """K10's inputs: K2's edge cases, then K1's windows of two random
    seeds placed by ``lane_starts``."""
    cases = [c[1:] for c in k2_edge_cases()]
    t = trained_tables()
    for seed in (3, 8):
        data, lengths, C = _case(seed)
        B, N = data.shape
        win, bits = assign_pack_plain(data, lengths, C, t)
        pos0 = lane_starts(bits, B, C, 32037)[0].reshape(-1).to(torch.int32)
        cases.append((win, bits, pos0, B, 1024 + stream_words(N, t)))
    return cases


@pytest.mark.parametrize("m", (1, 2, 5, 32))
@pytest.mark.parametrize("case", range(len(k2_edge_cases()) + 2))
def test_slab_range_contains_slab_lanes(lib, m, case):
    """K10's lane search, m threads a round: each slab's range holds every
    lane of ``slab_lanes``' range for it (the plain search), inside the
    slab's stream."""
    win, bits, pos0, B, W = _slab_cases()[case]
    C = bits.numel() // B
    nslabs = -(-W // 1024)
    lo = torch.empty(B * nslabs, dtype=torch.int64)
    hi = torch.empty(B * nslabs, dtype=torch.int64)
    lib.slab_ranges_warp.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.slab_ranges_warp(_ptr(bits), _ptr(pos0), B, C, W, m, _ptr(lo),
                         _ptr(hi))
    want_lo, want_hi = (x.to(torch.int64) for x in slab_lanes(bits, pos0, B, W))
    stream = torch.arange(B * nslabs) // nslabs
    assert bool(((lo >= stream * C) & (hi <= (stream + 1) * C)
                 & (lo <= hi)).all())
    busy = want_lo < want_hi
    assert bool(((lo <= want_lo) & (hi >= want_hi))[busy].all())


def _combine_slabs(lib, win, bits, pos0, B, W, m, fill):
    words = torch.full((B, W), fill, dtype=torch.int32)
    lib.combine_slabs_warp(_ptr(win), _ptr(bits), _ptr(pos0), _ptr(words), B,
                           bits.numel() // B, win.shape[1], W, m)
    return words


@pytest.mark.parametrize("m", (1, 2, 5, 32))
@pytest.mark.parametrize("case", range(len(k2_edge_cases())))
def test_combine_slab_warp_edges(lib, m, case):
    """K10's group code, m threads to a slab, on K2's edge inputs (lanes
    of 0 bits, lanes shorter than a word, word-aligned starts, the last
    word's high half at W, trailing words, a mix): every word written (the
    buffer starts as noise), equal to the plain version.  At m < 32 a slab
    whose lanes do not fit one staging round ORs the later rounds in."""
    label, win, bits, pos0, B, W = k2_edge_cases()[case]
    got = _combine_slabs(lib, win, bits, pos0, B, W, m, -0x5A5A5A5B)
    assert torch.equal(got, combine_plain(win, bits, pos0, B, W)), label


@pytest.mark.parametrize("seed0", SEEDS)
@pytest.mark.parametrize("aligned", (True, False))
def test_combine_slab_warp_matches_plain(lib, seed0, aligned):
    """K10's group code at the card's m = 32 on K1's windows of the random
    seeds, lanes placed after headers of 0..95 bits, the windows 16-byte
    aligned (16-byte staging) or a view one word in (4-byte staging)."""
    t = trained_tables()
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        B, N = data.shape
        win, bits = assign_pack_plain(data, lengths, C, t)
        if not aligned:
            win = torch.cat([torch.full((1,), 9, dtype=torch.int32),
                             win.reshape(-1)])[1:].reshape(win.shape)
        pos0 = lane_starts(bits, B, C, seed * 7 % 96)[0].reshape(-1).to(
            torch.int32)
        W = stream_words(N, t)
        got = _combine_slabs(lib, win, bits, pos0, B, W, 32, 77)
        assert torch.equal(got, combine_plain(win, bits, pos0, B, W)), seed


def _validate_lanes(lib, words, cands, wend, n_bits, first=320):
    """K5's lane code on the host: (good bool[L], end int64[L])."""
    L = cands.numel()
    good = torch.empty(L, dtype=torch.int32)
    end = torch.empty(L, dtype=torch.int64)
    cols = [torch.broadcast_to(torch.as_tensor(x, dtype=torch.int64), (L,))
            .contiguous() for x in (cands, wend, n_bits)]
    lib.validate_lanes(_ptr(words.contiguous()), *(_ptr(x) for x in cols),
                       _ptr(good), _ptr(end), L, first)
    return good.bool(), end


def _k5_case(seed: int):
    """A stream (a random zlib stream, or random bytes) with its stage-1
    survivors and 500 random offsets (most with oversubscribed or
    incomplete code-length codes)."""
    z = _foreign_stream(seed) if seed % 3 else np.random.default_rng(
        seed).bytes(6000)
    rng = np.random.default_rng(seed)
    cands = np.unique(np.concatenate([
        scan_stage1(z), rng.integers(0, max(1, len(z) * 8 - 80), 500)]))
    return z, torch.from_numpy(pad_words([z])[0]), torch.from_numpy(
        cands.astype(np.int64))


@pytest.mark.parametrize("seed", range(6))
def test_validate_lane_matches_plain(lib, seed):
    z, words, c = _k5_case(seed)
    good, end = _validate_lanes(lib, words, c, words.numel(), len(z) * 8)
    want_good, want_end = validate_headers_plain(words, c, len(z) * 8)
    assert torch.equal(good, want_good)
    assert torch.equal(end, want_end)


@pytest.mark.parametrize("first", (0, 1, 32))
@pytest.mark.parametrize("seed", range(6, 12))
def test_validate_lane_resumes(lib, seed, first):
    """K5 as the kernel runs it: ``first`` sections, then the survivors
    resume from their state's bit with a new reader."""
    z, words, c = _k5_case(seed)
    good, end = _validate_lanes(lib, words, c, words.numel(), len(z) * 8,
                                first)
    want_good, want_end = validate_headers_plain(words, c, len(z) * 8)
    assert torch.equal(good, want_good)
    assert torch.equal(end, want_end)


def test_validate_lane_real_headers(lib):
    """The stage-1 survivors of multi-block zlib streams (text at levels 1,
    6, 9, IDAT, Huffman only): the dynamic block headers found good at
    their header ends, as the plain version finds them."""
    found = 0
    for _label, z in k4_streams():
        words = torch.from_numpy(pad_words([z])[0])
        c = torch.from_numpy(scan_stage1(z).astype(np.int64))
        good, end = _validate_lanes(lib, words, c, words.numel(), len(z) * 8)
        want = validate_headers_plain(words, c, len(z) * 8)
        assert torch.equal(good, want[0]) and torch.equal(end, want[1])
        found += int(good.sum())
    assert found >= 10


def _cl_chain(cl) -> list[int]:
    """validate_stage2's CL decode of every bit-reversed 7-bit peek: sym |
    L << 5, or 0xFF (the compare chain over bound/kval/order)."""
    cnt = [sum(1 for x in cl if x == n) for n in range(8)]
    bound, kval = [0] * 8, [0] * 8
    code = acc = 0
    for n in range(1, 8):
        bound[n] = (code + cnt[n]) << (7 - n)
        kval[n] = acc - code
        acc += cnt[n]
        code = (code + cnt[n]) << 1
    order = sorted(range(19), key=lambda s: (cl[s] if cl[s] else 99, s))
    out = []
    for r in range(128):
        L = 1 + sum(1 for n in range(1, 7) if r >= bound[n] and bound[n] < 128)
        idx = kval[L] + (r >> (7 - L))
        ok = 0 <= idx <= 18 and cl[order[idx]] == L
        out.append(order[idx] | L << 5 if ok else 0xFF)
    return out


def _cl_codes(kind: str, rng) -> list:
    if kind == "random lengths":          # oversubscribed, mostly
        return list(rng.integers(0, 8, 19))
    if kind == "sparse random lengths":
        return list(np.where(rng.random(19) < 0.8, 0, rng.integers(1, 8, 19)))
    from fdeflate_tpu_torch.huffman import build_huffman_tree
    freq = np.where(rng.random(19) < 0.3, 0, rng.integers(1, 1000, 19))
    freq[:2] = np.maximum(freq[:2], 1)
    cl = list(build_huffman_tree(freq.astype(np.int64), 7)[0][:19])
    if kind == "incomplete":              # a complete code less one symbol
        cl[int(np.flatnonzero(np.asarray(cl) > 0)[-1])] = 0
    return cl


@pytest.mark.parametrize("kind", ["random lengths", "sparse random lengths",
                                  "complete", "incomplete"])
def test_cl_table_matches_compare_chain(lib, kind):
    """K5's 128-entry CL table (canonical fill, the chain for an
    oversubscribed code) equals the compare chain of the plain version's
    definitions for every peek."""
    rng = np.random.default_rng(70)
    cls = [_cl_codes(kind, rng) for _ in range(200)]
    clp = torch.tensor([sum(int(x) << (3 * s) for s, x in enumerate(cl))
                        for cl in cls], dtype=torch.int64)
    out = torch.empty(len(cls), 128, dtype=torch.uint8)
    lib.cl_tables(_ptr(clp), _ptr(out), len(cls))
    for cl, row in zip(cls, out.tolist()):
        assert row == _cl_chain([int(x) for x in cl]), cl


def test_validate_lane_reads_only_its_stream(lib):
    """Candidates over two streams' concatenated words, each with its own
    stream's word end and payload end, give what each stream gives alone;
    the candidates at the first stream's end would read the second
    stream's words without their own word end."""
    a = _foreign_stream(20)
    b = np.random.default_rng(21).integers(1, 256, 4000, np.uint8).tobytes()
    words, c, wend, nb, parts = k5_cross_stream(a, b)
    good, end = _validate_lanes(lib, words, c, wend, nb)
    plain = validate_headers_plain(words, c, nb, wend=wend)
    assert torch.equal(good, plain[0]) and torch.equal(end, plain[1])
    for lo, hi, z, cs, b0 in parts:
        w1 = torch.from_numpy(pad_words([z])[0])
        alone = validate_headers_plain(w1, torch.from_numpy(cs), len(z) * 8)
        assert torch.equal(good[lo:hi], alone[0])
        assert torch.equal(end[lo:hi] - b0, alone[1])
    ca = parts[0][3]
    blind = _validate_lanes(lib, words, c, words.numel(), nb)
    assert not torch.equal(blind[1][: len(ca)], end[: len(ca)])
