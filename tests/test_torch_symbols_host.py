"""K11's lane code, built for the host, against its plain version.

``fdeflate_tpu_torch/csrc/symbols_lanes.cuh`` holds K11 decode_symbols'
per-lane engine (``decode_symbols_lane``: one lane's whole loop, the JAX
loop body step by step) as plain C++.  Here g++ builds it into a small
host library that runs every lane in turn, as the kernel's threads do, and
its records and state are held bit for bit to ``decode_symbols_plain`` on
the edge inputs of ``tools/edges.k11_edge_case`` (codes of up to 15 bits
through both secondary tables, truncation, reads past the last word,
corrupted fixed-code streams with invalid distance codes, invalid
literal/length entries, distances too far back, inactive lanes, stacked
tables with ``table_id`` and ``stream_row``, exhausted steps) and on the
chunk lanes of the indexed codec at chain 1, 2 and 4, in both output
forms: the full form (``fill``: every row written, JAX's records) and the
live form (each lane's rows below its step count written, the rest left as
the harness set them).  The host runs each lane alone (``LaneVote``); the
warp vote, the launch, the shared-memory tables and the coalesced stores
are covered only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fdeflate_tpu_torch.ops.decode_symbols import (decode_symbols,
                                                   engine_inputs)
from fdeflate_tpu_torch.ops.ultrafast import encode_ultrafast_batch
from fdeflate_tpu_torch.parallel.device_pipeline import (
    chunk_lanes,
    trained_symbol_tables,
)
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.edges import K11_KINDS, k11_edge_case

CSRC = pathlib.Path(__file__).resolve().parent.parent / "fdeflate_tpu_torch" / "csrc"

_HARNESS = r"""
#include "symbols_lanes.cuh"
// The vote of a group of lanes stepping together, on the host: the group
// runs while any of its lanes runs, that is for its longest lane's steps.
struct GroupVote {
  int steps, i = 0;
  bool operator()(bool) { return i++ < steps; }
};
// K11's lanes one after another, with the kernel's per-lane arguments;
// with group_steps, each lane steps as in a group whose longest lane runs
// group_steps[lane] steps (a warp on the card), else alone.
extern "C" void symbols_lanes(const int32_t* group_steps,const uint32_t* words, int nrows, int W,
    const int32_t* rows, const int32_t* bit_pos, const int32_t* bit_end,
    const int32_t* out_pos, const int32_t* active, const int32_t* table_id,
    const int32_t* bit_stop, const uint32_t* litlen, const uint32_t* lsec,
    int nsec, const uint32_t* dist, const uint32_t* dsec, int ndsec,
    const int32_t* first, int T, int chain, int L, int max_steps, int fill,
    uint32_t* rl, uint32_t* rlh, int8_t* rc, int32_t* rn, int32_t* rd,
    int32_t* rp, int32_t* steps, int32_t* bpos, int32_t* opos,
    int8_t* status) {
  for (int64_t lane = 0; lane < L; ++lane) {
    const int64_t t = fdt::iclamp(table_id[lane], 0, T - 1);
    const fdt::SymTables tb{litlen + t * fdt::kSymLitlen,
        first ? first + t * fdt::kSymLitlen : nullptr,
        dist + t * fdt::kSymDist, lsec + t * nsec, nsec, dsec + t * ndsec,
        ndsec};
    const int64_t row = fdt::iclamp(rows[lane], 0, nrows - 1);
    const fdt::SymOut o{rl + lane, rlh + lane, rc + lane, rn + lane,
                        rd + lane, rp + lane, L};
    auto run = [&](auto vote) {
      return fdt::decode_symbols_lane(words + row * W, W, bit_pos[lane],
          bit_end[lane], out_pos[lane], active[lane] != 0, bit_stop[lane],
          tb, chain, max_steps, fill != 0, o, steps + lane, bpos + lane,
          opos + lane, status + lane, vote);
    };
    if (group_steps) run(GroupVote{group_steps[lane]});
    else run(fdt::LaneVote{});
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the lane code for the host")
    d = tmp_path_factory.mktemp("symbols")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libsymbols.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.symbols_lanes.argtypes = ([P, P, I, I] + [P] * 9 + [I, P, P, I, P]
                                  + [I] * 5 + [P] * 10)
    return lib


def _lanes(lib, max_steps: int, fill: bool = True, group=None, **kw):
    """The lane code's (records, state, steps) on ``decode_symbols``
    keywords; every record slot starts as the sentinel 7.  ``group``
    int32[L]: the steps of each lane's group (``_warp_steps``), else each
    lane steps alone."""
    words, lanes, rows, tabs, first, T = engine_inputs(**kw)
    L = rows.numel()
    i32 = torch.int32
    rec = [torch.full((max_steps, L), 7, dtype=i32) for _ in range(6)]
    rec[2] = torch.full((max_steps, L), 7, dtype=torch.int8)
    state = [torch.zeros(L, dtype=i32), torch.zeros(L, dtype=i32),
             torch.zeros(L, dtype=torch.int8)]
    steps = torch.full((L,), -1, dtype=i32)
    p = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib.symbols_lanes(p(group), p(words), words.shape[0], words.shape[1], p(rows),
                      *(p(x) for x in lanes), p(tabs[0]), p(tabs[1]),
                      tabs[1].shape[1], p(tabs[2]), p(tabs[3]),
                      tabs[3].shape[1], p(first), T, kw.get("chain", 4), L,
                      max_steps, int(fill), *(p(x) for x in rec), p(steps),
                      *(p(x) for x in state))
    return tuple(rec), tuple(state), steps


def _check(got, want, label):
    for name, g, w in zip(("lit_lo", "lit_hi", "cnt", "len", "dist", "pos",
                           "bit_pos", "out_pos", "status"),
                          got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name)
        bad = (g != w).nonzero()
        assert bad.numel() == 0, f"{label}: {name} differs at {bad[:5].tolist()}"


# Lane exits each edge input must reach: 0 out of steps, 1 EOB, 2 stopped
# or truncated, 11 invalid literal/length code, 12 invalid distance code,
# 14 distance too far back.
EXITS = {"long codes": {0, 1, 2, 14}, "truncated": {0, 1, 2, 14},
         "fixed code, corrupted": {1, 2, 12, 14},
         "invalid and garbage entries": {1, 2, 11, 14},
         "stacked tables": {0, 1, 2, 12, 14}, "steps run out": {0, 1, 2, 14},
         "split at bit_stop": {2}}


def _secondary_steps(case, records) -> int:
    """Steps of running lanes whose first lookup is a secondary-table
    pointer (codes longer than 12 bits)."""
    words = case["words"].numpy().astype(np.uint32).astype(np.uint64)
    rows = (np.arange(case["bit_pos"].numel()) if case["stream_row"] is None
            else case["stream_row"].numpy()).clip(0, len(words) - 1)
    tid = case["table_id"].numpy()
    pos = records[5].numpy()
    n = 0
    for step, lane in zip(*np.nonzero(pos >= 0)):
        p = int(pos[step, lane])
        w = words[rows[lane]]
        lo = int(w[min(p >> 5, len(w) - 1)]) | int(w[min((p >> 5) + 1, len(w) - 1)]) << 32
        e = int(case["litlen"][tid[lane], (lo >> (p & 31)) & 4095])
        n += (e & 0x2000) != 0
    return n


@pytest.mark.parametrize("kind", K11_KINDS)
def test_symbols_lane_edges_match_plain(lib, kind):
    case = k11_edge_case(kind)
    steps = case.pop("max_steps")
    want = decode_symbols(**case, max_steps=steps)
    got = _lanes(lib, steps, **case)
    _check(got, want, kind)
    assert torch.equal(got[2], (want[0][5] >= 0).sum(0, dtype=torch.int32))
    assert EXITS[kind] <= set(want[1][2].tolist()), kind
    if kind in ("long codes", "stacked tables"):
        assert _secondary_steps(case, want[0]) > 0
    if kind == "split at bit_stop":
        # without litlen_first the lanes' records differ: entries were split
        unsplit = decode_symbols(**dict(case, litlen_first=None),
                                 max_steps=steps)
        assert not torch.equal(unsplit[0][2], want[0][2])


def _indexed_kw(chain: int) -> dict:
    """``decode_symbols`` keywords of the indexed codec's chunk lanes: random
    bytes, a byte every fifth and IDAT, C = 8."""
    rng = np.random.default_rng(123)
    B, N, C = 3, 8192, 8
    data = np.zeros((B, N), np.uint8)
    data[0] = rng.integers(0, 256, N, dtype=np.uint8)
    data[1, ::5] = 9
    # IDAT bytes: short codes, so literal pairs straddle lane stops and
    # the first-symbol split is taken
    data[2] = make_idat_corpus(1, N, seed=5)[0]
    words, total_bits, _adler, index = encode_ultrafast_batch(
        torch.from_numpy(data), torch.full((B,), N, dtype=torch.int32),
        num_chunks=C)
    starts, bits_l, stops, srow, active = chunk_lanes(total_bits, index)
    t = trained_symbol_tables("cpu")
    return dict(words=words, bit_pos=starts, bit_end=bits_l,
                out_pos=torch.full_like(starts, 1 << 30), active=active,
                table_id=torch.zeros_like(starts), litlen=t[0],
                litlen_sec=t[1], dist=t[2], dist_sec=t[3], bit_stop=stops,
                chain=chain, stream_row=srow, litlen_first=t[4])


@pytest.mark.parametrize("chain", [1, 2, 4])
def test_symbols_lane_indexed_matches_plain(lib, chain):
    kw = _indexed_kw(chain)
    want = decode_symbols(**kw, max_steps=2048)
    _check(_lanes(lib, 2048, **kw), want, f"indexed, chain {chain}")
    assert set(want[1][2].tolist()) <= {1, 2}


def test_symbols_lane_writes_every_row(lib):
    """Rows past a lane's last step hold the records' initial values (the
    kernel's outputs are allocated uninitialised)."""
    case = k11_edge_case("steps run out")
    case.pop("max_steps")
    got = _lanes(lib, 40, **case)
    want = decode_symbols(**case, max_steps=40)
    _check(got, want, "40 steps")
    idle = got[0][5] < 0
    assert idle.any()
    for r in got[0][:5]:
        assert (r[idle] == 0).all()


def _check_live(got, want, label):
    """The live form against the plain (full) records: rows below each
    lane's step count equal, the count equal to the rows with a position,
    the state equal, and every slot at or past the count still 7."""
    records, state, steps = got
    ran = want[0][5] >= 0
    assert torch.equal(steps, ran.sum(0, dtype=torch.int32)), label
    live = torch.arange(ran.shape[0])[:, None] < steps[None, :].to(torch.int64)
    for name, g, w in zip(("lit_lo", "lit_hi", "cnt", "len", "dist", "pos"),
                          records, want[0]):
        assert torch.equal(g[live], w[live]), (label, name)
        assert (g[~live] == 7).all(), f"{label}: {name} written past steps"
    assert (~live).any(), label
    for name, g, w in zip(("bit_pos", "out_pos", "status"), state, want[1]):
        assert torch.equal(g, w), (label, name)


@pytest.mark.parametrize("kind", K11_KINDS)
def test_symbols_lane_live_form_edges(lib, kind):
    case = k11_edge_case(kind)
    steps = case.pop("max_steps")
    want = decode_symbols(**case, max_steps=steps)
    got = _lanes(lib, steps, fill=False, **case)
    _check_live(got, want, kind)


@pytest.mark.parametrize("chain", [1, 2, 4])
def test_symbols_lane_live_form_indexed(lib, chain):
    kw = _indexed_kw(chain)
    want = decode_symbols(**kw, max_steps=2048)
    got = _lanes(lib, 2048, fill=False, **kw)
    _check_live(got, want, f"indexed, chain {chain}")


def _warp_steps(steps: torch.Tensor) -> torch.Tensor:
    """For each lane, the steps of the longest lane among its 32 (the warp
    the kernel gives it): how long its warp's vote runs."""
    L = steps.numel()
    pad = torch.zeros(-(-L // 32) * 32, dtype=torch.int32)
    pad[:L] = steps
    return pad.reshape(-1, 32).amax(1).repeat_interleave(32)[:L].contiguous()


def _check_warp(lib, steps: int, kw, label):
    """Lanes stepping in warps of 32, as on the card: the full form equals
    the plain records (a lane that stopped while its warp runs writes the
    initial values), the live form leaves every slot past a lane's steps
    as it was."""
    want = decode_symbols(**kw, max_steps=steps)
    group = _warp_steps(_lanes(lib, steps, fill=False, **kw)[2])
    assert (group > (want[0][5] >= 0).sum(0)).any(), label
    got = _lanes(lib, steps, group=group, **kw)
    _check(got, want, label)
    _check_live(_lanes(lib, steps, fill=False, group=group, **kw), want,
                label)


@pytest.mark.parametrize("kind", K11_KINDS)
def test_symbols_lane_warp_edges(lib, kind):
    case = k11_edge_case(kind)
    _check_warp(lib, case.pop("max_steps"), case, kind)


@pytest.mark.parametrize("chain", [1, 2, 4])
def test_symbols_lane_warp_indexed(lib, chain):
    _check_warp(lib, 2048, _indexed_kw(chain), f"indexed, chain {chain}")

