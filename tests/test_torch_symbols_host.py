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
chunk lanes of the indexed codec at chain 1, 2 and 4.  The launch, the
shared-memory tables and the coalesced stores are covered only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
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
from fdeflate_tpu_torch.parallel.device_pipeline import (
    chunk_lanes,
    encode_indexed,
    trained_symbol_tables,
)
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.edges import K11_KINDS, k11_edge_case

CSRC = pathlib.Path(__file__).resolve().parent.parent / "fdeflate_tpu_torch" / "csrc"

_HARNESS = r"""
#include "symbols_lanes.cuh"
// K11's lanes one after another, with the kernel's per-lane arguments.
extern "C" void symbols_lanes(const uint32_t* words, int nrows, int W,
    const int32_t* rows, const int32_t* bit_pos, const int32_t* bit_end,
    const int32_t* out_pos, const int32_t* active, const int32_t* table_id,
    const int32_t* bit_stop, const uint32_t* litlen, const uint32_t* lsec,
    int nsec, const uint32_t* dist, const uint32_t* dsec, int ndsec,
    const int32_t* first, int T, int chain, int L, int max_steps,
    uint32_t* rl, uint32_t* rlh, int8_t* rc, int32_t* rn, int32_t* rd,
    int32_t* rp, int32_t* bpos, int32_t* opos, int8_t* status) {
  for (int64_t lane = 0; lane < L; ++lane) {
    const int64_t t = fdt::iclamp(table_id[lane], 0, T - 1);
    const fdt::SymTables tb{litlen + t * fdt::kSymLitlen,
        first ? first + t * fdt::kSymLitlen : nullptr,
        dist + t * fdt::kSymDist, lsec + t * nsec, nsec, dsec + t * ndsec,
        ndsec};
    const int64_t row = fdt::iclamp(rows[lane], 0, nrows - 1);
    const fdt::SymOut o{rl + lane, rlh + lane, rc + lane, rn + lane,
                        rd + lane, rp + lane, L};
    fdt::decode_symbols_lane(words + row * W, W, bit_pos[lane],
        bit_end[lane], out_pos[lane], active[lane] != 0, bit_stop[lane], tb,
        chain, max_steps, o, bpos + lane, opos + lane, status + lane);
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
    lib.symbols_lanes.argtypes = ([P, I, I] + [P] * 9 + [I, P, P, I, P]
                                  + [I] * 4 + [P] * 9)
    return lib


def _lanes(lib, max_steps: int, **kw):
    """The lane code's (records, state) on ``decode_symbols`` keywords."""
    words, lanes, rows, tabs, first, T = engine_inputs(**kw)
    L = rows.numel()
    i32 = torch.int32
    rec = [torch.full((max_steps, L), 7, dtype=i32) for _ in range(6)]
    rec[2] = torch.full((max_steps, L), 7, dtype=torch.int8)
    state = [torch.zeros(L, dtype=i32), torch.zeros(L, dtype=i32),
             torch.zeros(L, dtype=torch.int8)]
    p = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib.symbols_lanes(p(words), words.shape[0], words.shape[1], p(rows),
                      *(p(x) for x in lanes), p(tabs[0]), p(tabs[1]),
                      tabs[1].shape[1], p(tabs[2]), p(tabs[3]),
                      tabs[3].shape[1], p(first), T, kw.get("chain", 4), L,
                      max_steps, *(p(x) for x in rec), *(p(x) for x in state))
    return tuple(rec), tuple(state)


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
    _check(_lanes(lib, steps, **case), want, kind)
    assert EXITS[kind] <= set(want[1][2].tolist()), kind
    if kind in ("long codes", "stacked tables"):
        assert _secondary_steps(case, want[0]) > 0
    if kind == "split at bit_stop":
        # without litlen_first the lanes' records differ: entries were split
        unsplit = decode_symbols(**dict(case, litlen_first=None),
                                 max_steps=steps)
        assert not torch.equal(unsplit[0][2], want[0][2])


@pytest.mark.parametrize("chain", [1, 2, 4])
def test_symbols_lane_indexed_matches_plain(lib, chain):
    rng = np.random.default_rng(123)
    B, N, C = 3, 8192, 8
    data = np.zeros((B, N), np.uint8)
    data[0] = rng.integers(0, 256, N, dtype=np.uint8)
    data[1, ::5] = 9
    # IDAT bytes: short codes, so literal pairs straddle lane stops and
    # the first-symbol split is taken
    data[2] = make_idat_corpus(1, N, seed=5)[0]
    words, total_bits, _adler, index = encode_indexed(
        torch.from_numpy(data), torch.full((B,), N, dtype=torch.int32), C)
    starts, bits_l, stops, srow, active = chunk_lanes(total_bits, index)
    t = trained_symbol_tables("cpu")
    kw = dict(words=words, bit_pos=starts, bit_end=bits_l,
              out_pos=torch.full_like(starts, 1 << 30), active=active,
              table_id=torch.zeros_like(starts), litlen=t[0],
              litlen_sec=t[1], dist=t[2], dist_sec=t[3], bit_stop=stops,
              chain=chain, stream_row=srow, litlen_first=t[4])
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
