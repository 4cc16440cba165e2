"""The kernels' per-lane code, built for the host, against the plain versions.

``fdeflate_tpu_torch/csrc/lanes.cuh`` holds the whole sequential work of a
K1 and a K3 lane as plain C++.  The CUDA kernels run it one lane per
thread; here g++ builds the same header into a small host library with the
kernels' lane loop around it, so the bit machines are held against the
plain PyTorch versions on every tier-1 run, with no card.  The launch
configuration, shared-memory tables and atomics are covered only on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fdeflate_tpu_torch.ops.assign_pack import assign_pack_plain, wwin
from fdeflate_tpu_torch.ops.decode2 import decode2_plain
from fdeflate_tpu_torch.ops.ultrafast import encode_ultrafast_batch
from fdeflate_tpu_torch.trees import trained_tables

CSRC = pathlib.Path(__file__).resolve().parent.parent / "fdeflate_tpu_torch" / "csrc"

# The kernels' lane loop (assign_pack.cu, decode2.cu), serial on the host.
_HARNESS = r"""
#include <algorithm>
#include "lanes.cuh"
extern "C" void assign_pack_lanes(const uint8_t* data, const int32_t* lengths,
    const int32_t* lit, const int32_t* lent, int zlit, int t285,
    uint32_t* win, int32_t* bits, int B, int N, int C, int wwin) {
  int S = N / C;
  for (int64_t lane = 0; lane < (int64_t)B * C; ++lane) {
    int b = lane / C, k = lane % C, base = k * S;
    const uint8_t* src = data + (int64_t)b * N + base;
    int al = std::min(std::max(lengths[b] / 8 * 8 - base, 0), S);
    int ln = std::min(std::max(lengths[b] - base, 0), S);
    bool prev_run = k > 0 && src[-1] == 0;
    bits[lane] = fdt::assign_pack_lane(src, S, al, ln, prev_run, lit, lent,
                                       zlit, t285, win + lane * wwin, wwin);
  }
}
extern "C" void decode_lanes(const uint32_t* words, const int32_t* starts,
    const int32_t* dtab, uint8_t* out, int32_t* bpos, int B, int W, int N,
    int C) {
  int S = N / C;
  for (int64_t lane = 0; lane < (int64_t)B * C; ++lane) {
    int b = lane / C, k = lane % C;
    bpos[lane] = fdt::decode_lane(words + (int64_t)b * W, W, starts[lane],
        dtab, (uint32_t*)(out + (int64_t)b * N + (int64_t)k * S), S);
  }
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
    return ctypes.CDLL(str(so))


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


@pytest.mark.parametrize("seed0", SEEDS)
def test_assign_pack_lane_matches_plain(lib, seed0):
    t = trained_tables()
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        B, N = data.shape
        ww = wwin(N // C)
        win = torch.empty(B * C, ww, dtype=torch.int32)
        bits = torch.empty(B * C, dtype=torch.int32)
        lib.assign_pack_lanes(_ptr(data), _ptr(lengths), _ptr(t.lit_tok),
                              _ptr(t.len_tok), t.zlit_tok, t.t285_tok,
                              _ptr(win), _ptr(bits), B, N, C, ww)
        want_win, want_bits = assign_pack_plain(data, lengths, C, t)
        assert torch.equal(bits, want_bits), seed
        assert torch.equal(win, want_win), seed


@pytest.mark.parametrize("seed0", SEEDS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_decode_lane_matches_plain(lib, seed0, corrupt):
    t = trained_tables()
    for seed in range(seed0, seed0 + 6):
        data, lengths, C = _case(seed)
        B, N = data.shape
        words, total_bits, _ad, starts, _eof = encode_ultrafast_batch(
            data, lengths, C)
        if corrupt:
            rng = np.random.default_rng(seed)
            for _ in range(3):
                b = int(rng.integers(0, B))
                j = int(rng.integers(14, max(15, int(total_bits[b]) // 32)))
                words[b, j] ^= int(rng.integers(1, 2**31))
        W = words.shape[1]
        out = torch.empty(B, N, dtype=torch.uint8)
        bpos = torch.empty(B, C, dtype=torch.int32)
        starts = starts.contiguous()
        lib.decode_lanes(_ptr(words), _ptr(starts), _ptr(t.dtab), _ptr(out),
                         _ptr(bpos), B, W, N, C)
        want_out, want_bpos = decode2_plain(words, starts, t.dtab, N, C)
        assert torch.equal(bpos, want_bpos), seed
        assert torch.equal(out, want_out), seed
        if not corrupt:
            assert torch.equal(out, data), seed
