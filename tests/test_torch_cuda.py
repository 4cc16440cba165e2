"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips unless CUDA is available.  This file
imports no JAX, so on a machine with a GPU and no JAX it runs without the
repository's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Kernel and plain version must agree bit for bit (integer outputs).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fdeflate_tpu_torch.ops.assign_pack import assign_pack, assign_pack_plain
from fdeflate_tpu_torch.ops.decode2 import decode2, decode2_plain
from fdeflate_tpu_torch.ops.repack import combine, combine_plain
from fdeflate_tpu_torch.ops.ultrafast import _encode, lane_starts, stream_words
from fdeflate_tpu_torch.parallel.device_pipeline import fused_zlib_roundtrip
from fdeflate_tpu_torch.trees import trained_tables

pytestmark = pytest.mark.cuda


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
    before = assign_pack.launches
    got = assign_pack(data, lengths, C, t)
    assert assign_pack.launches == before + 1
    want = assign_pack_plain(data, lengths, C, t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


def test_fused_roundtrip_on_the_card(dev):
    data, lengths, C = _inputs(dev, "lanes2048_B4_N65536_C512")
    out, bpos_ok, ck_ok = fused_zlib_roundtrip(C, data.shape[1], device=dev)(
        data, lengths)
    assert torch.equal(out, data)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())
