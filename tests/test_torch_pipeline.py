"""Guards of the port: no JAX, no silent CPU path, launches counted on CUDA only."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.assign_pack import assign_pack
from fdeflate_tpu_torch.ops.decode2 import decode2
from fdeflate_tpu_torch.ops.repack import combine
from fdeflate_tpu_torch.trees import trained_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CPU_SLICE = """
import sys, zlib
import numpy as np
import fdeflate_tpu_torch as P
rng = np.random.default_rng(0)
data = np.where(rng.random((2, 1024)) < 0.5, 0,
                rng.integers(0, 256, (2, 1024))).astype(np.uint8)
lengths = np.array([1024, 700], np.int32)
data[1, 700:] = 0
out, bpos_ok, ck_ok = P.fused_zlib_roundtrip(4, 1024, device="cpu")(data, lengths)
assert np.array_equal(out.numpy(), data) and bool(bpos_ok.all()) and bool(ck_ok.all())
streams, index = P.compress_batch_ultra_fast(
    [data[0].tobytes(), data[1, :700].tobytes()], with_index=4, device="cpu")
assert zlib.decompress(streams[1]) == data[1, :700].tobytes()
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")))
"""


def test_port_runs_without_importing_jax():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = subprocess.run([sys.executable, "-c", _CPU_SLICE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.fused_zlib_roundtrip(8, 2048, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.compress_batch_ultra_fast([b"abc"], device="cuda")


def test_wrappers_take_no_plain_path_off_the_cpu():
    """A tensor that is neither on the CPU nor on CUDA raises: the plain
    version is chosen only because a tensor lies on the CPU."""
    t = trained_tables()
    meta = torch.device("meta")
    data = torch.empty(2, 64, dtype=torch.uint8, device=meta)
    lengths = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        assign_pack(data, lengths, 2, t)
    win = torch.empty(4, 26, dtype=torch.int32, device=meta)
    bits = torch.empty(4, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        combine(win, bits, bits, 2, 40)
    words = torch.empty(2, 40, dtype=torch.int32, device=meta)
    starts = torch.empty(2, 2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        decode2(words, starts, t.dtab.to(meta), 64, 2)


def test_cpu_path_counts_no_launches():
    before = (assign_pack.launches, combine.launches, decode2.launches)
    data = np.zeros((2, 512), np.uint8)
    out, bpos_ok, ck_ok = P.fused_zlib_roundtrip(4, 512, device="cpu")(
        data, np.full(2, 512, np.int32))
    assert bool(bpos_ok.all()) and bool(ck_ok.all())
    assert (assign_pack.launches, combine.launches, decode2.launches) == before


def test_septree_profile_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        P.zlib_encode_step(8, tree=object())
    with pytest.raises(NotImplementedError):
        P.zlib_decode_step(8, 2048, tree=object())
