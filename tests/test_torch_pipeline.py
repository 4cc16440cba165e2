"""Guards of the port: no JAX and nothing of the JAX package, no silent CPU
path, launches counted on CUDA only."""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.adler32 import adler32_batch
from fdeflate_tpu_torch.ops.adler32_pallas import adler32_tiles
from fdeflate_tpu_torch.ops.assign_pack import assign_pack
from fdeflate_tpu_torch.ops.decode2 import (
    canon_tables,
    decode2,
    decode2_canon,
    decode_blocked,
)
from fdeflate_tpu_torch.ops.decode_sep import decode_sep
from fdeflate_tpu_torch.ops.decode_symbols import decode_symbols
from fdeflate_tpu_torch.ops.inflate_records import inflate_records
from fdeflate_tpu_torch.ops.pack import encode_blocked_v1, pack_blocked
from fdeflate_tpu_torch.ops.repack import combine
from fdeflate_tpu_torch.ops.validate_headers import validate_headers
from fdeflate_tpu_torch.parallel.device_pipeline import trained_symbol_tables
from fdeflate_tpu_torch.trees import sep_tables, trained_tables
from fdeflate_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CPU_SLICE = """
import sys, zlib
import numpy as np
import torch
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
# the indexed chunk-parallel decode (K11's plain version)
assert P.decompress_batch_indexed(streams, index, device="cpu") == [
    data[0].tobytes(), data[1, :700].tobytes()]
out, produced, ok, ck_ok = P.fused_ultrafast_roundtrip(4, 2048, 1024, device="cpu")(data, lengths)
assert np.array_equal(out.numpy(), data) and bool(ok.all()) and bool(ck_ok.all())
# the foreign path: block-parallel and sequential decode of zlib streams
text = b"".join(bytes([97 + (i * 7919) % 23]) * (1 + i % 3) for i in range(9000))
co = zlib.compressobj(6)
z = co.compress(text[:9000]) + co.flush(zlib.Z_BLOCK) + co.compress(text[9000:]) + co.flush()
assert P.try_foreign(z, device="cpu") == text
assert P.try_foreign_batch([z, z[:40]], device="cpu") == [text, None]
out = P.decompress_batch([zlib.compress(text, 1), z[:-3], b""], device="cpu")
assert out[0] == text and [type(r).__name__ for r in out[1:]] == [
    "InsufficientInput", "InsufficientInput"]
assert P.decompress_foreign(z, device="cpu") == text
# runtime trees: the septree profile, the adaptive tree, adler32_pallas
sep = P.fused_zlib_roundtrip(4, 1024, tree=P.sep_profile(), device="cpu")
out, bpos_ok, ck_ok = sep(data, lengths)
assert np.array_equal(out.numpy(), data) and bool(bpos_ok.all()) and bool(ck_ok.all())
words, bits, adler, _s, _e = P.zlib_encode_step(4, tree=P.sep_profile())(
    torch.from_numpy(data), torch.from_numpy(lengths))
assert zlib.decompress(P.finalize_streams(words, bits, adler)[1]) == data[1, :700].tobytes()
full = np.full(2, 1024, np.int32)
out, bpos_ok, ck_ok, total = P.fused_adaptive_roundtrip(4, 1024, device="cpu")(data, full)
assert np.array_equal(out.numpy(), data) and bool(bpos_ok.all()) and bool(ck_ok.all())
assert int(P.adler32_pallas(torch.from_numpy(data[1]), 700)) == zlib.adler32(data[1, :700].tobytes())
# the blocked layout: the v2 roundtrip, K8's and K9's chains, K10's combine
out, bpos_ok, ck_ok = P.fused_ultrafast_roundtrip_v2(4, 1024, device="cpu")(data, lengths)
assert np.array_equal(out.numpy(), data) and bool(bpos_ok.all()) and bool(ck_ok.all())
from fdeflate_tpu_torch.ops.decode2 import decode_blocked
from fdeflate_tpu_torch.ops.pack import encode_blocked_v1
from fdeflate_tpu_torch.ops.repack import combine
from fdeflate_tpu_torch.ops.ultrafast import encode_ultrafast_blocked, lane_starts
from fdeflate_tpu_torch.trees import trained_tables
d, ln = torch.from_numpy(data), torch.from_numpy(lengths)
win, cb, _a = encode_ultrafast_blocked(d, ln, 4)
assert torch.equal(encode_blocked_v1(d, ln, 4, trained_tables())[0], win)
assert torch.equal(decode_blocked(win, 64, light=False)[0].reshape(2, 1024), d)
pos0 = lane_starts(cb, 2, 4, 0)[0].reshape(-1).to(torch.int32)
assert torch.equal(combine(win, cb.reshape(-1), pos0, 2, 400, group=4),
                   combine(win, cb.reshape(-1), pos0, 2, 400))
# the host API: every level, RLE, ultra-fast, the streamed decoder, and
# the whole-buffer decode's device route (native off, threshold cut)
raw = data[0].tobytes()
for level in range(10):
    assert P.decompress_to_vec(P.compress_to_vec_with_level(raw, level)) == raw
assert zlib.decompress(P.compress_to_vec_rle(raw)) == raw
d = P.Decompressor()
buf = bytearray(2048)
assert d.read(P.compress_to_vec_ultra_fast(raw), buf, 0)[1] == 1024 and d.is_done()
from fdeflate_tpu_torch.models import decompressor as PD, native as PN
PN.available = lambda: False
PD._DEVICE_ROUTE_MIN = 64
assert P.decompress_to_vec_bounded(zlib.compress(text, 6), None, device="cpu") == text
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "fdeflate_tpu", "bench")))
"""

_BANNED = ("fdeflate_tpu", "jax", "jaxlib", "bench")


def test_port_runs_without_importing_jax():
    """The CPU slices in a fresh process load no module of jax, of the JAX
    package or of its benchmark."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = subprocess.run([sys.executable, "-c", _CPU_SLICE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_import_loads_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    code = ("import sys, fdeflate_tpu_torch; print(sorted(m for m in "
            f"sys.modules if m.split('.')[0] in {_BANNED!r}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def _imported_names(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_import_names_the_jax_package():
    """No import under fdeflate_tpu_torch/ or in chip_smoke.py names
    fdeflate_tpu, jax or bench (the port keeps its own copies)."""
    root = pathlib.Path(ROOT)
    files = sorted((root / "fdeflate_tpu_torch").rglob("*.py"))
    for sub in ("models", "utils", "examples"):
        assert any(f.parent.name == sub for f in files), sub
    files.append(root / "chip_smoke.py")
    bad = [(str(f.relative_to(root)), name) for f in files
           for name in _imported_names(f)
           if name.split(".")[0] in _BANNED]
    assert len(files) > 20 and bad == []


def test_every_launch_goes_through_the_device_guard():
    """No code under fdeflate_tpu_torch/ops/ reaches a kernel entry point
    (an ``fdt_*`` attribute, or ``library()``) except through
    ``_build.launch``, which makes the tensors' device current; each of
    the ten entry points is launched so, by its name."""
    from fdeflate_tpu_torch import _build

    root = pathlib.Path(ROOT) / "fdeflate_tpu_torch" / "ops"
    bypass, launched = [], set()
    for f in sorted(root.glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Attribute) and (
                    node.attr.startswith("fdt_") or node.attr == "library"):
                bypass.append((f.name, node.lineno, node.attr))
            if isinstance(node, ast.Name) and node.id == "library":
                bypass.append((f.name, node.lineno, node.id))
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch"
                    and isinstance(node.args[0], ast.Constant)):
                launched.add(f"fdt_{node.args[0].value}")
    assert bypass == []
    assert launched == set(_build._SIGNATURES)


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.fused_zlib_roundtrip(8, 2048, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.compress_batch_ultra_fast([b"abc"], device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.fused_adaptive_roundtrip(8, 2048, device="cuda")


_Z = zlib.compress(bytes(range(256)) * 200, 6)
_BIG = zlib.compress(np.random.default_rng(1).bytes(300000), 1)


def _without_native(fn):
    """fn() with the native backend reported unavailable."""
    from fdeflate_tpu_torch.models import native

    saved = native.available
    native.available = lambda: False
    try:
        return fn()
    finally:
        native.available = saved


DEFAULT_DEVICE_CALLS = {
    "compress_batch_ultra_fast": lambda: P.compress_batch_ultra_fast([b"abc"]),
    "fused_zlib_roundtrip": lambda: P.fused_zlib_roundtrip(8, 2048),
    "fused_ultrafast_roundtrip_v2":
        lambda: P.fused_ultrafast_roundtrip_v2(8, 2048),
    "fused_adaptive_roundtrip": lambda: P.fused_adaptive_roundtrip(8, 2048),
    "try_foreign": lambda: P.try_foreign(_Z),
    "try_foreign_batch": lambda: P.try_foreign_batch([_Z, _Z]),
    "decompress_foreign": lambda: P.decompress_foreign(_Z),
    "decompress_batch": lambda: P.decompress_batch([_Z]),
    "decompress_batch_indexed":
        lambda: P.decompress_batch_indexed([_Z], np.zeros((1, 4), np.int32)),
    "fused_ultrafast_roundtrip":
        lambda: P.fused_ultrafast_roundtrip(8, 2048, 2048),
    "compress_batch_matched": lambda: P.compress_batch_matched([b"abc"]),
    "compress_batch_device": lambda: P.compress_batch_device([b"abc"], 1),
    "decompress_speculative": lambda: P.decompress_speculative(_Z),
    "decompress_batch_speculative":
        lambda: P.decompress_batch_speculative([_Z]),
    "decompress_to_vec": lambda: _without_native(
        lambda: P.decompress_to_vec(_BIG)),
    "decompress_to_vec_bounded": lambda: _without_native(
        lambda: P.decompress_to_vec_bounded(_BIG, 10)),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CALLS))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """Each entry point runs on the card unless the caller asks for the
    CPU: without CUDA, a call that leaves ``device`` raises, and nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[name]()


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
    lane = torch.empty(3, dtype=torch.int64, device=meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        inflate_records(words.reshape(-1), lane, lane, lane, lane,
                        torch.empty(3, 64, dtype=torch.int32, device=meta),
                        torch.empty(3, 160, dtype=torch.int32, device=meta),
                        16)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        validate_headers(words.reshape(-1), lane, 2560)
    sm, sv = sep_tables(P.sep_profile().lens, meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        decode_sep(words, starts, sm, sv, 64, 2)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        adler32_tiles(data.reshape(-1), lane[:1])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        adler32_batch(data, lengths)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        P.adler32_pallas(data.reshape(-1), 5)
    cmeta, packed = (x.to(meta) for x in canon_tables())
    with pytest.raises(ValueError, match="no kernel for device meta"):
        decode2_canon(win, 4, cmeta, packed)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pack_blocked(torch.empty(4, 64, dtype=torch.int32, device=meta), 26)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        combine(win, bits, bits, 2, 40, group=4)
    st = [x.to(meta) for x in trained_symbol_tables("cpu")]
    lane2 = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        decode_symbols(words, lane2, lane2, lane2, lane2, lane2, *st[:4],
                       max_steps=8, litlen_first=st[4])


def _launches() -> dict:
    return {k: n for k, n in profiling.counts().items()
            if k.startswith("launch.")}


def test_cpu_path_counts_no_launches():
    before = _launches()
    data = np.zeros((2, 512), np.uint8)
    out, bpos_ok, ck_ok = P.fused_zlib_roundtrip(4, 512, device="cpu")(
        data, np.full(2, 512, np.int32))
    assert bool(bpos_ok.all()) and bool(ck_ok.all())
    text = bytes(range(256)) * 300
    assert P.decompress_batch([zlib.compress(text, 6)], device="cpu") == [text]
    lengths = np.full(2, 512, np.int32)
    _o, bpos_ok, ck_ok = P.fused_zlib_roundtrip(
        4, 512, tree=P.sep_profile(), device="cpu")(data, lengths)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())
    _o, bpos_ok, ck_ok, _tb = P.fused_adaptive_roundtrip(
        4, 512, device="cpu")(data, lengths)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())
    assert int(P.adler32_pallas(torch.from_numpy(data[0]))) == zlib.adler32(
        data[0].tobytes())
    _o, bpos_ok, ck_ok = P.fused_ultrafast_roundtrip_v2(
        4, 512, device="cpu")(data, lengths)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())
    d = torch.from_numpy(data)
    win, bits = encode_blocked_v1(d, torch.from_numpy(lengths), 4,
                                  trained_tables())
    decode_blocked(win, 32, light=False)
    combine(win, bits, torch.arange(8, dtype=torch.int32) * 32, 2, 64,
            group=2)
    _o, _p, ok, ck_ok = P.fused_ultrafast_roundtrip(4, 2048, 512,
                                                    device="cpu")(data, lengths)
    assert bool(ok.all()) and bool(ck_ok.all())
    assert _launches() == before


def test_septree_profile_is_not_ported_yet():
    """The septree profile is ported; a decode for a tree that is not
    class-separated is not (the sep kernel's class arithmetic needs one):
    building such a decode step raises ValueError."""
    from fdeflate_tpu.ops.septree import TreeProfile
    from fdeflate_tpu.tables import HUFFMAN_CODES, HUFFMAN_LENGTHS

    trained = TreeProfile(HUFFMAN_LENGTHS, HUFFMAN_CODES)
    with pytest.raises(ValueError, match="class-separated"):
        P.zlib_decode_step(8, 2048, tree=trained)
    with pytest.raises(ValueError, match="class-separated"):
        P.fused_zlib_roundtrip(8, 2048, tree=trained, device="cpu")
    P.zlib_encode_step(8, tree=trained)          # any <= 12-bit tree encodes
    P.zlib_decode_step(8, 2048, tree=P.sep_profile())
