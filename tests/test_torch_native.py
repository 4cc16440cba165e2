"""The port's native backend (``fdeflate_tpu_torch/models/native.py``) and
``try_foreign(materialize="host")``, which expands K4's records with it.

The loader builds ``native/``'s sources into ``build/fdeflate_tpu_torch/
native/`` under a name hashed from the sources, the flags and the host CPU,
writing a temporary file and renaming it into place: four processes that
build into one empty directory at once all load a working library, and
nothing is written under ``native/``.  Its wrappers are held to JAX's
(``fdeflate_tpu/models/native.py``) run over the same library, so this
file never builds into ``native/`` itself.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from fdeflate_tpu.models import decompressor as JD
from fdeflate_tpu.models import native as JN
import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.models import native as PN
from fdeflate_tpu_torch.ops import inflate_records as K4
from fdeflate_tpu_torch.parallel import discovery as PDisc

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
CORPUS = sorted((FIXTURES / "corpus").iterdir()) + sorted(
    FIXTURES.glob("input-chunking-sensitivity-example*.zz"))

_BUILD_AND_USE = """
import pathlib, sys, zlib
from fdeflate_tpu_torch.models import native as N
N.BUILD_DIR = pathlib.Path(sys.argv[1])
assert N.available(), N.unavailable_reason()
data = bytes(range(256)) * 64 + bytes(5000)
for level in (0, 1, 6, 9):
    z = N.deflate(data, level)
    assert zlib.decompress(z) == data and N.inflate(z) == data
assert zlib.decompress(N.compress_ultra(data)) == data
print(N.library_path())
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("FDEFLATE_TPU_NO_NATIVE", "JAX_PLATFORMS")}
    env.update(extra)
    return env


def _native_dir_state():
    return sorted((p.name, p.stat().st_mtime_ns, p.stat().st_size)
                  for p in (ROOT / "native").iterdir())


def test_four_processes_build_one_library(tmp_path):
    """Four processes started together build into one empty directory; each
    loads a whole library (a half-written one would fail to load or
    decode), one library remains, no temporary file is left, and nothing
    under ``native/`` changes."""
    before = _native_dir_state()
    build = tmp_path / "native"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_USE,
                               str(build)], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    results = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        results.append((proc.returncode, out.strip(), err))
    assert [rc for rc, _, _ in results] == [0] * 4, results
    paths = {out.splitlines()[-1] for _, out, _ in results}
    assert len(paths) == 1
    (path,) = paths
    assert pathlib.Path(path).parent == build
    assert sorted(p.name for p in build.iterdir()) == [pathlib.Path(path).name]
    assert _native_dir_state() == before


def test_library_lives_under_build_and_names_its_inputs(monkeypatch):
    path = PN.library_path()
    assert path.parent == ROOT / "build" / "fdeflate_tpu_torch" / "native"
    assert PN.available() and PN.unavailable_reason() is None
    assert PN.build() == path and path.exists()
    monkeypatch.setattr(PN, "FLAGS", PN.FLAGS + ("-g",))
    assert PN.library_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(PN, "_host_cpu", lambda: "flags : another host")
    assert PN.library_path() != path
    assert ROOT / "native" not in path.parents


def _reason_in_subprocess(tmp_path, **env):
    code = ("import pathlib, sys, zlib\n"
            "import fdeflate_tpu_torch as P\n"
            "from fdeflate_tpu_torch.models import native as N\n"
            "N.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "d = b'abc' * 999\n"
            "assert zlib.decompress(P.compress_to_vec_with_level(d, 6)) == d\n"
            "assert P.decompress_to_vec(zlib.compress(d)) == d\n"
            "assert N.materialize_records([0], 1) is None\n"
            "print(N.available())\nprint(N.unavailable_reason())\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "b")],
                         cwd=ROOT, env=_env(**env), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip().splitlines()[-2:]


def test_unavailable_reason_under_no_native(tmp_path):
    """FDEFLATE_TPU_NO_NATIVE set: unavailable, with the reason, and the
    host API takes its Python paths; nothing is built."""
    avail, reason = _reason_in_subprocess(tmp_path, FDEFLATE_TPU_NO_NATIVE="1")
    assert avail == "False" and "FDEFLATE_TPU_NO_NATIVE" in reason
    assert not (tmp_path / "b").exists()


def test_unavailable_reason_without_a_compiler(tmp_path):
    """No g++ on PATH and no library built yet: unavailable, and the reason
    says so instead of being thrown away."""
    empty = tmp_path / "bin"
    empty.mkdir()
    avail, reason = _reason_in_subprocess(tmp_path, PATH=str(empty))
    assert avail == "False" and "g++ not found" in reason


@pytest.fixture(scope="module")
def jax_native():
    """JAX's native wrapper over the port's library for this module
    (restored after), so that no build of JAX's runs here."""
    if not PN.available():
        pytest.fail(f"native backend unavailable: {PN.unavailable_reason()}")
    saved = (JN._lib, JN._tried)
    JN._lib, JN._tried = PN._bind(ctypes.CDLL(str(PN.library_path()))), True
    yield JN
    JN._lib, JN._tried = saved


def _outcome(fn):
    try:
        return ("ok", fn())
    except (P.OutputTooLarge, JN.E.OutputTooLarge) as e:
        return ("too-large", e.partial_output)
    except (P.DecompressionError, JN.E.DecompressionError) as e:
        return ("err", type(e).__name__)


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.name[:12])
def test_inflate_equals_jax_and_the_oracle(jax_native, path):
    """tests/test_native.py's corpus differential for the port: each seed's
    bytes or error class equal JAX's native wrapper's, and the Python
    oracle's, with the checksum and without, bounded and not."""
    data = path.read_bytes()
    for ignore in (False, True):
        got = _outcome(lambda: PN.inflate(data, ignore_adler32=ignore))
        assert got == _outcome(lambda: jax_native.inflate(
            data, ignore_adler32=ignore))
        hint = _outcome(lambda: PN.inflate(data, ignore_adler32=ignore,
                                           size_hint=1))
        assert hint == got
    for maxlen in (64, 1 << 20):
        got = _outcome(lambda: PN.inflate(data, maxlen=maxlen))
        assert got == _outcome(lambda: JD._decompress_to_vec_python(
            data, maxlen))


def _k4_records(z: bytes):
    """K4's raw records (plain, CPU) of a stream's chain lanes, flattened in
    chain order, as ``try_foreign(materialize="host")`` hands them on."""
    dev = torch.device("cpu")
    words = PDisc.stage_words(z, device=dev)
    lanes, tables, _dropped = PDisc._parse_lanes(
        z, PDisc.find_block_boundaries(z, words, device=dev)[0])
    L = len(lanes)
    recs, bpos, done, _nout = PDisc._lane_decode(
        lanes, 2048, words, np.full(L, words.numel()), np.full(L, len(z) * 8),
        K4.pack_tables(tables, dev))
    chain, _exit, _whole = PDisc._walk(lanes, 0, L, bpos, done)
    return recs[:, chain].T.reshape(-1).numpy()


def _blocks(data: bytes, level: int, step: int) -> bytes:
    """zlib stream whose blocks end every ``step`` input bytes (few records
    a block: the plain K4 on the CPU costs a loop iteration per record)."""
    co = zlib.compressobj(level)
    out = b"".join(co.compress(data[i:i + step])
                   + (co.flush(zlib.Z_BLOCK) if i + step < len(data) else b"")
                   for i in range(0, len(data), step))
    return out + co.flush()


def _data(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    return np.where(rng.integers(0, 4, n) > 0, rng.integers(-8, 8, n),
                    0).astype(np.uint8).tobytes()


STREAMS = {
    "zlib6": (_data(24000, 1), 6, 8000),
    "zlib1": (_data(16000, 2), 1, 4000),
    "backrefs": ((np.random.default_rng(3).bytes(1500) + bytes(400)) * 9, 9,
                 17100),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_materialize_records_equals_jax(jax_native, name):
    """K4's records expand to the stream's bytes through both wrappers;
    malformed records (an error record, a distance before the start, too
    small an output) give None from both."""
    data, level, step = STREAMS[name]
    recs = _k4_records(_blocks(data, level, step))
    got = PN.materialize_records(recs, len(data))
    assert got == jax_native.materialize_records(recs, len(data)) == data
    err = recs.copy()
    err[len(err) // 2] = np.int32(K4.REC_ERR << 28)
    far = np.concatenate([np.array([(2 << 28) | (5 << 15) | 100], np.int32),
                          recs])
    for bad, size in ((err, len(data)), (far, len(data) + 8),
                      (recs, len(data) - 1)):
        assert PN.materialize_records(bad, size) is None
        assert jax_native.materialize_records(bad, size) is None


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_try_foreign_host_materialize_equals_zlib(name, monkeypatch):
    """``materialize="host"`` (and FDN_FOREIGN_MATERIALIZE=host) returns
    zlib's bytes through the native expansion, and the device stitch's;
    with ``return_device`` the device stitch runs."""
    data, level, step = STREAMS[name]
    z = _blocks(data, level, step)
    calls = []
    expand = PN.materialize_records
    monkeypatch.setattr(PN, "materialize_records",
                        lambda r, n: calls.append(n) or expand(r, n))
    got = P.try_foreign(z, max_steps=2048, materialize="host", device="cpu")
    assert got == zlib.decompress(z) == data
    assert calls == [len(data)]
    assert P.try_foreign(z, max_steps=2048, device="cpu") == data
    assert calls == [len(data)]
    monkeypatch.setenv("FDN_FOREIGN_MATERIALIZE", "host")
    assert P.try_foreign(z, max_steps=2048, device="cpu") == data
    out, produced = P.try_foreign(z, max_steps=2048, return_device=True,
                                  device="cpu")
    assert bytes(out[0, :produced].numpy()) == data
    assert calls == [len(data)] * 2


def test_try_foreign_host_materialize_checks_and_needs_native(monkeypatch):
    """A wrong stored Adler-32 or no native backend gives None, as in JAX."""
    data, level, step = STREAMS["zlib6"]
    z = _blocks(data, level, step)
    bad = z[:-1] + bytes([z[-1] ^ 1])
    assert P.try_foreign(bad, max_steps=2048, materialize="host",
                         device="cpu") is None
    monkeypatch.setattr(PN, "_load", lambda: None)
    assert P.try_foreign(z, max_steps=2048, materialize="host",
                         device="cpu") is None
    assert P.try_foreign(z, max_steps=2048, device="cpu") == data
