"""ctypes bindings for the native C++ host codec (``native/`` at the root).

The port's own loader of ``native/fdeflate_native.cpp`` and
``native/deflate.cpp``, with the entry points and return contracts of
``fdeflate_tpu/models/native.py:77-172``: ``available``, ``inflate``,
``compress_ultra``, ``deflate`` and ``materialize_records``.  Callers check
``available()`` and take their Python path when it is False;
``unavailable_reason()`` says why (``FDEFLATE_TPU_NO_NATIVE`` set, no
``g++``, or the compiler's or loader's error).

The sources are compiled read-only, at first use, into ``BUILD_DIR``
(``build/fdeflate_tpu_torch/native/`` under the repository root), never
into ``native/``.  The library's name carries a hash of the two sources,
``trained_tree.inc``, the compiler flags and the host CPU's feature flags:
``-march=native`` code built on one host must not load on another.  The
compiler writes to a temporary name in that directory, which is then
renamed into place, so a process or rank that finds the library finds a
whole one, however many build it at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from .. import errors as E

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
SOURCES = (_ROOT / "native" / "fdeflate_native.cpp",
           _ROOT / "native" / "deflate.cpp")
INCLUDES = (_ROOT / "native" / "trained_tree.inc",)
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
BUILD_DIR = _ROOT / "build" / "fdeflate_tpu_torch" / "native"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_reason: str | None = None
_tried = False


def _host_cpu() -> str:
    """The host CPU's identity: the ``flags`` line of /proc/cpuinfo."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.strip()
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}"


def library_path() -> pathlib.Path:
    """Where the library for these sources, flags and host CPU lives."""
    h = hashlib.sha256()
    for f in (*SOURCES, *INCLUDES):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libfdeflate_native.{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library into ``BUILD_DIR`` unless it is there; returns
    its path.  Raises RuntimeError when there is no ``g++`` or the compiler
    fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native backend cannot be built")
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{path.name}.", suffix=".tmp",
                               dir=path.parent)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *FLAGS, *map(str, SOURCES), "-o", tmp],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): "
                               f"{res.stderr.strip()[-4000:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    size, ll = ctypes.c_size_t, ctypes.c_longlong
    lib.fdn_inflate.restype = ll
    lib.fdn_inflate.argtypes = [ctypes.c_char_p, size, u8p, size,
                                ctypes.c_int, ctypes.POINTER(size)]
    lib.fdn_compress_ultra.restype = ll
    lib.fdn_compress_ultra.argtypes = [ctypes.c_char_p, size, u8p, size]
    lib.fdn_deflate.restype = ll
    lib.fdn_deflate.argtypes = [ctypes.c_int, ctypes.c_char_p, size, u8p,
                                size, ctypes.c_int]
    lib.fdn_materialize.restype = ll
    lib.fdn_materialize.argtypes = [i32p, size, u8p, size]
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _reason, _tried
    with _lock:
        if not _tried:
            _tried = True
            if os.environ.get("FDEFLATE_TPU_NO_NATIVE"):
                _reason = "FDEFLATE_TPU_NO_NATIVE is set"
            else:
                try:
                    _lib = _bind(ctypes.CDLL(str(build())))
                except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                    _reason = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why the native backend is unavailable, or None when it is available."""
    _load()
    return _reason


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native backend unavailable: {_reason}")
    return lib


def _u8(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# The most bytes the native decoder writes in one step: a stored block.
_MAX_STEP = 65535


def _inflate(lib, data: bytes, cap: int, ignore_adler32: bool):
    """One ``fdn_inflate`` call into ``cap`` bytes: (out, rc, needed)."""
    out = np.empty(cap, np.uint8)
    needed = ctypes.c_size_t(0)
    rc = lib.fdn_inflate(data, len(data), _u8(out), cap, int(ignore_adler32),
                         ctypes.byref(needed))
    return out, rc, needed.value


def inflate(data: bytes, ignore_adler32: bool = False,
            maxlen: int | None = None, size_hint: int | None = None) -> bytes:
    """Whole-stream decode through the native kernel.

    Raises the matching DecompressionError / OutputTooLarge on failure.
    ``OutputTooLarge`` carries the stream's first ``maxlen`` bytes, as the
    Python state machine's does: the decoder stops before a step that
    does not fit, so it runs with ``maxlen + _MAX_STEP`` bytes of room
    and the partial output is cut from that.  (JAX's wrapper returns its
    whole ``maxlen`` buffer, whose bytes past the last whole step were
    never written.)  An error the decoder meets past ``maxlen`` gives
    ``OutputTooLarge``, as the Python path, which stops at ``maxlen``.
    """
    lib = _require()
    limit = None if maxlen is None else maxlen + _MAX_STEP
    cap = size_hint if size_hint is not None else max(4 * len(data), 1 << 16)
    if limit is not None:
        cap = min(cap, limit)
    while True:
        out, rc, needed = _inflate(lib, data, cap, ignore_adler32)
        if rc >= 0:
            if maxlen is not None and rc > maxlen:
                raise E.OutputTooLarge(out[:maxlen].tobytes())
            return out[:rc].tobytes()
        status = -rc
        if status == int(E.Status.OUTPUT_TOO_LARGE):
            if limit is not None and cap >= limit:
                raise E.OutputTooLarge(out[:maxlen].tobytes())
            want = max(needed, cap * 2)
            cap = want if limit is None else min(want, limit)
            continue
        if maxlen is not None and cap > maxlen:
            # Where did the error lie?  Past maxlen if a decode into
            # maxlen bytes runs out of room first.
            _o, rc_at_max, _n = _inflate(lib, data, maxlen, ignore_adler32)
            if rc_at_max == -int(E.Status.OUTPUT_TOO_LARGE):
                raise E.OutputTooLarge(out[:maxlen].tobytes())
        raise E.error_for_status(status)


def compress_ultra(data: bytes) -> bytes:
    lib = _require()
    cap = 64 + len(data) + len(data) // 2 + (len(data) * 3) // 5
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.fdn_compress_ultra(data, len(data), _u8(out), cap)
        if rc >= 0:
            return out[:rc].tobytes()
        cap *= 2


def deflate(data: bytes, level: int, zlib_mode: bool = True) -> bytes:
    """Whole-buffer compression at the given level (0-9)."""
    lib = _require()
    cap = 1024 + len(data) + len(data) // 2
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.fdn_deflate(min(level, 7), data, len(data), _u8(out), cap,
                             int(zlib_mode))
        if rc >= 0:
            return out[:rc].tobytes()
        cap *= 2


def materialize_records(recs, expected_size: int) -> bytes | None:
    """Expand packed record-kernel records (K4's int32 format, JAX's
    ``ops/pallas_inflate``) into bytes.

    ``recs`` is an int32 array of records in output order (idle and EOB
    records are skipped).  Returns None on malformed records or when the
    native backend is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    recs = np.ascontiguousarray(recs, np.int32)
    out = np.empty(max(expected_size, 1), np.uint8)
    rc = lib.fdn_materialize(
        recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), recs.size,
        _u8(out), out.size)
    if rc < 0:
        return None
    return out[:rc].tobytes()
