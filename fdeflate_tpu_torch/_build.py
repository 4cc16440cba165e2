"""Build and bind the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface (``build/fdeflate_tpu_torch/libfdt_kernels.so``
under the repository root), loaded with ctypes.  Each entry point launches
one kernel on the stream it is given and returns the launch's
``cudaError_t``; ``check`` turns a nonzero code into an exception.

The library is built at first use and rebuilt when the sources change (a
hash of them is stored beside it).  Nothing here runs at import time: the
CPU tests import every module on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fdeflate_tpu_torch"
LIB_PATH = BUILD_DIR / "libfdt_kernels.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # data, lengths, lit_tok, len_tok, zlit, t285, win, chunk_bits,
    # B, N, C, wwin, stream
    "fdt_assign_pack": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P],
    # win, chunk_bits, pos0, words, B, C, wwin, W, stream
    "fdt_combine": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # words, chunk_starts, dtab, out, bpos, B, W, N, C, stream
    "fdt_decode2": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

build_seconds: float | None = None  # wall time of this process's nvcc run


def _sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(ARCH.encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> pathlib.Path:
    """Compile the kernels unless an up-to-date library exists."""
    global build_seconds
    digest = _digest()
    stamp = LIB_PATH.with_suffix(".sha256")
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", str(tmp)]
    cmd += [str(p) for p in sorted(_CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "ptxas.log").write_text(res.stderr)
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return LIB_PATH


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def require_cuda(*tensors) -> None:
    """Raise unless all tensors lie on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"tensor on {x.device}, expected {dev}")
