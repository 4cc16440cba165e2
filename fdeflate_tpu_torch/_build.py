"""Build and bind the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source,
all started together, and link into one shared library with a plain C
interface (``build/fdeflate_tpu_torch/libfdt_kernels.so`` under the
repository root), loaded with ctypes.  Each entry point launches
one kernel on the stream it is given and returns the launch's
``cudaError_t``; wrappers call them through ``launch``, which makes the
tensors' device current and turns a nonzero code into an exception.

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

import torch

from .utils.profiling import count

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fdeflate_tpu_torch"
LIB_PATH = BUILD_DIR / "libfdt_kernels.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # data, lengths, lit_tok, len_tok, win, chunk_bits, B, N, C, wwin, stream
    "fdt_assign_pack": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # win, chunk_bits, pos0, words, B, C, wwin, W, stream
    "fdt_combine": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # words, chunk_starts, dtab, out, bpos, B, W, N, C, device, stream
    "fdt_decode2": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # words, chunk_starts, meta, vals, out, bpos, stats (or null), B, W, N,
    # C, device, stream
    "fdt_decode_sep": [_P] * 7 + [_I] * 5 + [_P],
    # data, row stride, B, n, lengths (or null), lengths are int64, length,
    # acc, out, sums (or null), wsums (or null), device, stream
    "fdt_adler32_tiles": [_P, _L, _L, _L, _P, _I, _L, _P, _P, _P, _P, _I, _P],
    # words, start, wend, bit_end, out0, meta, tab, recs, bpos, nout, done,
    # stats (or null), L, K, stream
    "fdt_inflate_records": [_P] * 12 + [_I, _I, _P],
    # words, cands, wends (or null), nbits (or null), W, n_bits, good, end,
    # L, stream
    "fdt_validate_headers": [_P] * 4 + [_L, _L, _P, _P, _I, _P],
    # win, meta, packed, out, bpos, stats (or null), L, wwin, T, device,
    # stream
    "fdt_decode2_canon": [_P] * 6 + [_I] * 4 + [_P],
    # tok, win, L, S, wwin, device, stream
    "fdt_pack_v1": [_P, _P, _I, _I, _I, _I, _P],
    # win, chunk_bits, pos0, words, B, C, wwin, W, stream
    "fdt_combine_grouped": [_P] * 4 + [_I] * 4 + [_P],
    # words, rows, W, stream_row, bit_pos, bit_end, out_pos, active,
    # table_id, bit_stop, litlen, litlen_sec, S, dist, dist_sec, S2,
    # litlen_first (or null), T, chain, L, max_steps, fill, rl, rlh, rc, rn,
    # rd, rp, steps, bpos, opos, status, stream
    "fdt_decode_symbols": [_P, _I, _I] + [_P] * 9 + [_I, _P, _P, _I, _P]
                          + [_I] * 5 + [_P] * 11,
    # words, offs, wend, bit_end, W, info, meta, tab, H, stream
    "fdt_header_tables": [_P] * 4 + [_L] + [_P] * 3 + [_I, _P],
    # recs, window, produced, out, new_window, scratch (or null), L, K, cap,
    # stream
    "fdt_materialize_records": [_P] * 6 + [_I] * 3 + [_P],
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
    tag = f"{os.getpid()}.tmp"
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}")
    flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs.append((obj, subprocess.Popen(
            [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        _out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{err}")
    if not failed:
        res = subprocess.run([_nvcc(), ARCH, "-shared", "-o", str(tmp),
                              *(str(obj) for obj, _ in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr}")
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "ptxas.log").write_text("".join(logs))
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


def launch(name: str, device: torch.device, *args) -> None:
    """Launch entry point ``fdt_<name>`` with ``args`` on ``device`` (a CUDA
    tensor's device) and raise on a failed launch.

    The entry points launch on the calling thread's current CUDA device, so
    ``device`` is made current for the call when it is not already (the
    one check costs ~0.1 us; a wrapper's host time shows in one-call
    times).  The last argument passed is the device's current stream, as
    the raw pointer PyTorch's own generated kernels launch with
    (``torch.cuda.current_stream`` builds a Python object first, about as
    much host time as the rest of a wrapper).  Every kernel wrapper of the
    port launches through here; each launch adds one to the counter
    ``launch.<name>`` (``utils/profiling.counts``)."""
    fn = getattr(library(), f"fdt_{name}")
    index = device.index
    current = torch._C._cuda_getDevice()
    if current == index:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        torch._C._cuda_setDevice(index)
        try:
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        finally:
            torch._C._cuda_setDevice(current)
    check(err, name)
    count("launch." + name)


def i32(x):
    """``x`` as a contiguous int32 tensor; ``x`` itself when it is one (no
    dispatch: a launch's host time shows in its measured time)."""
    if x.dtype == torch.int32 and x.is_contiguous():
        return x
    return x.to(torch.int32).contiguous()


def i64(x):
    """``x`` flat, contiguous and int64; ``x`` itself when it is one."""
    x = x.reshape(-1)
    if x.dtype == torch.int64 and x.is_contiguous():
        return x
    return x.to(torch.int64).contiguous()


def require_cuda(*tensors) -> None:
    """Raise unless all tensors lie on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"tensor on {x.device}, expected {dev}")
